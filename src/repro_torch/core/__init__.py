"""The Datalog front-end (ir, parser, magic — copied from ``repro.core``)
and the semiring fixpoint engines over torch tensors (dense and CSR)."""
