"""The Datalog core over torch tensors: the front-end (ir, parser, magic
sets), the planner (stratify, PreM checks, planner), the tuple engine
(relation, the tuple half of seminaive, engine) and the semiring fixpoint
engines (dense and CSR).  The JAX package's ``repro.core`` exports, ported."""
from .engine import CapacityError, Engine
from .magic import MagicRewrite, detect_frontier_lowering
from .magic import rewrite as magic_rewrite
from .parser import parse_program, parse_query
from .planner import PlanOptions, plan_program
from .prem import check_prem_numeric, check_prem_structural
from .semiring import BOOL, MAX_PLUS, MIN_PLUS, PLUS_TIMES, Semiring

__all__ = ["Engine", "CapacityError", "parse_program", "parse_query",
           "plan_program", "PlanOptions", "magic_rewrite", "MagicRewrite",
           "detect_frontier_lowering",
           "check_prem_structural", "check_prem_numeric", "Semiring",
           "BOOL", "MIN_PLUS", "MAX_PLUS", "PLUS_TIMES"]
