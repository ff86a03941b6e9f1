"""Observability pieces of the port: the roofline cost models
(``roofline_attr``) the autotuner scores with."""
