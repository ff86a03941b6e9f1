"""Serving steps of the LM stack (training waits: ROADMAP A.7)."""
from .steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
