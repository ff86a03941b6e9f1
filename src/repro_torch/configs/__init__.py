"""Architecture config registry (one module per assigned architecture),
copied from the JAX package so that one ``get_config`` name builds both."""
from .base import (SHAPES, ArchConfig, ShapeSpec, all_arch_names, get_config,
                   shape_skip_reason)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config",
           "all_arch_names", "shape_skip_reason"]
