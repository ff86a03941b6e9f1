"""The fault-tolerant training driver."""
from .driver import (DriverConfig, SimulatedFailure, TrainDriver,
                     run_with_restarts, use_deterministic_cublas)

__all__ = ["TrainDriver", "DriverConfig", "SimulatedFailure",
           "run_with_restarts", "use_deterministic_cublas"]
