"""The hardware model the port scores against (``report.HW``, ``H100``)."""
from .report import H100, HW

__all__ = ["H100", "HW"]
