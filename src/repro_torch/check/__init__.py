"""Typed errors shared with the plan layer (``repro_torch.core.repair``)."""
from .errors import CheckError, PlanError

__all__ = ["CheckError", "PlanError"]
