from .costmodel import CostModel
from .simulator import ClusterSim, StageTimes

__all__ = ["CostModel", "ClusterSim", "StageTimes"]
