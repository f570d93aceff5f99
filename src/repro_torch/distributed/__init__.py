"""Distribution layer: sharding rules (DP/TP/EP/SP) and their DTensor
placements, DTensor's rules for the ops that need them, pipeline
parallelism, and gradient compression."""
from . import compression, pipeline, rules, sharding

__all__ = ["compression", "pipeline", "rules", "sharding"]
