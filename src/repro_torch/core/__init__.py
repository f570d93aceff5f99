"""The paper's primary contribution as a composable PyTorch module:

DSL front-end (`dsl`), value-based tensor IR (`ir`), middle-end rewrites
(`rewrite`: contraction factorization / CSE), dataflow-group scheduling
(`schedule`), buffer-liveness sharing (`liveness`), scalar precision
policies (`precision`), and the PyTorch backend (`emit`).
"""
from . import dsl, emit, ir, liveness, precision, rewrite, schedule

__all__ = [
    "dsl", "emit", "ir", "liveness", "precision", "rewrite", "schedule",
]
