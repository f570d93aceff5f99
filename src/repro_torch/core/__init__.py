"""The paper's primary contribution as a composable PyTorch module:

DSL front-end (`dsl`), value-based tensor IR (`ir`), middle-end rewrites
(`rewrite`: contraction factorization / CSE), dataflow-group scheduling
(`schedule`), buffer-liveness sharing (`liveness`), scalar precision
policies (`precision`), and the PyTorch backend (`emit`, `api`).
"""
from . import api, dsl, emit, ir, liveness, precision, rewrite, schedule

__all__ = [
    "api", "dsl", "emit", "ir", "liveness", "precision", "rewrite",
    "schedule",
]
