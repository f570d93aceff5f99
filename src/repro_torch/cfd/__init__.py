"""CFD application substrate: the paper's composed pipeline
(interpolation -> gradient -> inverse Helmholtz), the numpy oracles,
and the element-batched chain driver on the CUDA card."""
from . import operators, reference, simulation

__all__ = ["operators", "reference", "simulation"]
