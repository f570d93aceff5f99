"""CFD application substrate: the paper's three operators (Inverse
Helmholtz, Interpolation, Gradient) and their composed pipeline, the
numpy oracles, and the element-batched drivers on the CUDA card (one
operator, the paper's Fig. 2, and the whole chain)."""
from . import operators, reference, simulation

__all__ = ["operators", "reference", "simulation"]
