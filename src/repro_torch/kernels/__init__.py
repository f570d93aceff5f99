"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version: the fused Inverse-Helmholtz operator (``helmholtz``) and the
generic GEMM-chain kernel (``gemm``).  Sources live in ``../csrc`` and
are built on first use (``_cuda``)."""
from . import gemm, helmholtz

__all__ = ["gemm", "helmholtz"]
