"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version: the fused Inverse-Helmholtz operator (``helmholtz``), the
generic GEMM-chain kernel (``gemm``) and GQA flash attention
(``attention``).  Sources live in ``../csrc`` and
are built on first use (``_cuda``)."""
from . import attention, gemm, helmholtz

__all__ = ["attention", "gemm", "helmholtz"]
