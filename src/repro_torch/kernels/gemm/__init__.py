"""GEMM-chain kernel class: shared-matrix mode contractions plus
elementwise ops, fused into one kernel whose CTAs keep a tile of elements
in shared memory while the chain runs.  See ``gemm`` (kernel wrapper, plain version, recipe) and ``ops``
(block sizing and the emit adapter).  The CHARM-style block candidates
(``cdse_cdac``) are not ported yet."""
from . import gemm, ops
from .gemm import (DEFAULT_BLOCK_ELEMENTS, EWISE_OPS, GemmRecipe,
                   apply_recipe, gemm_chain, gemm_chain_plain)
from .ops import (block_elements_for_vmem, block_working_set_bytes,
                  make_pallas_impl)

__all__ = [
    "gemm", "ops", "DEFAULT_BLOCK_ELEMENTS", "EWISE_OPS", "GemmRecipe",
    "apply_recipe", "gemm_chain", "gemm_chain_plain",
    "block_elements_for_vmem", "block_working_set_bytes",
    "make_pallas_impl",
]
