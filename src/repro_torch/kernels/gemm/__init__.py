"""GEMM-chain kernel class: shared-matrix mode contractions plus
elementwise ops, fused into one kernel whose CTAs keep a tile of elements
in shared memory while the chain runs.  See ``gemm`` (kernel wrapper,
plain version, recipe), ``ops`` (block sizing and the emit adapter) and
``cdse_cdac`` (CHARM-style large/small block candidates)."""
from . import cdse_cdac, gemm, ops
from .cdse_cdac import (LARGE_CLASS_FRACTION, TileCandidate,
                        card_tile_candidates, tile_candidates)
from .gemm import (EWISE_OPS, GemmRecipe, apply_recipe, gemm_chain,
                   gemm_chain_plain)
from .ops import (block_elements_for_vmem, block_working_set_bytes,
                  make_pallas_impl)

__all__ = [
    "gemm", "ops", "EWISE_OPS", "GemmRecipe",
    "apply_recipe", "gemm_chain", "gemm_chain_plain",
    "block_elements_for_vmem", "block_working_set_bytes",
    "make_pallas_impl", "cdse_cdac", "LARGE_CLASS_FRACTION",
    "TileCandidate", "card_tile_candidates", "tile_candidates",
]
