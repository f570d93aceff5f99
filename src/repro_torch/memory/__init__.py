"""Automatic memory-architecture planning (the paper's core contribution).

Turns a compiled tensor program + schedule into an explicit
:class:`~repro_torch.memory.plan.MemoryPlan`: which pseudo-channel each
stream lives in, how big a batch (E) is, how deep the prefetch pipeline
runs, and what it is predicted to cost.

  channels  -- per-target memory datasheets, the H100 among them, and
               device detection
  layout    -- stream->buffer assignment, packing, auto batch sizing,
               on-chip block sizing (the kernels' block_elements)
  pipeline  -- pinned-memory staging on a side CUDA stream and the
               K-deep, stage-skewed dispatch rings
  chain     -- multi-operator ProgramChain planning (inter-stage streams
               stay resident on the device; one co-sized E)
  fusion    -- cost-driven stage fusion: the stage count as a DSE axis
  placement -- stage CU groups over an explicit device topology
  dse       -- the analytic cost model, the single-operator plan, the
               single-operator and chain design-space sweeps and the
               measured cost correction
  plan      -- the MemoryPlan dataclasses and the Fig.-14-style report
"""
from . import chain, channels, dse, fusion, layout, pipeline, placement, plan
from .chain import (ChainPlan, ChainStage, PipelineSpec, ProgramChain,
                    derive_pipeline, fit_contention, plan_chain)
from .fusion import FusionSpec, fuse_chain, fuse_chain_auto
from .channels import (ALVEO_U280, CPU_HOST, H100_SXM, TPU_V5E,
                       MemoryTarget, UnknownTargetError, detect_target,
                       resolve_device, resolve_devices, resolve_target)
from .placement import (DeviceTopology, PlacementError, PlacementPlan,
                        StagePlacement, place_chain)
from .dse import (Candidate, ChainCandidate, ChainDesignSpace,
                  CostCorrection, DesignSpace, explore, explore_chain,
                  fit_correction, format_chain_ranking, make_plan,
                  measure_chain_plan, pareto_front, predict_cost)
from .plan import BufferSpec, CostBreakdown, MemoryPlan

__all__ = [
    "chain", "channels", "dse", "fusion", "layout", "pipeline",
    "placement", "plan",
    "MemoryTarget", "ALVEO_U280", "TPU_V5E", "CPU_HOST", "H100_SXM",
    "detect_target", "resolve_device", "resolve_devices",
    "UnknownTargetError",
    "resolve_target",
    "DeviceTopology", "PlacementError", "PlacementPlan", "StagePlacement",
    "place_chain",
    "PipelineSpec", "derive_pipeline",
    "make_plan", "predict_cost", "explore", "pareto_front",
    "DesignSpace", "Candidate", "CostCorrection",
    "ChainCandidate", "ChainDesignSpace", "explore_chain",
    "fit_correction", "format_chain_ranking", "measure_chain_plan",
    "ProgramChain", "ChainStage", "ChainPlan", "plan_chain",
    "fit_contention",
    "FusionSpec", "fuse_chain", "fuse_chain_auto",
    "BufferSpec", "CostBreakdown", "MemoryPlan",
]
