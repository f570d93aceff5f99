"""repro_torch.flow -- the end-to-end tool flow (the paper's Fig. 5
pipeline) on PyTorch and CUDA.

One call compiles *any* CFDlang program into a planned, executable
memory architecture, with no hand-written per-operator code::

    from repro_torch import flow
    system = flow.compile(open("prog.cfd").read(), target="h100-sxm")
    print(system.report())      # the generated-architecture description
    result = system.run(max_batches=4)       # on the CUDA card

  build     -- compile(): parse -> rewrite -> schedule -> stage
               extraction -> chain -> plan (optionally fused and swept)
  patterns  -- structural dispatch of matched stages to the CUDA kernels
  cli       -- ``python -m repro_torch.flow prog.cfd [--fuse auto] [--dse]
               [--run] [--device cpu]``
"""
from . import build, patterns
from .build import CompiledSystem, FlowError, StreamInfo, compile, resolve_target

__all__ = [
    "build", "patterns",
    "compile", "CompiledSystem", "FlowError", "StreamInfo",
    "resolve_target",
]
