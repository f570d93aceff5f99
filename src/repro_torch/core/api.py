"""Public API of the tensor-expression compiler (DSL-to-executable flow).

The one-call path from CFDlang source to a batched, optimized executable::

    from repro_torch.core import api
    compiled = api.compile_cfdlang(src, element_vars=("u", "D", "v"))
    out = compiled(S=S, D=D, u=u)        # D, u carry a leading element axis

mirroring the paper's Figure 5 (DSL-to-C generation + C-to-system
generation), with the compiler passes selectable the same way Olympus
exposes its optimizations.  The compiled callables put their inputs on
the CUDA card unless ``device="cpu"`` is given (and raise when there is
no card).  The reference's ``jit`` and ``donate_args`` have no PyTorch
meaning and are left out.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from . import dsl, emit, ir, rewrite
from .precision import F32, get_policy


def compile_ir(
    prog: ir.Program,
    *,
    policy=F32,
    optimize: bool = True,
    backend: str = "xla",
    vmem_budget: Optional[int] = None,
    max_groups: Optional[int] = None,
    pallas_impl: Optional[Callable] = None,
    device=None,
) -> emit.CompiledProgram:
    """Optimize, schedule and compile an IR program; ``policy`` is a
    policy or its name."""
    from ..memory.channels import resolve_device  # lazy: memory imports core

    if isinstance(policy, str):
        policy = get_policy(policy)
    if optimize:
        prog = rewrite.optimize(prog)
    return emit.compile_program(
        prog,
        policy=policy,
        backend=backend,
        vmem_budget=vmem_budget,
        max_groups=max_groups,
        pallas_impl=pallas_impl,
        device=resolve_device(device),
    )


def compile_cfdlang(
    src: str,
    *,
    element_vars: Sequence[str] = (),
    policy=F32,
    optimize: bool = True,
    backend: str = "xla",
    vmem_budget: Optional[int] = None,
    max_groups: Optional[int] = None,
    pallas_impl: Optional[Callable] = None,
    device=None,
) -> emit.CompiledProgram:
    """Parse, optimize, schedule, and compile a CFDlang program."""
    return compile_ir(
        dsl.parse(src, element_vars=element_vars),
        policy=policy,
        optimize=optimize,
        backend=backend,
        vmem_budget=vmem_budget,
        max_groups=max_groups,
        pallas_impl=pallas_impl,
        device=device,
    )
