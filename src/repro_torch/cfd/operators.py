"""The paper's three CFD operators, built through the DSL-to-executable
flow (core.api), with selectable backend/precision -- the per-kernel
equivalent of the Olympus "Optimize" step -- and the composed
application.

:func:`build_inverse_helmholtz` (the Fig. 2 operator),
:func:`build_interpolation` and :func:`build_gradient` compile one
operator each; their callables run on the CUDA card unless
``device="cpu"`` is given.  :data:`CFD_PIPELINE_SRC` is the whole
pipeline -- interpolation -> gradient -> inverse Helmholtz -- as one
CFDlang program, and :func:`compile_cfd_pipeline` compiles it through
``repro_torch.flow`` at the paper's operator-granularity cuts: the
generic tool flow derives the stage programs, the inter-stage residency,
and (for ``pallas`` stages) the dispatch to the hand-written CUDA
kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from .. import flow
from ..core import api, dsl
from ..core.emit import CompiledProgram
from ..kernels.helmholtz import ops as helmholtz_ops
from ..memory.chain import ChainPlan, ProgramChain
from ..memory.layout import kernel_tiles
from ..memory.plan import MemoryPlan


def pallas_block_elements(
    p: int,
    plan: Optional[MemoryPlan] = None,
    *,
    vmem_bytes: Optional[int] = None,
    bytes_per_scalar: int = 4,
) -> Optional[int]:
    """Resolve the Helmholtz kernel's block size from a MemoryPlan.

    The plan already carries the block (on the H100 the kernel's tile,
    elsewhere the on-chip-budgeted divisor of its E); without one, the
    block is derived directly from the given on-chip capacity, and with
    neither it is None: the kernel's own default tile.
    """
    if plan is not None and plan.block_elements:
        return plan.block_elements
    if vmem_bytes is not None:
        return helmholtz_ops.block_elements_for_vmem(
            p, vmem_bytes, bytes_per_scalar=bytes_per_scalar
        )
    return None


def build_inverse_helmholtz(
    p: int = 11,
    *,
    policy="float32",
    backend: str = "xla",
    optimize: bool = True,
    max_groups: Optional[int] = None,
    block_elements: Optional[int] = None,
    plan: Optional[MemoryPlan] = None,
    device=None,
) -> CompiledProgram:
    """Compile the Inverse Helmholtz operator (paper Fig. 2).

    backend:
      * ``xla``    -- factorized einsum chain, one plain PyTorch function.
      * ``staged`` -- one callable per scheduled group (dataflow view).
      * ``pallas`` -- the fused CUDA kernel (``csrc/helmholtz.cu``; its
        plain PyTorch version on CPU tensors).  Its ``block_elements``
        (the kernel's tile) defaults to the plan's block when the plan
        is for a card the kernels run on; on the reference's targets
        that block is a VMEM block, which stays in the plan while the
        kernel launches at its default tile.  An explicit
        ``block_elements`` still wins.
    """
    pallas_impl = None
    if backend == "pallas":
        be = block_elements
        if be is None and plan is not None and kernel_tiles(plan.target):
            be = pallas_block_elements(p, plan)
        pallas_impl = helmholtz_ops.make_pallas_impl(block_elements=be)
    return api.compile_cfdlang(
        dsl.INVERSE_HELMHOLTZ_SRC.format(p=p),
        element_vars=("u", "D", "v"),
        policy=policy,
        optimize=optimize,
        backend=backend,
        max_groups=max_groups,
        pallas_impl=pallas_impl,
        device=device,
    )


def build_interpolation(
    n: int = 11,
    m: int = 11,
    *,
    policy="float32",
    backend: str = "xla",
    optimize: bool = True,
    max_groups: Optional[int] = None,
    device=None,
) -> CompiledProgram:
    """Compile the interpolation operator ``v = (A (x) A (x) A) u``."""
    return api.compile_cfdlang(
        dsl.INTERPOLATION_SRC.format(n=n, m=m),
        element_vars=("u", "v"),
        policy=policy,
        optimize=optimize,
        backend=backend,
        max_groups=max_groups,
        device=device,
    )


def build_gradient(
    nx: int = 8,
    ny: int = 7,
    nz: int = 6,
    *,
    policy="float32",
    backend: str = "xla",
    optimize: bool = True,
    max_groups: Optional[int] = None,
    device=None,
) -> CompiledProgram:
    """Compile the gradient operator (``gx``, ``gy``, ``gz``)."""
    return api.compile_cfdlang(
        dsl.GRADIENT_SRC.format(nx=nx, ny=ny, nz=nz),
        element_vars=("u", "gx", "gy", "gz"),
        policy=policy,
        optimize=optimize,
        backend=backend,
        max_groups=max_groups,
        device=device,
    )


def chain_stage_block_elements(
    chain_plan: Optional[ChainPlan], stage: str
) -> Optional[int]:
    """The VMEM-budgeted block a ChainPlan assigned to one stage (None
    when no plan, or the plan does not know the stage)."""
    if chain_plan is None:
        return None
    for sp in chain_plan.stages:
        if sp.name == stage and sp.block_elements:
            return sp.block_elements
    return None


#: The paper's full application as ONE CFDlang program: interpolation
#: (A), gradient (Dx/Dy/Dz), and inverse Helmholtz (S, D) over a shared
#: element stream.  ``repro_torch.flow`` cuts it into the three pipeline
#: stages at the declared temporaries -- no builder code per operator.
CFD_PIPELINE_SRC = """
var input  A  : [{p} {p}]
var input  Dx : [{p} {p}]
var input  Dy : [{p} {p}]
var input  Dz : [{p} {p}]
var input  S  : [{p} {p}]
var input elem u  : [{p} {p} {p}]
var input elem D  : [{p} {p} {p}]
var output elem gy : [{p} {p} {p}]
var output elem gz : [{p} {p} {p}]
var output elem v  : [{p} {p} {p}]
var w  : [{p} {p} {p}]
var gx : [{p} {p} {p}]
var t  : [{p} {p} {p}]
var r  : [{p} {p} {p}]
w = A # A # A # u . [[1 6][3 7][5 8]]
gx = Dx # w . [[1 2]]
gy = Dy # w . [[1 3]]
gz = Dz # w . [[1 4]]
t = S # S # S # gx . [[1 6][3 7][5 8]]
r = D * t
v = S # S # S # r . [[0 6][2 7][4 8]]
"""

#: The canonical stage cuts: interpolation owns ``w``, the gradient its
#: three derivatives, the Helmholtz stage the final solve.
CFD_PIPELINE_STAGES = (
    ("interp", ("w",)),
    ("grad", ("gx", "gy", "gz")),
    ("helmholtz", ("v",)),
)


def compile_cfd_pipeline(
    p: int = 11,
    *,
    policy="float32",
    backends: Union[str, Tuple[str, str, str]] = "xla",
    stage_blocks=None,
    **flow_kwargs,
) -> "flow.CompiledSystem":
    """Compile the whole CFD application through ``repro_torch.flow`` at
    the paper's operator-granularity stage cuts.  ``flow_kwargs`` pass
    to ``flow.compile`` (``device="cpu"`` plans for the host; the
    default detects the CUDA card)."""
    if isinstance(backends, str):
        backends = (backends, backends, backends)
    return flow.compile(
        CFD_PIPELINE_SRC.format(p=p),
        name=f"cfd_pipeline_p{p}",
        policy=policy,
        stages=CFD_PIPELINE_STAGES,
        backends=backends,
        stage_blocks=stage_blocks,
        **flow_kwargs,
    )


def build_cfd_chain(
    p: int = 11,
    *,
    policy="float32",
    backends: Union[str, Tuple[str, str, str]] = "xla",
    helmholtz_plan: Optional[MemoryPlan] = None,
    chain_plan: Optional[ChainPlan] = None,
    **flow_kwargs,
) -> ProgramChain:
    """The paper's full application as one ProgramChain:

        interpolation -> gradient -> inverse Helmholtz

    Compiled end-to-end from :data:`CFD_PIPELINE_SRC` by ``repro_torch.flow``:
    the flow extracts the three stage programs, wires interpolation's
    ``w`` into the gradient and the gradient's ``gx`` into the Helmholtz
    solve (both HBM-resident -- no host round-trip), and streams
    ``gy``/``gz``/``v`` back to the host.

    For a kernel Helmholtz stage, pass a ChainPlan back in as
    ``chain_plan`` so the kernel's block size comes from that plan's
    per-stage on-chip budget (plan first against a plan-only chain, then
    rebuild the executable chain with the plan):

        ch = build_cfd_chain(p, device="cpu")         # plan-only (xla)
        plan = chain.plan_chain(ch, backends=("xla", "xla", "pallas"))
        ch = build_cfd_chain(p, backends=("xla", "xla", "pallas"),
                             chain_plan=plan, device="cpu")
        simulation.run_chain(ch, plan, device="cpu")

    ``flow_kwargs`` (``target``, ``device``, ...) pass to
    ``flow.compile``.
    """
    blocks = {}
    blk = chain_stage_block_elements(chain_plan, "helmholtz")
    if blk is None and helmholtz_plan is not None and (
            helmholtz_plan.block_elements):
        blk = helmholtz_plan.block_elements
    if blk:
        blocks["helmholtz"] = blk
    return compile_cfd_pipeline(
        p, policy=policy, backends=backends, stage_blocks=blocks,
        **flow_kwargs,
    ).chain


def flops_per_element(p: int) -> int:
    """Paper Eq. (2)."""
    return (12 * p + 1) * p ** 3
