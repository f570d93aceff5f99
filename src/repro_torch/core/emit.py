"""Backend: IR -> executable PyTorch (the C99-emission analogue).

Where the paper emits HLS-ready C99 + pragmas and lets Vitis build the
CU, this module emits PyTorch callables.  The backend strings are the
reference package's, so plans and reports compare byte for byte:

  * ``xla``     -- the whole program as one plain PyTorch function: every
    einsum runs through ``torch.einsum`` with an explicit leading batch
    letter on its element-dependent operands (the reference vmaps a
    per-element function instead).
  * ``pallas``  -- the batched program is a hand-written CUDA kernel
    (``repro_torch.kernels``), handed in as ``pallas_impl`` by the
    flow's pattern dispatch.  On a CPU tensor the kernel's wrapper runs
    its plain PyTorch version.

The ``staged`` backend (one callable per scheduled group) is not ported
yet.  float32 never runs as TF32: compiling a program turns TF32 off
for cuBLAS and cuDNN.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import ir
from .precision import FloatPolicy
from .schedule import Schedule, schedule as make_schedule

_LETTERS = string.ascii_letters


def einsum_spec(node: ir.Einsum) -> str:
    """Render integer index ids as an einsum subscript string."""
    ids: List[int] = []
    for subs in node.in_subs:
        for i in subs:
            if i not in ids:
                ids.append(i)
    if len(ids) > len(_LETTERS):
        raise ir.IRError("einsum with > 52 distinct indices")
    letter = {i: _LETTERS[k] for k, i in enumerate(ids)}
    ins = ",".join("".join(letter[i] for i in subs) for subs in node.in_subs)
    out = "".join(letter[i] for i in node.out_subs)
    return f"{ins}->{out}"


def _batched_spec(node: ir.Einsum, batched: Sequence[bool]) -> str:
    """``einsum_spec`` with a fresh leading batch letter on every batched
    operand and on the result (the explicit form of a vmap over axis 0)."""
    spec = einsum_spec(node)
    if not any(batched):
        return spec
    used = set(spec)
    free = [c for c in _LETTERS if c not in used]
    if not free:
        raise ir.IRError("einsum with 52 distinct indices leaves no batch letter")
    b = free[0]
    ins, out = spec.split("->")
    ins = ",".join(
        (b + s) if flag else s for s, flag in zip(ins.split(","), batched)
    )
    return f"{ins}->{b}{out}"


def pin_float32_precision() -> None:
    """Keep float32 products and convolutions out of TF32 (it keeps only
    about three decimal digits, which would break f32 parity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# node evaluation
# ---------------------------------------------------------------------------


def _eval_einsum(node: ir.Einsum, args, batched, policy: FloatPolicy):
    spec = _batched_spec(node, batched)
    acc = policy.torch_accum_dtype
    out = torch.einsum(spec, *[a.to(acc) for a in args])
    return out.to(policy.torch_dtype)


def _eval_ewise(node: ir.Ewise, args):
    a = args[0]
    if node.op == "add":
        return a + args[1]
    if node.op == "sub":
        return a - args[1]
    if node.op == "mul":
        return a * args[1]
    if node.op == "div":
        return a / args[1]
    if node.op == "neg":
        return -a
    if node.op == "scale":
        return a * node.const
    raise ir.IRError(f"unknown ewise op {node.op}")


def _run(prog: ir.Program, env: Dict[str, torch.Tensor], policy,
         element_axis: bool) -> Dict[str, torch.Tensor]:
    """Evaluate ``prog``; with ``element_axis`` the element-marked inputs
    carry a leading batch axis and so does every output (values that do
    not depend on an element input are broadcast to it, as vmap does)."""
    if not isinstance(policy, FloatPolicy):
        raise NotImplementedError(f"policy {policy!r} is not ported yet")
    elem = set(prog.element_vars) if element_axis else set()
    vals: Dict[int, torch.Tensor] = {}
    batched = set()
    n_batch = None
    for name, inp in prog.inputs.items():
        if name not in env:
            raise KeyError(f"missing input {name!r}")
        x = torch.as_tensor(env[name]).to(policy.torch_dtype)
        vals[inp.uid] = x
        if name in elem:
            batched.add(inp.uid)
            n_batch = x.shape[0]

    for node in prog.toposort():
        if node.uid in vals:
            continue
        ops = node.operands()
        args = [vals[o.uid] for o in ops]
        flags = [o.uid in batched for o in ops]
        if isinstance(node, ir.Einsum):
            vals[node.uid] = _eval_einsum(node, args, flags, policy)
        elif isinstance(node, ir.Ewise):
            # the batch axis leads, so broadcasting lines up the rest
            vals[node.uid] = _eval_ewise(node, args)
        else:
            raise ir.IRError(f"cannot evaluate {node!r}")
        if any(flags):
            batched.add(node.uid)

    out = {}
    for name, n in prog.outputs.items():
        v = vals[n.uid]
        if element_axis and n.uid not in batched and n_batch is not None:
            v = v.expand((n_batch,) + tuple(v.shape))
        out[name] = v
    return out


def evaluate(
    prog: ir.Program,
    env: Dict[str, torch.Tensor],
    policy=FloatPolicy("float32"),
) -> Dict[str, torch.Tensor]:
    """Evaluate the program for ONE element, given named input tensors."""
    return _run(prog, env, policy, element_axis=False)


# ---------------------------------------------------------------------------
# compiled artifacts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledProgram:
    """A compiled tensor-expression program.

    ``element_fn``  -- single-element callable (dict -> dict).
    ``batched_fn``  -- over the leading element axis of element vars.
    """

    program: ir.Program
    policy: object
    element_fn: Callable[..., Dict[str, torch.Tensor]]
    batched_fn: Callable[..., Dict[str, torch.Tensor]]
    schedule: Optional[Schedule] = None
    backend: str = "xla"

    def __call__(self, **env):
        return self.batched_fn(env)


def compile_program(
    prog: ir.Program,
    *,
    policy=FloatPolicy("float32"),
    backend: str = "xla",
    vmem_budget: Optional[int] = None,
    max_groups: Optional[int] = None,
    pallas_impl: Optional[Callable] = None,
) -> CompiledProgram:
    """Compile an IR program to an executable (the Olympus entry point).

    ``pallas_impl``: a callable ``(env) -> outputs`` implementing the
    whole batched program as a hand-written kernel; used when
    ``backend='pallas'``.
    """
    if backend not in ("xla", "pallas"):
        if backend == "staged":
            raise NotImplementedError("backend 'staged' is not ported yet")
        raise ValueError(f"unknown backend {backend!r}")
    pin_float32_precision()
    sched = None
    if vmem_budget is not None or max_groups is not None:
        kwargs = {}
        if vmem_budget is not None:
            kwargs["vmem_budget"] = vmem_budget
        if max_groups is not None:
            kwargs["max_groups"] = max_groups
        sched = make_schedule(prog, bytes_per_scalar=policy.bits // 8, **kwargs)

    def element(env):
        return _run(prog, env, policy, element_axis=False)

    if backend == "pallas":
        if pallas_impl is None:
            raise ValueError("backend='pallas' requires pallas_impl")
        batched = pallas_impl
    else:
        def batched(env):
            return _run(prog, env, policy, element_axis=True)

    return CompiledProgram(
        program=prog, policy=policy, element_fn=element,
        batched_fn=batched, schedule=sched, backend=backend,
    )
