"""Backend: IR -> executable PyTorch (the C99-emission analogue).

Where the paper emits HLS-ready C99 + pragmas and lets Vitis build the
CU, this module emits PyTorch callables.  The backend strings are the
reference package's, so plans and reports compare byte for byte:

  * ``xla``     -- the whole program as one plain PyTorch function: every
    einsum runs through ``torch.einsum`` with an explicit leading batch
    letter on its element-dependent operands (the reference vmaps a
    per-element function instead).
  * ``staged``  -- one plain callable *per scheduled group*, executed in
    sequence with materialized intermediates: the FIFO-streamed
    dataflow CU the per-stage analyses inspect.
  * ``pallas``  -- the batched program is a hand-written CUDA kernel
    (``repro_torch.kernels``), handed in as ``pallas_impl`` by the
    flow's pattern dispatch.  On a CPU tensor the kernel's wrapper runs
    its plain PyTorch version.

Under a fixed-point policy inputs stay in their encoded integer form,
binary einsums go to ``policy.contract`` and element-wise ops to its
``fadd``/``fsub``/``fmul``/``fdiv``, so results equal the reference's
bit for bit.  float32 never runs as TF32: compiling a program turns
TF32 off for cuBLAS and cuDNN.  The reference's ``jit`` and
``donate_args`` have no PyTorch meaning and are left out.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from . import ir
from .precision import FixedPointPolicy, FloatPolicy
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


def _eval_einsum_float(node: ir.Einsum, args, batched, policy: FloatPolicy):
    spec = _batched_spec(node, batched)
    acc = policy.torch_accum_dtype
    out = torch.einsum(spec, *[a.to(acc) for a in args])
    return out.to(policy.torch_dtype)


def _einsum_unary(spec: str, x: torch.Tensor) -> torch.Tensor:
    """A one-operand einsum (transpose, diagonal, reduce) spelled with
    ``diagonal``/``sum``/``permute``, so integers never reach an einsum
    kernel.  Integer sums wrap in the input's width, as XLA's do."""
    ins, out = spec.split("->")
    letters = list(ins)
    while len(set(letters)) < len(letters):
        c = next(c for c in letters if letters.count(c) > 1)
        i = letters.index(c)
        j = letters.index(c, i + 1)
        x = torch.diagonal(x, dim1=i, dim2=j)  # the diagonal goes last
        letters = [l for k, l in enumerate(letters) if k not in (i, j)] + [c]
    summed = [k for k, c in enumerate(letters) if c not in out]
    if summed:
        x = x.sum(dim=summed).to(x.dtype)
        letters = [c for c in letters if c in out]
    return x.permute([letters.index(c) for c in out])


def _eval_einsum_fixed(node: ir.Einsum, args, batched, policy: FixedPointPolicy):
    spec = _batched_spec(node, batched)
    if len(args) == 1:
        return _einsum_unary(spec, args[0])
    if len(args) == 2:
        return policy.contract(args[0], args[1], spec)
    # n-ary: the rewriter normally factorizes these away
    raise ir.IRError(
        "fixed-point backend requires factorized (binary) einsums; "
        "run rewrite.optimize first"
    )


def _eval_ewise(node: ir.Ewise, args, policy):
    if isinstance(policy, FixedPointPolicy):
        if node.op == "add":
            return policy.fadd(*args)
        if node.op == "sub":
            return policy.fsub(*args)
        if node.op == "mul":
            return policy.fmul(*args)
        if node.op == "div":
            return policy.fdiv(*args)
        raise ir.IRError(f"fixed-point ewise {node.op} unsupported")
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


def last_readers(steps: Sequence[Sequence[int]]) -> Dict[int, int]:
    """For each uid that ``steps`` read (step ``i`` reads the uids in
    ``steps[i]``), the index of the last step that reads it."""
    last: Dict[int, int] = {}
    for i, uids in enumerate(steps):
        for u in uids:
            last[u] = i
    return last


def _eval_nodes(nodes, vals: Dict[int, torch.Tensor], batched: Set[int],
                policy, keep: Set[int]) -> None:
    """Evaluate ``nodes`` in order into ``vals``; a node is batched (has
    the leading element axis) when any operand is, and then joins
    ``batched``.  A value not in ``keep`` leaves ``vals`` right after its
    last reader among ``nodes``, so its memory is freed while the rest
    of the program runs (the reference's XLA frees dead values the same
    way)."""
    fixed = isinstance(policy, FixedPointPolicy)
    todo = [n for n in nodes if n.uid not in vals]
    last = last_readers([[o.uid for o in n.operands()] for n in todo])
    for i, node in enumerate(todo):
        ops = node.operands()
        args = [vals[o.uid] for o in ops]
        flags = [o.uid in batched for o in ops]
        if isinstance(node, ir.Einsum):
            if fixed:
                out = _eval_einsum_fixed(node, args, flags, policy)
            else:
                out = _eval_einsum_float(node, args, flags, policy)
        elif isinstance(node, ir.Ewise):
            # the batch axis leads, so broadcasting lines up the rest
            out = _eval_ewise(node, args, policy)
        else:
            raise ir.IRError(f"cannot evaluate {node!r}")
        del args
        vals[node.uid] = out
        if any(flags):
            batched.add(node.uid)
        for o in ops:
            if last[o.uid] == i and o.uid not in keep:
                vals.pop(o.uid, None)


def _load_inputs(prog: ir.Program, env, policy, element_axis: bool, device):
    """Input tensors by uid (a float policy casts them to its dtype; a
    fixed-point one leaves the encoded integers as given), on ``device``
    when one is set; the uids carrying an element axis; its length."""
    elem = set(prog.element_vars) if element_axis else set()
    vals: Dict[int, torch.Tensor] = {}
    batched: Set[int] = set()
    n_batch = None
    for name, inp in prog.inputs.items():
        if name not in env:
            raise KeyError(f"missing input {name!r}")
        x = torch.as_tensor(env[name], device=device)
        if isinstance(policy, FloatPolicy):
            x = x.to(policy.torch_dtype)
        elif x.dtype != policy.storage_dtype:
            raise TypeError(
                f"input {name!r} is {x.dtype}; policy {policy.name} takes "
                f"{policy.storage_dtype} (encode it with policy.encode)"
            )
        vals[inp.uid] = x
        if name in elem:
            batched.add(inp.uid)
            n_batch = x.shape[0]
    return vals, batched, n_batch


def _outputs(prog: ir.Program, vals, batched, n_batch):
    """The named outputs; with an element axis, values that do not depend
    on an element input are broadcast to it, as vmap does."""
    out = {}
    for name, n in prog.outputs.items():
        v = vals[n.uid]
        if n_batch is not None and n.uid not in batched:
            v = v.expand((n_batch,) + tuple(v.shape))
        out[name] = v
    return out


def _run(prog: ir.Program, env: Dict[str, torch.Tensor], policy,
         element_axis: bool, device=None) -> Dict[str, torch.Tensor]:
    """Evaluate ``prog``; with ``element_axis`` the element-marked inputs
    carry a leading batch axis and so does every output."""
    vals, batched, n_batch = _load_inputs(prog, env, policy, element_axis,
                                          device)
    _eval_nodes(prog.toposort(), vals, batched, policy,
                {v.uid for v in prog.outputs.values()})
    return _outputs(prog, vals, batched, n_batch)


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
    ``stage_fns``   -- per-group callables (staged backend only).
    """

    program: ir.Program
    policy: object
    element_fn: Callable[..., Dict[str, torch.Tensor]]
    batched_fn: Callable[..., Dict[str, torch.Tensor]]
    schedule: Optional[Schedule] = None
    stage_fns: Optional[List[Callable]] = None
    backend: str = "xla"

    def __call__(self, **env):
        return self.batched_fn(env)


def _staged_callables(
    prog: ir.Program, sched: Schedule, policy, device
) -> Tuple[List[Callable], Callable, Callable]:
    """One callable per schedule group, list in and list out; the
    element and batched drivers thread the live values between them.

    ``stage(args, element_axis=False)``: with ``element_axis`` the
    element-dependent streams among ``args`` carry the leading element
    axis, and so do such outputs."""
    dep = prog.element_dependent_uids()
    stage_fns: List[Callable] = []
    stage_sigs: List[Tuple[List[int], List[int]]] = []
    for group in sched.groups:
        in_uids = [n.uid for n in group.in_streams]
        out_uids = [n.uid for n in group.out_streams]

        def stage(args, element_axis: bool = False, *,
                  _nodes=tuple(group.nodes), _in=tuple(in_uids),
                  _out=tuple(out_uids)):
            vals: Dict[int, torch.Tensor] = dict(zip(_in, args))
            batched = {u for u in _in if u in dep} if element_axis else set()
            _eval_nodes(_nodes, vals, batched, policy, set(_out))
            return [vals[u] for u in _out]

        stage_fns.append(stage)
        stage_sigs.append((in_uids, out_uids))

    keep = {v.uid for v in prog.outputs.values()}
    last = last_readers([ins for ins, _ in stage_sigs])

    def drive(env, element_axis: bool):
        live, batched, n_batch = _load_inputs(prog, env, policy,
                                              element_axis, device)
        for i, (fn, (in_uids, out_uids)) in enumerate(
                zip(stage_fns, stage_sigs)):
            outs = fn([live[u] for u in in_uids], element_axis)
            live.update(zip(out_uids, outs))
            del outs
            # a stream leaves once its last group has read it
            for u in in_uids:
                if last[u] == i and u not in keep:
                    live.pop(u, None)
        if element_axis:
            batched = {u for u in live if u in dep}
        return _outputs(prog, live, batched, n_batch)

    return (stage_fns, lambda env: drive(env, False),
            lambda env: drive(env, True))


def compile_program(
    prog: ir.Program,
    *,
    policy=FloatPolicy("float32"),
    backend: str = "xla",
    vmem_budget: Optional[int] = None,
    max_groups: Optional[int] = None,
    pallas_impl: Optional[Callable] = None,
    device=None,
) -> CompiledProgram:
    """Compile an IR program to an executable (the Olympus entry point).

    ``pallas_impl``: a callable ``(env) -> outputs`` implementing the
    whole batched program as a hand-written kernel; used when
    ``backend='pallas'``.  The port's kernel adapters also take
    ``out=``, the tensors to write the outputs into, which the batched
    fn passes on.  The kernels compute in floating point, so a
    fixed-point policy runs on ``xla`` or ``staged`` only.

    ``device``: where the callables put their inputs before computing
    (``None``: they compute where the inputs lie).
    """
    if backend not in ("xla", "staged", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "pallas" and isinstance(policy, FixedPointPolicy):
        raise ValueError(
            f"backend 'pallas' computes in floating point; policy "
            f"{policy.name} runs on 'xla' or 'staged'"
        )
    pin_float32_precision()
    device = torch.device(device) if device is not None else None
    sched = None
    if backend == "staged" or vmem_budget is not None or max_groups is not None:
        kwargs = {}
        if vmem_budget is not None:
            kwargs["vmem_budget"] = vmem_budget
        if max_groups is not None:
            kwargs["max_groups"] = max_groups
        sched = make_schedule(prog, bytes_per_scalar=policy.bits // 8, **kwargs)

    if backend == "staged":
        stage_fns, element, batched = _staged_callables(prog, sched, policy,
                                                        device)
        return CompiledProgram(
            program=prog, policy=policy, element_fn=element,
            batched_fn=batched, schedule=sched, stage_fns=stage_fns,
            backend=backend,
        )

    def element(env):
        return _run(prog, env, policy, element_axis=False, device=device)

    if backend == "pallas":
        if pallas_impl is None:
            raise ValueError("backend='pallas' requires pallas_impl")
        if device is None:
            batched = pallas_impl
        else:
            def batched(env, **kw):
                return pallas_impl({k: torch.as_tensor(v, device=device)
                                    for k, v in env.items()}, **kw)
    else:
        def batched(env):
            return _run(prog, env, policy, element_axis=True, device=device)

    return CompiledProgram(
        program=prog, policy=policy, element_fn=element,
        batched_fn=batched, schedule=sched, backend=backend,
    )
