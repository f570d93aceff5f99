"""The port's front end and emitter held against the reference.

Parse/rewrite must give the same structural program signature in both
packages for every DSL source; the port's ``xla`` backend (plain
whole-program PyTorch) must match the reference's jitted XLA path; and
no module of ``repro_torch`` may import ``jax`` or ``repro``.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro.core import dsl as r_dsl
from repro.core import emit as r_emit
from repro.core import rewrite as r_rewrite
from repro.core.precision import F32 as R_F32
from repro.core.precision import F64 as R_F64
from repro.core.precision import enable_x64
from repro.flow.patterns import program_signature as r_signature
from repro_torch.cfd import operators as t_operators
from repro_torch.core import dsl as t_dsl
from repro_torch.core import emit as t_emit
from repro_torch.core import rewrite as t_rewrite
from repro_torch.core.precision import BF16, F32, F64, POLICIES, get_policy
from repro_torch.flow.patterns import program_signature as t_signature

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

#: (label, source template attribute, format args, element vars)
DSL_SOURCES = [
    ("helmholtz", "INVERSE_HELMHOLTZ_SRC", {"p": 5}, ("u", "D", "v")),
    ("interpolation", "INTERPOLATION_SRC", {"n": 4, "m": 6}, ("u", "v")),
    ("gradient", "GRADIENT_SRC", {"nx": 3, "ny": 4, "nz": 5},
     ("u", "gx", "gy", "gz")),
]


def _sources():
    out = []
    for label, attr, fmt, ev in DSL_SOURCES:
        t_src = getattr(t_dsl, attr).format(**fmt)
        r_src = getattr(r_dsl, attr).format(**fmt)
        out.append(pytest.param(t_src, r_src, ev, id=label))
    for path in sorted(EXAMPLES.glob("*.cfd")):
        text = path.read_text()
        out.append(pytest.param(text, text, (), id=path.stem))
    src = t_operators.CFD_PIPELINE_SRC.format(p=4)
    out.append(pytest.param(src, src, (), id="cfd_pipeline_p4"))
    return out


@pytest.mark.parametrize("t_src,r_src,element_vars", _sources())
@pytest.mark.parametrize("optimize", [False, True], ids=["parsed", "rewritten"])
def test_program_signature_matches_reference(t_src, r_src, element_vars,
                                             optimize):
    assert t_src == r_src
    t_prog = t_dsl.parse(t_src, element_vars=element_vars)
    r_prog = r_dsl.parse(r_src, element_vars=element_vars)
    if optimize:
        t_prog = t_rewrite.optimize(t_prog)
        r_prog = r_rewrite.optimize(r_prog)
    assert t_signature(t_prog) == r_signature(r_prog)
    assert sorted(t_prog.inputs) == sorted(r_prog.inputs)
    assert sorted(t_prog.outputs) == sorted(r_prog.outputs)
    assert set(t_prog.element_vars) == set(r_prog.element_vars)
    assert t_prog.total_flops() == r_prog.total_flops()


def _env(prog, rng, n_elem):
    elem = set(prog.element_vars)
    return {
        name: rng.uniform(-1, 1, ((n_elem,) if name in elem else ())
                          + tuple(node.shape))
        for name, node in prog.inputs.items()
    }


# float32: both sides sum in their own order (XLA's dot vs torch.einsum),
# so a few float32 ulps of the largest output; float64 agrees to ~1e-12
TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.mark.parametrize("t_src,r_src,element_vars", _sources())
@pytest.mark.parametrize("policy", ["float64", "float32"])
def test_xla_backend_matches_reference(t_src, r_src, element_vars, policy,
                                       rng):
    t_prog = t_rewrite.optimize(t_dsl.parse(t_src, element_vars=element_vars))
    r_prog = r_rewrite.optimize(r_dsl.parse(r_src, element_vars=element_vars))
    env = _env(t_prog, rng, n_elem=3)
    t_pol, r_pol = get_policy(policy), {"float64": R_F64,
                                        "float32": R_F32}[policy]
    np_dtype = np.float64 if policy == "float64" else np.float32
    with enable_x64(policy == "float64"):
        r_fn = r_emit.compile_program(r_prog, policy=r_pol, backend="xla")
        want = {k: np.asarray(v) for k, v in r_fn.batched_fn(
            {k: v.astype(np_dtype) for k, v in env.items()}).items()}
        r_one = {k: np.asarray(v) for k, v in r_fn.element_fn(
            {k: (v[0] if k in r_prog.element_vars else v).astype(np_dtype)
             for k, v in env.items()}).items()}
    t_fn = t_emit.compile_program(t_prog, policy=t_pol, backend="xla")
    got = t_fn.batched_fn({k: torch.from_numpy(v) for k, v in env.items()})
    one = t_fn.element_fn({
        k: torch.from_numpy(v[0] if k in t_prog.element_vars else v)
        for k, v in env.items()
    })
    assert t_fn.backend == "xla"
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == t_pol.torch_dtype
        assert tuple(got[k].shape) == want[k].shape
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL[policy],
                                   atol=TOL[policy] * scale)
        np.testing.assert_allclose(one[k].numpy(), r_one[k], rtol=TOL[policy],
                                   atol=TOL[policy] * scale)


def test_bf16_policy_stores_bf16_and_accumulates_in_f32(rng):
    prog = t_rewrite.optimize(t_dsl.parse(
        t_dsl.INVERSE_HELMHOLTZ_SRC.format(p=5), element_vars=("u", "D", "v")
    ))
    env = {k: torch.from_numpy(v).float() for k, v in _env(prog, rng, 4).items()}
    lo = t_emit.compile_program(prog, policy=BF16).batched_fn(env)["v"]
    hi = t_emit.compile_program(prog, policy=F32).batched_fn(env)["v"]
    assert lo.dtype == torch.bfloat16
    # bf16 storage (8 mantissa bits) of inputs, intermediates and output
    np.testing.assert_allclose(lo.float().numpy(), hi.numpy(), rtol=0.05,
                               atol=0.05 * hi.abs().max().item())


def test_policies_and_fixed_point_not_ported():
    """Every policy of the reference is registered, the paper's
    fixed-point formats among them (they were the last not ported); an
    unknown name still raises."""
    assert set(POLICIES) == {"float64", "float32", "bfloat16",
                             "fixed64_q24.40", "fixed32_q8.24"}
    assert (F64.bits, F32.bits, BF16.bits) == (64, 32, 16)
    assert BF16.torch_accum_dtype == torch.float32
    for name, bits, dtype in (("fixed64_q24.40", 64, torch.int64),
                              ("fixed32_q8.24", 32, torch.int32)):
        pol = get_policy(name)
        assert pol.is_fixed_point and pol.name == name
        assert (pol.bits, pol.storage_dtype) == (bits, dtype)
    with pytest.raises(ValueError, match="unknown policy"):
        get_policy("float16")


def test_backends_not_ported_raise():
    """``staged`` compiles now (one callable per schedule group); an
    unknown backend raises, ``pallas`` still needs its kernel, and no
    kernel takes a fixed-point policy."""
    prog = t_dsl.inverse_helmholtz_program(3)
    staged = t_emit.compile_program(prog, backend="staged")
    assert staged.backend == "staged"
    assert len(staged.stage_fns) == len(staged.schedule.groups) > 0
    with pytest.raises(ValueError, match="unknown backend"):
        t_emit.compile_program(prog, backend="vitis")
    with pytest.raises(ValueError, match="pallas_impl"):
        t_emit.compile_program(prog, backend="pallas")
    with pytest.raises(ValueError, match="floating point"):
        t_emit.compile_program(prog, backend="pallas",
                               policy=get_policy("fixed32_q8.24"),
                               pallas_impl=lambda env: env)


def test_compile_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        t_emit.compile_program(t_dsl.inverse_helmholtz_program(3))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, "port modules import JAX or the reference: " + ", ".join(bad)


@pytest.mark.parametrize("policy", ["float32", "fixed32_q8.24"])
@pytest.mark.parametrize("backend", ["xla", "staged"])
def test_emit_frees_each_intermediate_after_its_last_reader(
        backend, policy, monkeypatch, rng):
    """A value leaves the program's working set right after its last
    reader: while the Inverse Helmholtz chain runs (six contractions,
    each read once), no more than two contraction results are alive at
    a time, and the first is gone before the last contraction starts.
    The outputs are bitwise those of an evaluation that keeps every
    value."""
    import weakref

    p, E = 4, 3
    pol = get_policy(policy)
    prog = t_operators.build_inverse_helmholtz(p, device="cpu").program
    c = t_emit.compile_program(prog, policy=pol, backend=backend)
    x = rng.uniform(-1, 1, (E, p, p, p))
    env = {"S": rng.uniform(-1, 1, (p, p)), "D": x, "u": x[::-1].copy()}
    if pol.is_fixed_point:
        env = {k: pol.encode(v) for k, v in env.items()}
    else:
        env = {k: torch.as_tensor(v, dtype=torch.float32)
               for k, v in env.items()}
    einsum = ("_eval_einsum_fixed" if pol.is_fixed_point
              else "_eval_einsum_float")
    produced, alive_at = [], []
    inner = getattr(t_emit, einsum)

    def spy(node, args, batched, policy):
        alive_at.append(sum(r() is not None for r in produced))
        out = inner(node, args, batched, policy)
        if out.dim() == 4:          # batched contraction results
            produced.append(weakref.ref(out))
        return out

    monkeypatch.setattr(t_emit, einsum, spy)
    got = c.batched_fn(env)["v"]
    assert len(produced) == 6
    assert max(alive_at) <= 2 and alive_at[-1] <= 1
    assert produced[0]() is None
    monkeypatch.setattr(t_emit, einsum, inner)
    vals, batched, _ = t_emit._load_inputs(prog, env, pol, True, None)
    t_emit._eval_nodes(prog.toposort(), vals, batched, pol,
                       {n.uid for n in prog.toposort()})
    assert torch.equal(got, vals[prog.outputs["v"].uid])
