"""The paper's fixed-point formats in the port, held bit for bit against
the reference (run under ``enable_x64``, as tests/test_precision.py runs
it): encode, fmul, fdiv, contract and the one-operand einsums on drawn
values and the limb edges, then whole Inverse-Helmholtz, interpolation
and gradient programs on the ``xla`` and ``staged`` backends.  Integer
outputs are compared with ``array_equal``: no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import dsl as r_dsl
from repro.core import emit as r_emit
from repro.core import precision as r_prec
from repro.core import rewrite as r_rewrite
from repro.core.precision import enable_x64
from repro_torch.core import api, emit as t_emit
from repro_torch.core import dsl as t_dsl
from repro_torch.core import ir as t_ir
from repro_torch.core import precision as t_prec
from repro_torch.core import rewrite as t_rewrite
from repro_torch.core.precision import (FIXED32, FIXED64, POLICIES,
                                        FixedPointPolicy, get_policy)

PAIRS = [pytest.param(r_prec.FIXED32, FIXED32, id="fixed32_q8.24"),
         pytest.param(r_prec.FIXED64, FIXED64, id="fixed64_q24.40")]
INT64 = st.integers(-2 ** 63, 2 ** 63 - 1)
INT32 = st.integers(-2 ** 31, 2 ** 31 - 1)


def _ref(fn, *args):
    """A reference call under x64 on numpy arguments (made JAX arrays
    inside the x64 context, so int64 stays int64), as a numpy array."""
    with enable_x64(True):
        return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _equal(want, got: torch.Tensor):
    assert got.dtype == {np.dtype("int32"): torch.int32,
                         np.dtype("int64"): torch.int64,
                         np.dtype("float64"): torch.float64}[want.dtype]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _limb_edges():
    """Q-values at the 64-bit multiply's limb edges: high limb
    +-(2**31 - 1) and -2**31, low limb 2**32 - 1 and 0, and the Q24.40
    headroom (decoded magnitude 2**23)."""
    hi = [2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31, 0, 1, -1]
    lo = [2 ** 32 - 1, 0, 1, 2 ** 31]
    vals = {(h << 32) | l for h in hi for l in lo}
    vals |= {2 ** 63 - 1, -2 ** 63, 2 ** 63 - 2 ** 32}
    head = 2 ** 23 * 2 ** 40
    vals |= {head - 1, -head, -(head - 1), head // 2}
    return np.array(sorted(vals), dtype=np.int64)


def test_formats_and_registry():
    assert (FIXED32.total_bits, FIXED32.frac_bits) == (32, 24)
    assert (FIXED64.total_bits, FIXED64.frac_bits) == (64, 40)
    assert (FIXED32.storage_dtype, FIXED64.storage_dtype) == (torch.int32,
                                                              torch.int64)
    assert set(POLICIES) == set(r_prec.POLICIES)
    for name, rp in r_prec.POLICIES.items():
        tp = get_policy(name)
        assert (tp.name, tp.bits, tp.is_fixed_point) == (
            rp.name, rp.bits, rp.is_fixed_point)
    for bad in ((16, 8), (32, 40), (64, 0)):
        with pytest.raises(ValueError):
            FixedPointPolicy(*bad)


@pytest.mark.parametrize("r_pol,t_pol", PAIRS)
def test_encode_decode_match_reference(r_pol, t_pol):
    rng = np.random.default_rng(0)
    top = 2.0 ** (t_pol.total_bits - t_pol.frac_bits - 1)
    x = np.concatenate([
        rng.uniform(-1, 1, 500),
        rng.uniform(-top, top, 500),
        # ties round half to even; out of range saturates; NaN is 0
        np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5]) / t_pol.scale,
        [top, -top, 2 * top, -2 * top, np.inf, -np.inf, np.nan, 1e300],
    ])
    want = _ref(r_pol.encode, x)
    got = t_pol.encode(x)
    _equal(want, got)
    _equal(_ref(r_pol.decode, want), t_pol.decode(got))
    assert t_pol.encode(torch.from_numpy(x)).equal(got)
    # a float32 input is widened exactly, as jnp.asarray(x, float64) does
    x32 = rng.uniform(-1, 1, 100).astype(np.float32)
    _equal(_ref(r_pol.encode, x32), t_pol.encode(x32))
    assert np.abs(t_pol.decode(t_pol.encode(x[:500])).numpy()
                  - x[:500]).max() <= 2.0 ** -t_pol.frac_bits


@given(st.lists(st.tuples(INT64, INT64), min_size=1, max_size=32))
@settings(max_examples=40, deadline=None)
def test_fmul64_drawn_q_values_bitwise(pairs):
    """Any int64 pair, wrap included: the signed-limb product equals the
    reference's uint64-limb product bit for bit."""
    a, b = (np.array(v, dtype=np.int64) for v in zip(*pairs))
    want = _ref(r_prec.FIXED64.fmul, a, b)
    _equal(want, FIXED64.fmul(torch.from_numpy(a), torch.from_numpy(b)))


@given(st.lists(st.tuples(INT32, INT32), min_size=1, max_size=32))
@settings(max_examples=40, deadline=None)
def test_fmul32_drawn_q_values_bitwise(pairs):
    a, b = (np.array(v, dtype=np.int32) for v in zip(*pairs))
    want = _ref(r_prec.FIXED32.fmul, a, b)
    _equal(want, FIXED32.fmul(torch.from_numpy(a), torch.from_numpy(b)))


@given(st.floats(-1, 1), st.floats(-1, 1))
@settings(max_examples=50, deadline=None)
def test_fmul_within_ulp(a, b):
    for pol, tol in ((FIXED32, 2 ** -22), (FIXED64, 2 ** -38)):
        got = pol.decode(pol.fmul(pol.encode(a), pol.encode(b))).item()
        assert abs(got - a * b) < tol


def test_fmul64_limb_edges_bitwise():
    vals = _limb_edges()
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    want = _ref(r_prec.FIXED64.fmul, a, b)
    _equal(want, FIXED64.fmul(torch.from_numpy(a), torch.from_numpy(b)))


def test_fixed64_headroom():
    """Decoded magnitudes up to 2**23 (the paper's 24 integer bits):
    products of large x small stay accurate and equal the reference."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-2 ** 23, 2 ** 23, 400), [3000.5]])
    y = np.concatenate([rng.uniform(-1, 1, 400), [0.125]])
    qa, qb = FIXED64.encode(x), FIXED64.encode(y)
    got = FIXED64.fmul(qa, qb)
    want = _ref(lambda a, b: r_prec.FIXED64.fmul(r_prec.FIXED64.encode(a),
                                                 r_prec.FIXED64.encode(b)),
                x, y)
    _equal(want, got)
    assert abs(FIXED64.decode(got[-1]).item() - 3000.5 * 0.125) < 1e-6
    np.testing.assert_allclose(FIXED64.decode(got).numpy(), x * y, rtol=0,
                               atol=2 ** -30 * 2 ** 23)


@pytest.mark.parametrize("r_pol,t_pol", PAIRS)
def test_fdiv_matches_reference(r_pol, t_pol):
    """int32: floor division (-7 // 2 = -4, not -3); int64: the float64
    reciprocal path, bit for bit (out-of-range quotients saturate)."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-1, 1, 400), [-7, 7, -7, 3.5]])
    y = np.concatenate([rng.uniform(-1, 1, 400), [2, -2, -2, 0.25]])
    y[np.abs(y) < 1e-3] = 0.5
    qa, qb = t_pol.encode(x), t_pol.encode(y)
    want = _ref(lambda a, b: r_pol.fdiv(r_pol.encode(a), r_pol.encode(b)),
                x, y)
    _equal(want, t_pol.fdiv(qa, qb))
    if t_pol is FIXED32:  # q-values -7 and 7 over 2.0
        two = FIXED32.encode([2.0, 2.0])
        q = torch.tensor([-7, 7], dtype=torch.int32)
        assert FIXED32.fdiv(q, two).tolist() == [-4, 3]


CONTRACT_SPECS = [
    ("Zabc,da->Zdbc", (4, 5, 5, 5), (5, 5)),     # batched mode contraction
    ("abc,cd->dba", (5, 4, 3), (3, 6)),
    ("abc,cd->ad", (5, 4, 3), (3, 6)),             # two summed indices
    ("abc,cd->abcd", (2, 3, 4), (4, 5)),           # nothing summed
    ("Zab,Zab->Zab", (3, 4, 4), (3, 4, 4)),        # element-wise
    ("ab,ab->", (4, 4), (4, 4)),                   # full reduction
]


@pytest.mark.parametrize("spec,sa,sb", CONTRACT_SPECS,
                         ids=[s[0] for s in CONTRACT_SPECS])
@pytest.mark.parametrize("r_pol,t_pol", PAIRS)
def test_contract_matches_reference(r_pol, t_pol, spec, sa, sb,
                                    monkeypatch):
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-1, 1, sa), rng.uniform(-1, 1, sb)
    qa, qb = t_pol.encode(a), t_pol.encode(b)
    want = _ref(lambda x, y: r_pol.contract(r_pol.encode(x),
                                            r_pol.encode(y), spec), a, b)
    _equal(want, t_pol.contract(qa, qb, spec))
    # chunks of one index value each: the same bits
    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", 1)
    _equal(want, t_pol.contract(qa, qb, spec))


def _contract_widened_whole(pol, a, b, subscripts):
    """``contract`` as it was before its widening was chunked: each whole
    operand cast to int64 (Q8.24) or split into limbs (Q24.40) first,
    the products unchunked -- the bits the chunked version must keep."""
    in_spec, out_spec = subscripts.split("->")
    sa, sb = in_spec.split(",")
    union = sa + "".join(c for c in sb if c not in sa)
    dims = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}

    def expand(x, s):
        perm = [s.index(c) for c in union if c in s]
        return x.permute(perm).reshape(
            tuple(dims[c] if c in s else 1 for c in union))

    sum_axes = [i for i, c in enumerate(union) if c not in out_spec]
    if pol.total_bits == 32:
        prod = expand(a.to(torch.int64), sa) * expand(b.to(torch.int64), sb)
        prod += 1 << (pol.frac_bits - 1)
        prod >>= pol.frac_bits
    else:
        prod = t_prec._fmul64(t_prec._split64(expand(a, sa)),
                              t_prec._split64(expand(b, sb)), pol.frac_bits)
    out = (prod.sum(dim=sum_axes) if sum_axes else prod).to(
        pol.storage_dtype)
    remaining = [c for c in union if c in out_spec]
    return out.permute([remaining.index(c) for c in out_spec])


@pytest.mark.parametrize("chunk", [None, 7, 1], ids=["default", "7", "1"])
@pytest.mark.parametrize("spec,sa,sb", CONTRACT_SPECS,
                         ids=[s[0] for s in CONTRACT_SPECS])
@pytest.mark.parametrize("pol", [FIXED64, FIXED32], ids=["q24.40", "q8.24"])
def test_contract_chunked_widening_bitwise(pol, spec, sa, sb, chunk,
                                           monkeypatch):
    """Widening each chunk after narrowing it gives the bits of widening
    the whole operands first, at every chunk size."""
    rng = np.random.default_rng(8)
    qa = pol.encode(rng.uniform(-4, 4, sa))
    qb = pol.encode(rng.uniform(-4, 4, sb))
    want = _contract_widened_whole(pol, qa, qb, spec)
    if chunk is not None:
        monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", chunk)
    got = pol.contract(qa, qb, spec)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_contract_never_widens_a_whole_operand(monkeypatch):
    """Q24.40: the limb split sees one chunk of the batched operand at a
    time (and the small operand the chunk axis does not cut, once)."""
    seen = []
    real = t_prec._split64

    def spy(x):
        seen.append(x.numel())
        return real(x)

    monkeypatch.setattr(t_prec, "_split64", spy)
    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", 5 * 5 * 5 * 5)
    rng = np.random.default_rng(2)
    u = FIXED64.encode(rng.uniform(-1, 1, (12, 5, 5, 5)))
    s_ = FIXED64.encode(rng.uniform(-1, 1, (5, 5)))
    FIXED64.contract(u, s_, "Zabc,da->Zdbc")
    assert seen.count(25) == 1            # the shared matrix, whole, once
    assert max(seen) == 125 and len(seen) == 13  # one element per chunk


@pytest.mark.parametrize("chunk", [1, 7, 1 << 40], ids=["1", "7", "whole"])
@pytest.mark.parametrize("pol", [FIXED64, FIXED32], ids=["q24.40", "q8.24"])
def test_fmul_fdiv_slices_bitwise(pol, chunk, monkeypatch):
    """The elementwise multiply and divide widen their operands a dim-0
    slice at a time: every slice size gives the bits of the whole, with
    broadcasting, and the reference's."""
    rng = np.random.default_rng(9)
    a, b = rng.uniform(-3, 3, (6, 4, 5)), rng.uniform(0.5, 3, (4, 5))
    qa, qb = pol.encode(a), pol.encode(b)
    r_pol = {FIXED64: r_prec.FIXED64, FIXED32: r_prec.FIXED32}[pol]
    want_mul = _ref(lambda x, y: r_pol.fmul(r_pol.encode(x), r_pol.encode(y)),
                    a, b)
    want_div = _ref(lambda x, y: r_pol.fdiv(r_pol.encode(x), r_pol.encode(y)),
                    a, b)
    monkeypatch.setattr(t_prec, "CONTRACT_CHUNK_VALUES", chunk)
    _equal(want_mul, pol.fmul(qa, qb))
    _equal(want_div, pol.fdiv(qa, qb))


def test_contract32_wraps_like_reference():
    """Products near the int32 edge: the int32 sum wraps modulo 2**32 in
    both packages."""
    q = np.full((3, 6), 2 ** 31 - 1, dtype=np.int32)
    q[1] = -2 ** 31
    want = _ref(lambda x: r_prec.FIXED32.contract(x, x, "ab,ab->a"), q)
    got = FIXED32.contract(torch.from_numpy(q), torch.from_numpy(q),
                           "ab,ab->a")
    _equal(want, got)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("spec", ["abc->cab", "aab->ba", "abc->a",
                                  "aba->b", "ab->"])
def test_unary_einsum_matches_jnp(spec, dtype):
    """Transpose, diagonal and reduce without an einsum kernel; integer
    sums wrap in the input's width, as XLA's do."""
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, (4, 4, 4)[:len(spec.split("-")[0])],
                     dtype=dtype, endpoint=True)
    want = _ref(lambda v: jnp.einsum(spec, v), x)
    _equal(want, t_emit._einsum_unary(spec, torch.from_numpy(x)))


OPERATORS = {
    "helmholtz": ("INVERSE_HELMHOLTZ_SRC", lambda p: dict(p=p),
                  ("u", "D", "v")),
    "interpolation": ("INTERPOLATION_SRC", lambda p: dict(n=p, m=p + 1),
                      ("u", "v")),
    "gradient": ("GRADIENT_SRC", lambda p: dict(nx=p, ny=p + 1, nz=p - 1),
                 ("u", "gx", "gy", "gz")),
}


@pytest.mark.parametrize("backend", ["xla", "staged"])
@pytest.mark.parametrize("p", [3, 5, 7])
@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("r_pol,t_pol", PAIRS)
def test_operators_bitwise_equal_reference(r_pol, t_pol, op, p, backend):
    attr, fmt, ev = OPERATORS[op]
    src = getattr(r_dsl, attr).format(**fmt(p))
    assert src == getattr(t_dsl, attr).format(**fmt(p))
    r_prog = r_rewrite.optimize(r_dsl.parse(src, element_vars=ev))
    rng = np.random.default_rng(p)
    E = 3
    env = {k: rng.uniform(-1, 1, ((E,) if k in ev else ()) + v.shape)
           for k, v in r_prog.inputs.items()}
    one = {k: (v[0] if k in ev else v) for k, v in env.items()}
    with enable_x64(True):
        r_fn = r_emit.compile_program(r_prog, policy=r_pol, backend=backend,
                                      jit=False)
        enc = {k: r_pol.encode(v) for k, v in env.items()}
        want = {k: np.asarray(v) for k, v in r_fn.batched_fn(enc).items()}
        want_one = {k: np.asarray(v) for k, v in r_fn.element_fn(
            {k: r_pol.encode(v) for k, v in one.items()}).items()}
    t_fn = api.compile_cfdlang(src, element_vars=ev, policy=t_pol.name,
                               backend=backend, device="cpu")
    assert t_fn.policy is t_pol and t_fn.backend == backend
    got = t_fn.batched_fn({k: t_pol.encode(v) for k, v in env.items()})
    got_one = t_fn.element_fn({k: t_pol.encode(v) for k, v in one.items()})
    assert set(got) == set(want)
    for k in want:
        _equal(want[k], got[k])
        _equal(want_one[k], got_one[k])
    if backend == "staged":
        assert len(t_fn.stage_fns) == len(r_fn.stage_fns)


@pytest.mark.parametrize(
    "pol,paper_mse,slack",
    [(FIXED32, 3.58e-12, 100.0), (FIXED64, 9.39e-22, 100.0)],
)
def test_helmholtz_mse_matches_paper_order(pol, paper_mse, slack, rng):
    """End-to-end fixed-point Inverse Helmholtz on [-1,1] data lands
    within two orders of the paper's reported MSE (the reference's own
    test, on the port)."""
    p = 7
    prog = t_rewrite.optimize(t_dsl.inverse_helmholtz_program(p))
    S = rng.uniform(-1, 1, (p, p))
    D = rng.uniform(-1, 1, (p, p, p))
    u = rng.uniform(-1, 1, (p, p, p))
    t = np.einsum("il,jm,kn,lmn->ijk", S, S, S, u)
    v = np.einsum("li,mj,nk,lmn->ijk", S, S, S, D * t)
    c = t_emit.compile_program(prog, policy=pol)
    env = {k: pol.encode(val) for k, val in {"S": S, "D": D, "u": u}.items()}
    got = pol.decode(c.element_fn(env)["v"]).numpy()
    mse = float(np.mean((got - v) ** 2))
    assert 0 < mse < paper_mse * slack


def test_fixed_point_requires_factorized_program():
    prog = t_dsl.inverse_helmholtz_program(3)  # literal: 4-ary einsum
    flat = t_rewrite.flatten_products(prog)
    c = t_emit.compile_program(flat, policy=FIXED32)
    env = {k: FIXED32.encode(np.zeros(v.shape)) for k, v in prog.inputs.items()}
    with pytest.raises(t_ir.IRError, match="factorized"):
        c.element_fn(env)


def test_fixed_point_takes_encoded_inputs_and_no_kernel():
    """A float input to a fixed-point program, or an int32 one to a
    Q24.40 program, raises (it would otherwise be truncated); the
    float kernels refuse a fixed-point policy."""
    c = api.compile_cfdlang(t_dsl.INVERSE_HELMHOLTZ_SRC.format(p=3),
                            element_vars=("u", "D", "v"), policy="fixed64_q24.40",
                            device="cpu")
    env = {"S": np.zeros((3, 3)), "D": np.zeros((2, 3, 3, 3)),
           "u": np.zeros((2, 3, 3, 3))}
    with pytest.raises(TypeError, match="encode"):
        c.batched_fn(env)
    with pytest.raises(TypeError, match="encode"):
        c.batched_fn({k: FIXED32.encode(v) for k, v in env.items()})
    out = c.batched_fn({k: FIXED64.encode(v) for k, v in env.items()})
    assert out["v"].dtype == torch.int64 and not out["v"].any()
    with pytest.raises(ValueError, match="floating point"):
        t_emit.compile_program(t_dsl.inverse_helmholtz_program(3),
                               policy=FIXED32, backend="pallas",
                               pallas_impl=lambda env: env)
