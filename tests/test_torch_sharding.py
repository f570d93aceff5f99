"""The port's sharding rules, meshes and input shapes held against the
reference's, on the CPU in one process.

The reference's specs come from its own ``param_shardings``,
``batch_shardings``, ``cache_shardings`` and ``extend_with_dp`` on a
``jax.sharding.Mesh`` whose one CPU device is repeated to the mesh's
shape (the rules read axis names and sizes only); the port's from the
same functions on a ``MeshShape`` of those names and sizes.  Trees: the
reference's from ``jax.eval_shape`` of its init / ``init_cache`` at every
arch's full config, the port's from ``device="meta"``.  Specs are
compared leaf by leaf (``/``-joined paths), padded with None to the
leaf's rank; equal means equal.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro import configs as r_configs
from repro.configs import shapes as r_shapes
from repro.distributed import sharding as r_sharding
from repro.models import build_model as r_build_model
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.distributed import rules, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import build_model
from repro_torch.tree import named_leaves

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
CASES = [(a, m) for a in configs.ARCH_IDS for m in MESHES]
SERVING = [s for s in shapes.SHAPES if shapes.SHAPES[s].kind != "train"]

#: the reference's 8 GiB budget (a TPU figure), passed to both packages
TPU_BUDGET = 8 * 2 ** 30


@functools.lru_cache(maxsize=None)
def _jax_mesh(name):
    names, shape = MESHES[name]
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)), dtype=object)
    return Mesh(devs.reshape(shape), names)


def _port_mesh(name):
    return MeshShape(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    return r_build_model(r_configs.get(arch))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(_jax_model(arch).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return build_model(configs.get(arch), device="meta").init(torch.Generator())


def _jax_cache(arch, shape_name):
    s = r_shapes.SHAPES[shape_name]
    return jax.eval_shape(
        lambda: _jax_model(arch).init_cache(s.global_batch, s.seq_len))


def _port_cache(arch, shape_name):
    s = shapes.SHAPES[shape_name]
    return build_model(configs.get(arch), device="meta").init_cache(
        s.global_batch, s.seq_len)


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_specs(shardings, shapes_tree):
    """{path: padded spec} of a tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes_tree)
    sh = jax.tree_util.tree_leaves(shardings,
                                   is_leaf=lambda x: hasattr(x, "spec"))
    return {r_sharding._path_str(p): _pad(s.spec, len(leaf.shape))
            for (p, leaf), s in zip(flat, sh)}


def _port_specs(specs, shapes_tree):
    """{path: padded spec} of the port's spec tree over its leaves."""
    return {path.replace(".", "/"): _pad(spec, len(sharding._shape(leaf)))
            for (path, leaf), spec in zip(
                named_leaves(shapes_tree, is_leaf=sharding._is_leaf),
                sharding._leaves(specs))}


# -- shapes ---------------------------------------------------------------------

def test_shape_table_is_the_reference():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == {
        k: vars(v) for k, v in r_shapes.SHAPES.items()}
    assert configs.shapes is shapes


@pytest.mark.parametrize("arch,shape_name",
                         [(a, s) for a in configs.ARCH_IDS
                          for s in shapes.SHAPES])
def test_applicable_and_input_specs_match_reference(arch, shape_name):
    cfg, r_cfg = configs.get(arch), r_configs.get(arch)
    assert shapes.applicable(cfg, shape_name) == r_shapes.applicable(
        r_cfg, shape_name)
    got = shapes.input_specs(cfg, shape_name)
    want = r_shapes.input_specs(r_cfg, shape_name)
    assert list(got) == list(want)
    for k, w in want.items():
        shape, dtype = got[k]
        assert shape == tuple(w.shape), k
        assert str(dtype).replace("torch.", "") == str(w.dtype), k


# -- meshes ---------------------------------------------------------------------

def test_production_mesh_shapes():
    assert mesh_mod.make_production_mesh() == MeshShape(
        ("data", "model"), (16, 16))
    big = mesh_mod.make_production_mesh(multi_pod=True)
    assert big == MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert mesh_mod.data_axes(big) == ("pod", "data")
    assert mesh_mod.axis_sizes(big) == {"pod": 2, "data": 16, "model": 16}


def test_local_mesh_refuses_a_model_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="nproc-per-node"):
        mesh_mod.make_local_mesh(3, device="cpu")


# -- the reference's rule cases (tests/test_distributed.py) ------------------------

def test_param_rules_match_expected_axes():
    mesh = _port_mesh("1x1")
    cases = {
        "embed/tok": (("model", None), 2),
        "blocks/attn/wq/w": ((None, "model"), 2),
        "blocks/attn/wo/w": (("model", None), 2),
        "blocks/mlp/gate/w": ((None, "model"), 2),
        "blocks/mlp/down/w": (("model", None), 2),
        "blocks/moe/w_gate": (("model", None, None), 3),
        "blocks/mamba/in_proj/w": ((None, "model"), 2),
        "blocks/ln1/scale": ((), 1),
    }
    for path, (want, ndim) in cases.items():
        got = _pad(sharding.spec_for_param(path, ndim, mesh), ndim)
        assert got == (None,) * (ndim - len(want)) + want, path
        r = r_sharding.spec_for_param(path, ndim, _jax_mesh("1x1"))
        assert got == _pad(r, ndim), path


def test_stacked_leading_axis_left_unsharded():
    spec = sharding.spec_for_param("blocks/attn/wq/w", 3, _port_mesh("4x2"))
    assert spec[0] is None and spec == (None, None, "model")


def test_divisibility_fallback():
    assert sharding._divisible((6, 64), (None, "model"),
                               _port_mesh("1x1")) == (None, "model")
    # 6 heads do not divide a 16-way model axis: replicated there
    assert sharding._divisible((6, 64), ("model", "model"),
                               _port_mesh("16x16")) == (None, "model")
    assert sharding._divisible((6, 64), ("model", None), _port_mesh(
        "16x16")) == tuple(r_sharding._divisible(
            (6, 64), P("model", None), _jax_mesh("16x16")))


def test_rules_are_the_reference():
    assert sharding.PARAM_RULES == r_sharding.PARAM_RULES
    assert sharding.DP_ONLY is False and r_sharding.DP_ONLY is False


# -- every arch's full-width specs ---------------------------------------------------

@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_match_reference(arch, mesh):
    jp, tp = _jax_params(arch), _port_params(arch)
    want = _jax_specs(r_sharding.param_shardings(jp, _jax_mesh(mesh)), jp)
    got = _port_specs(sharding.param_specs(tp, _port_mesh(mesh)), tp)
    assert got == want


def test_vocab_split_is_the_last_params_trees():
    """``param_specs`` makes ``rules.VOCAB_SPLIT`` the vocab that its tree's
    embedding or head splits, replacing the last tree's: a process that
    places several models (the dry run's sweep) keeps the head's column
    split for the model it places only."""
    for arch in ("internlm2-1.8b", "qwen2-7b", "internlm2-1.8b"):
        sharding.param_specs(_port_params(arch), _port_mesh("16x16"))
        assert rules.VOCAB_SPLIT == {configs.get(arch).vocab}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_extend_with_dp_and_fit_match_reference(arch, mesh):
    jp, tp = _jax_params(arch), _port_params(arch)
    jm, pm = _jax_mesh(mesh), _port_mesh(mesh)
    want = _jax_specs(r_sharding.extend_with_dp(
        r_sharding.param_shardings(jp, jm), jp, jm), jp)
    got = _port_specs(sharding.extend_with_dp(
        sharding.param_specs(tp, pm), tp, pm), tp)
    assert got == want
    assert sharding.params_fit_replicated_dp(tp, pm, TPU_BUDGET) == (
        r_sharding.params_fit_replicated_dp(jp, jm, TPU_BUDGET))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_specs_match_reference(arch, mesh):
    jm, pm = _jax_mesh(mesh), _port_mesh(mesh)
    for shape_name in shapes.SHAPES:
        jb = r_shapes.input_specs(r_configs.get(arch), shape_name)
        tb = shapes.input_specs(configs.get(arch), shape_name)
        want = _jax_specs(r_sharding.batch_shardings(jb, jm), jb)
        got = _port_specs(sharding.batch_specs(tb, pm), tb)
        assert got == want, shape_name


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_specs_match_reference(arch, mesh):
    jm, pm = _jax_mesh(mesh), _port_mesh(mesh)
    r_cfg, cfg = r_configs.get(arch), configs.get(arch)
    for shape_name in SERVING:
        if shapes.applicable(cfg, shape_name):
            continue
        batch = shapes.SHAPES[shape_name].global_batch
        jc, tc = _jax_cache(arch, shape_name), _port_cache(arch, shape_name)
        want = _jax_specs(r_sharding.cache_shardings(jc, r_cfg, jm,
                                                     batch=batch), jc)
        got = _port_specs(sharding.cache_specs(tc, cfg, pm, batch=batch), tc)
        assert got == want, shape_name


def test_fit_default_budget_is_the_cards():
    """The default budget is the H100's 80 GiB: dbrx-132b's 263 GB of bf16
    params fit it over a 16-way model axis (16.5 GB a rank), not on one
    rank, and not the reference's 8 GiB over 16 ranks."""
    pm1, pm16 = _port_mesh("1x1"), _port_mesh("16x16")
    dbrx = _port_params("dbrx-132b")
    assert sharding.params_fit_replicated_dp(_port_params("internlm2-1.8b"),
                                             pm1)
    assert not sharding.params_fit_replicated_dp(dbrx, pm1)
    assert sharding.params_fit_replicated_dp(dbrx, pm16)
    assert not sharding.params_fit_replicated_dp(dbrx, pm16, TPU_BUDGET)


# -- placements -------------------------------------------------------------------

class _FakeMesh:
    """What ``to_placements`` reads of a DeviceMesh."""

    def __init__(self, names):
        self.mesh_dim_names = names
        self.ndim = len(names)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = _FakeMesh(("pod", "data", "model"))
    assert sharding.to_placements((None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert sharding.to_placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements((), m) == (Replicate(),) * 3
    assert sharding.replicated(m) == (Replicate(),) * 3


class _Spec:
    """What a rule sees of a tensor: its shape."""

    def __init__(self, t):
        self.shape = torch.Size(t.shape)


def _split(t, pl, n, gen):
    """``t`` as ``n`` ranks hold it under one mesh dim's placement ``pl``:
    shards, copies, or random terms of a sum."""
    from torch.distributed.tensor import Partial, Shard

    if isinstance(pl, Shard):
        return list(t.chunk(n, dim=pl.dim))
    if isinstance(pl, Partial):
        parts = [torch.randn(t.shape, generator=gen, dtype=t.dtype)
                 for _ in range(n - 1)]
        return parts + [t - sum(parts)]
    return [t] * n


def _join(parts, pl):
    from torch.distributed.tensor import Partial, Shard

    if isinstance(pl, Shard):
        return torch.cat(parts, dim=pl.dim)
    if isinstance(pl, Partial):
        return sum(parts)
    for p in parts[1:]:
        assert torch.equal(p, parts[0])
    return parts[0]


def _gather_index(gen):
    return torch.randint(0, 6, (4, 6, 1), generator=gen)


RULE_CASES = {
    # rule, op on plain tensors, tensor args, other args
    "mm": (rules._mm, torch.mm, lambda g: (
        torch.randn(4, 6, generator=g, dtype=torch.float64),
        torch.randn(6, 8, generator=g, dtype=torch.float64)), ()),
    "bmm": (rules._bmm, torch.bmm, lambda g: (
        torch.randn(4, 6, 2, generator=g, dtype=torch.float64),
        torch.randn(4, 2, 8, generator=g, dtype=torch.float64)), ()),
    "searchsorted": (rules._searchsorted, torch.searchsorted, lambda g: (
        torch.sort(torch.randn(4, 6, 8, generator=g)).values,
        torch.randn(4, 6, 2, generator=g)), ()),
    "log_sigmoid_backward": (
        rules._log_sigmoid_backward, torch.ops.aten.log_sigmoid_backward,
        lambda g: (torch.randn(4, 6, generator=g),
                   torch.randn(4, 6, generator=g),
                   torch.ops.aten.log_sigmoid_forward(
                       torch.randn(4, 6, generator=g))[1]), ()),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES) + ["gather"])
def test_sharding_rules_are_exact_on_two_ranks(name):
    """Every placement a rule of :mod:`repro_torch.distributed.rules`
    accepts, simulated on two ranks: the op on each rank's pieces,
    joined by the output placement, equals the op on whole tensors; and
    replicating everything is always among them."""
    from torch.distributed.tensor import Replicate

    gen = torch.Generator().manual_seed(0)
    if name == "gather":
        rule, op = rules._gather, lambda x, i: torch.gather(x, 2, i)
        args, extra = (torch.randn(4, 6, 8, generator=gen),
                       _gather_index(gen)), ()
        strategies = rule(_Spec(args[0]), 2, _Spec(args[1]))
        strategies = [(o, [i[0], i[2]]) for o, i in strategies]
    else:
        rule, op, make, extra = RULE_CASES[name]
        args = make(gen)
        strategies = rule(*(_Spec(a) for a in args), *extra)
    assert ([Replicate()], [Replicate()] * len(args)) in [
        (o, [p for p in i if p is not None]) for o, i in strategies]
    want = op(*args)
    for out_pl, in_pl in strategies:
        in_pl = [p for p in in_pl if p is not None]
        pieces = [_split(a, p, 2, gen) for a, p in zip(args, in_pl)]
        got = _join([op(*(pc[r] for pc in pieces)) for r in range(2)],
                    out_pl[0])
        torch.testing.assert_close(got, want, rtol=1e-12 if want.dtype ==
                                   torch.float64 else 1e-6, atol=1e-12,
                                   msg=f"{name}: {out_pl} <- {in_pl}")


def test_gather_rule_never_splits_the_gathered_dim():
    from torch.distributed.tensor import Shard

    x, i = torch.zeros(4, 6, 8), torch.zeros(4, 6, 1, dtype=torch.long)
    dims = {o[0].dim for o, _ in rules._gather(_Spec(x), -1, _Spec(i))
            if isinstance(o[0], Shard)}
    assert dims == {0, 1}


def test_log_sigmoid_backward_rule_replicates_an_empty_buffer():
    from torch.distributed.tensor import Replicate

    x = torch.zeros(4, 6)
    for _, (_, _, buf) in rules._log_sigmoid_backward(
            _Spec(x), _Spec(x), _Spec(torch.zeros(0))):
        assert buf == Replicate()
