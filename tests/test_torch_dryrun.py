"""The port's dry run (``repro_torch.launch.dryrun``,
``repro_torch.analysis.scancost``) held against the reference's
``repro.launch.dryrun`` at smoke widths and small shapes (``SHAPES``
replaced in both packages).

The port's side runs in subprocesses (:data:`PORT`, side by side): its
fake process group must not outlive it in a test worker.  The
reference's compiled cells run in two others, on 4 and 8 forced host
devices (:data:`REF_COMPILE`); its jaxprs are walked here, where JAX
keeps one device.  Held:

* at 1 x 1, the per-device FLOPs of the matrix products of train,
  prefill and decode cells, one arch of each family (the xLSTM
  recurrent and chunked), equal the reference's dot FLOPs exactly (the
  chunked mLSTM's sequence cells: see the test),
  counted from the jaxpr of its ``build_cell`` function
  (``dot_general``: 2 x output elements x contracted size; scan bodies
  times their length, every other sub-jaxpr once);
* on (2, 2) and (1, 4) meshes, and on the 3-D (pod, data, model) =
  (2, 2, 2) mesh (:data:`MESH3_CELLS`, the reference compiling on 8
  forced host devices), argument bytes equal the reference's
  compiled ``memory_analysis().argument_size_in_bytes``; collective
  bytes by kind equal what this torch's DTensor issues, pinned per
  torch version (:data:`MESH_COLL`); no DTensor op of a 3-D cell reads
  an activation placed ``_StridedShard``.  Per-device
  FLOPs and collective bytes within the bounds of
  :data:`FLOPS_RATIO` and :data:`COLL_RATIO` of its
  ``roofline.analyze`` plus ``scancost.corrections``: XLA also counts
  elementwise FLOPs (the port's count is the products' only, 0.48-1.0
  of XLA's at these cells), and where GSPMD splits the masked
  attention of a decode over the model axis DTensor gathers q (up to
  2.6x); DTensor reduces its partial sums late and gathers weights
  where GSPMD reduces activations (1.2-2.9x the bytes at these cells'
  train and prefill cells; an MoE decoder's combine, which the port
  reduces once after the top-k sum, is held apart to move fewer bytes
  than GSPMD's), while a decode cell, which writes and reads
  its cache where it lies, moves 0.27-7.6x (:data:`DECODE_COLL_RATIO`);
  the temporaries within :data:`TEMP_RATIO` of the compiled ones (the
  xLSTM's prefill and train cells among them);
* at published widths on the 16 x 16 mesh and the multi-pod one
  (:data:`PROD_CELLS`, the reference's ``run_cell`` compiling on 512
  forced host devices): qwen3-14b's and qwen2-7b's train cells within
  the reference's temporaries, internlm2-1.8b's multi-pod one within
  1.25x and at most 0.6x its single-pod cell's FLOPs a device (attention
  and the MLP split over ``model``, :data:`PROD_SPLIT`);
  internlm2-1.8b's and olmoe's train cells hold no tensor with the
  whole vocab at their peak, olmoe's none of the global tokens' size,
  their temporaries within 2x the reference's and the total within the
  H100's 80 GiB; olmoe's prefill cell, whose cache is split by layer,
  and xlstm-125m's (composed from short runs), within 2x the
  reference's temporaries and 80 GiB; and five decode cells' collective
  bytes stay within 10x the reference's;
* collective bytes of one dense block on a (1, 2) mesh equal a hand
  count of what this torch's DTensor issues;
* each looping cell composed from four short runs equals the same
  cell run whole at T = 24 in FLOPs and collective bytes;
* the ruled skips equal the reference's ``applicable``; and the
  ``--bf16-reduce`` forward stays within phase 5's bf16 bounds of the
  reference's.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from conftest import subprocess_env

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: each process's limit in seconds from their common launch, by
#: :data:`PARTS`' name (``part:half`` as ``part``) or the reference's:
#: at least twice its time beside eight busy processes
#: (``tools/fixture_timing.py dryrun --busy 8``: flops 75, mesh 96,
#: mesh3 135, loops 122, production 180, ref 107, ref_production 142 s)
TIMEOUT_S = {"flops": 300, "mesh": 300, "mesh3": 360, "loops": 360,
             "production": 420, "ref": 300, "ref_production": 360}
#: port / reference bounds (see the module docstring)
FLOPS_RATIO = (0.4, 3.0)
COLL_RATIO = (1.0, 10.0)
#: a decode cell's collective bytes over the reference's compiled ones: it
#: writes and reads its cache where it lies, and moves less than GSPMD's
#: program on torch 2.11 (0.27-0.41 at these cells; 2.13: 5.7-7.6)
DECODE_COLL_RATIO = (0.2, 10.0)
#: the port's temporaries over the reference's compiled ones, every mesh
#: cell (eager live bytes against a fused program's buffers: 0.18-1.79 on
#: torch 2.11, 0.59-1.96 on 2.13)
TEMP_RATIO = (0.1, 2.0)
#: composed bytes and memory against the whole run (a model, see
#: ``scancost``: 5 % off at most in the cells below)
MODELLED_REL = 0.1

#: one arch of each family, with the xLSTM's ``MLSTM_CHUNK``
FAMILIES = {
    "dense": ("internlm2-1.8b", None),
    "moe": ("olmoe-1b-7b", None),
    "vlm": ("chameleon-34b", None),
    "encdec": ("whisper-tiny", None),
    "xlstm": ("xlstm-125m", None),
    "xlstm_chunked": ("xlstm-125m", 8),
    "hybrid": ("jamba-1.5-large-398b", None),
}
#: the shapes both packages run: (kind, seq_len, global_batch)
SMOKE_SHAPES = {"train_4k": ("train", 16, 4),
                "prefill_32k": ("prefill", 16, 4),
                "decode_32k": ("decode", 16, 4)}
MESHES = ("2,2", "1,4")
MESH_CELLS = (("internlm2-1.8b", "train_4k"),
              ("internlm2-1.8b", "decode_32k"),
              ("olmoe-1b-7b", "prefill_32k"),
              ("whisper-tiny", "train_4k"),
              ("xlstm-125m", "prefill_32k"),
              ("xlstm-125m", "train_4k"))
#: the 3-D multi-pod mesh's cells, at a global batch of 8 (two rows a
#: data shard, so that a flatten of the batch with a dim split over
#: ``model`` would be strided)
MESH3 = "2,2,2"
MESH3_AXES = ("pod", "data", "model")
MESH3_SHAPES = {"train_4k": ("train", 16, 8), "decode_32k": ("decode", 16, 8)}
MESH3_CELLS = (("internlm2-1.8b", "train_4k"),
               ("internlm2-1.8b", "decode_32k"),
               ("jamba-1.5-large-398b", "train_4k"))
#: the collective result bytes by kind that DTensor issues for rank 0
#: in each mesh cell (all-reduce, all-gather, reduce-scatter,
#: all-to-all, collective-permute), by torch version: DTensor picks its
#: collectives differently from one version to the next
MESH_COLL = {"2.13": {
    "2,2/internlm2-1.8b/train_4k": (224528, 603648, 196736, 20480, 0),
    "2,2/internlm2-1.8b/decode_32k": (1536, 102400, 9984, 0, 0),
    "2,2/olmoe-1b-7b/prefill_32k": (34816, 33664, 16576, 0, 0),
    "2,2/whisper-tiny/train_4k": (182256, 405184, 128640, 26624, 0),
    "2,2/xlstm-125m/prefill_32k": (4096, 75824, 0, 6984, 0),
    "2,2/xlstm-125m/train_4k": (84032, 200752, 48280, 0, 0),
    "1,4/internlm2-1.8b/train_4k": (84744, 664064, 163968, 12288, 0),
    "1,4/internlm2-1.8b/decode_32k": (11264, 199680, 2560, 1280, 0),
    "1,4/olmoe-1b-7b/prefill_32k": (69632, 67328, 16576, 0, 0),
    "1,4/whisper-tiny/train_4k": (12808, 524928, 62592, 0, 0),
    "1,4/xlstm-125m/prefill_32k": (8192, 78528, 0, 6912, 0),
    "1,4/xlstm-125m/train_4k": (11960, 170752, 29952, 0, 0),
    "2,2,2/internlm2-1.8b/train_4k": (406040, 694400, 196736, 20480, 0),
    "2,2,2/internlm2-1.8b/decode_32k": (1536, 102400, 9984, 0, 0),
    "2,2,2/jamba-1.5-large-398b/train_4k": (1525784, 1804416, 401920,
                                           55808, 0),
}, "2.11": {
    "2,2/internlm2-1.8b/train_4k": (298512, 328960, 90112, 0, 0),
    "2,2/internlm2-1.8b/decode_32k": (2560, 1024, 8192, 0, 0),
    "2,2/olmoe-1b-7b/prefill_32k": (17792, 39424, 12288, 0, 0),
    "2,2/whisper-tiny/train_4k": (209936, 232448, 57344, 0, 0),
    "2,2/xlstm-125m/prefill_32k": (4096, 75824, 0, 6936, 0),
    "2,2/xlstm-125m/train_4k": (84288, 197552, 42008, 0, 0),
    "1,4/internlm2-1.8b/train_4k": (134408, 262144, 81920, 0, 0),
    "1,4/internlm2-1.8b/decode_32k": (7168, 4096, 0, 512, 0),
    "1,4/olmoe-1b-7b/prefill_32k": (35584, 66560, 12288, 0, 0),
    "1,4/whisper-tiny/train_4k": (13320, 518144, 51200, 0, 0),
    "1,4/xlstm-125m/prefill_32k": (8192, 78336, 0, 6912, 0),
    "1,4/xlstm-125m/train_4k": (12472, 164352, 23680, 0, 0),
    "2,2,2/internlm2-1.8b/train_4k": (529176, 419712, 90112, 0, 0),
    "2,2,2/internlm2-1.8b/decode_32k": (2560, 1024, 8192, 0, 0),
    "2,2,2/jamba-1.5-large-398b/train_4k": (1487000, 1799040, 233472,
                                           98304, 0),
}}
#: (arch, shape, MLSTM_CHUNK) composed from runs at 4, 8, 12 and 16
#: steps (8 to 20 chunked), and run whole at LOOP_T
LOOP_T, LOOP_BASE = 24, 4
LOOP_CELLS = (("xlstm-125m", "train_4k", None),
              ("xlstm-125m", "prefill_32k", None),
              ("xlstm-125m", "train_4k", 4),
              ("jamba-1.5-large-398b", "train_4k", None),
              ("jamba-1.5-large-398b", "prefill_32k", None))
#: production cells (published widths, the single-pod 16 x 16 mesh, the
#: reference's shapes) run whole by both packages: the train cells whose
#: logits and embedding are split on V (olmoe's MoE dispatch placed
#: expert-parallel), the decode cells whose caches the port used to
#: gather, and the prefill cells whose caches are split by layer or
#: whose recurrences stepped every rank's rows whole (the xLSTM's,
#: composed by ``scancost``)
PROD_TRAIN = ("internlm2-1.8b", "olmoe-1b-7b")
PROD_DECODE = ("internlm2-1.8b", "qwen2-7b", "qwen3-14b", "chameleon-34b",
               "olmoe-1b-7b")
PROD_PREFILL = ("olmoe-1b-7b", "xlstm-125m")
#: train cells whose heads do not divide the model axis of 16 (or whose
#: rows on the multi-pod mesh do not), each with its mesh: attention and
#: the MLP split by heads or rows, never whole on every rank of ``model``
#: (the multi-pod cell last: a process's cells after it would meet
#: DTensor's caches of its group)
PROD_SPLIT = (("qwen3-14b", "single"), ("qwen2-7b", "single"),
              ("internlm2-1.8b", "multipod"))
PROD_CELLS = tuple((a, "train_4k", "single") for a in PROD_TRAIN) + tuple(
    (a, "decode_32k", "single") for a in PROD_DECODE) + tuple(
    (a, "prefill_32k", "single") for a in PROD_PREFILL) + tuple(
    (a, "train_4k", m) for a, m in PROD_SPLIT)
#: the multi-pod train cell's FLOPs a device at most this share of the
#: single-pod cell's: it has half the rows a rank
MULTIPOD_FLOPS_SHARE = 0.6
#: its temporaries at most this multiple of the reference's compiled ones
MULTIPOD_TEMP_RATIO = 1.25
#: the H100's device memory, which an arguments-plus-temporaries total
#: must fit
HBM_BYTES = 80 * 2 ** 30
#: the port's side, in processes run side by side ("part:half" takes
#: every other family or loop cell)
PARTS = ("flops:0", "flops:1", "mesh", "mesh3", "loops:0", "loops:1",
         "production")

PORT = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.analysis import scancost
    from repro_torch.configs import shapes as ts
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models import ssm
    part, _, half = sys.argv[1].partition(":")
    job = json.loads(sys.argv[2])

    def mine(items):
        return [x for i, x in enumerate(items) if i % 2 == int(half or 0)]

    def shapes(seq_len=None):
        ts.SHAPES.clear()
        ts.SHAPES.update({n: ts.ShapeSpec(n, k, seq_len or t, b)
                          for n, (k, t, b) in job["shapes"].items()})

    def mesh(text):
        sizes = tuple(int(x) for x in text.split(","))
        m = dryrun.fake_mesh(mesh_mod.MeshShape(
            ("pod", "data", "model")[-len(sizes):], sizes))
        dryrun.set_dispatch(m, False)
        return m

    out = {}
    if part != "production":      # the published shapes there
        shapes()
    if part == "flops":
        m = mesh("1,1")
        for fam, (arch, chunk) in mine(job["families"].items()):
            ssm.MLSTM_CHUNK = chunk
            for shape in job["shapes"]:
                c = dryrun.count_cell(configs.get_smoke(arch), shape, m)
                out[f"{fam}/{shape}"] = c["flops"]
    if part == "mesh":
        # the collective bytes of the MoE combine's one reduction (the
        # DTensor handler of ``sum_top_k``), counted apart
        import torch
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed import rules  # noqa: F401
        meters, combine = [], [0]
        enter = dryrun.Meter.__enter__

        def entered(self):
            meters.append(self)
            return enter(self)

        dryrun.Meter.__enter__ = entered
        handlers = DTensor._op_dispatcher._custom_op_handlers
        top_k = torch.ops.repro_torch.sum_top_k.default
        reduce = handlers[top_k]

        def counted(*args, **kwargs):
            before = sum(meters[-1].coll.values())
            got = reduce(*args, **kwargs)
            combine[0] += sum(meters[-1].coll.values()) - before
            return got

        handlers[top_k] = counted
        for text in job["meshes"]:
            m = mesh(text)
            for arch, shape in job["mesh_cells"]:
                combine[0] = 0
                c = dryrun.count_cell(configs.get_smoke(arch), shape, m)
                out[f"{text}/{arch}/{shape}"] = dict(c, combine=combine[0])
        # one dense block's forward on a (1, 2) mesh, x replicated
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.distributed import sharding
        from repro_torch.models import transformer
        m = mesh("1,2")
        cfg = configs.get_smoke("internlm2-1.8b")
        bp = transformer.block_init(None, cfg, torch.float32, device="meta")
        bp = sharding.place(bp, sharding.param_shardings(bp, m), m)
        B, T = 4, 16
        x = sharding.distribute(torch.empty(B, T, cfg.d_model,
                                            device="meta"),
                                m, sharding.replicated(m))
        pos = torch.arange(T, device="meta")[None].expand(B, T)
        meter = dryrun.Meter((bp, x))
        with meter, implicit_replication():
            transformer.block_apply(bp, x, cfg, positions=pos,
                                    attn_impl="xla")
        out["block"] = {"coll": meter.coll, "B": B, "T": T,
                        "d": cfg.d_model, "ff": cfg.d_ff}
    if part == "mesh3":
        ts.SHAPES.clear()
        ts.SHAPES.update({n: ts.ShapeSpec(n, k, t, b)
                          for n, (k, t, b) in job["mesh3_shapes"].items()})
        m = mesh(job["mesh3"])
        for arch, shape in job["mesh3_cells"]:
            c = dryrun.count_cell(configs.get_smoke(arch), shape, m)
            out[f"{job['mesh3']}/{arch}/{shape}"] = c
    if part == "loops":
        scancost.BASE_T = job["loop_base"]
        shapes(job["loop_t"])
        m = mesh("1,1")
        for arch, shape, chunk in mine(job["loop_cells"]):
            ssm.MLSTM_CHUNK = chunk
            cfg = configs.get_smoke(arch)
            lengths = scancost.loop_lengths(cfg, shape, m, mlstm_chunk=chunk)
            samples = {t: dryrun.count_cell(cfg, shape, m, seq_len=t)
                       for t in lengths}
            corr = scancost.corrections(cfg, shape, samples,
                                        mlstm_chunk=chunk)
            base = samples[lengths[0]]
            whole = dryrun.count_cell(cfg, shape, m)
            out[f"{arch}/{shape}/{chunk}"] = {
                "lengths": lengths, "check": corr["detail"]["check"],
                "composed": {
                    "flops": base["flops"] + corr["flops"],
                    "bytes": base["bytes"] + corr["bytes"],
                    "coll": sum(base["collectives"].values()) + corr["coll"],
                    "memory": corr["memory"]},
                "whole": {"flops": whole["flops"], "bytes": whole["bytes"],
                          "coll": sum(whole["collectives"].values()),
                          "memory": whole["memory"]}}
    if part == "production":
        import tempfile
        from repro_torch.distributed import rules
        # the logits' placements as they reach the loss and as it reads
        # them (``rules.reduced_logits``)
        reduce, seen = rules.reduced_logits, []

        def pl(t):
            return ["S%d" % p.dim if p.is_shard() else
                    "R" if p.is_replicate() else "P" for p in t.placements]

        def recorded(lf):
            got = reduce(lf)
            if [pl(lf), pl(got)] not in seen:
                seen.append([pl(lf), pl(got)])
            return got

        rules.reduced_logits = recorded
        with tempfile.TemporaryDirectory() as tmp:
            for arch, shape, mesh_kind in job["production"]:
                seen.clear()
                r = dryrun.run_cell(arch, shape, mesh_kind, results_dir=tmp)
                key = f"{arch}/{shape}/{mesh_kind}"
                out[key] = {k: r.get(k) for k in ("status", "error",
                                                  "memory_analysis",
                                                  "peak_temporaries")}
                roof = r.get("roofline", {})
                out[key]["coll"] = roof.get("coll_bytes")
                out[key]["flops"] = roof.get("device_flops")
                out[key]["vocab"] = configs.get(arch).vocab
                out[key]["d_model"] = configs.get(arch).d_model
                out[key]["logits"] = list(seen)
    dryrun.release_fake_group()
    print(json.dumps(out))
""")

#: the reference's production cells, compiled on 512 forced host devices
REF_PRODUCTION = textwrap.dedent("""
    import json, sys, tempfile
    from repro.launch import dryrun
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, mesh_kind in json.loads(sys.argv[1]):
            r = dryrun.run_cell(arch, shape, mesh_kind, results_dir=tmp)
            out[f"{arch}/{shape}/{mesh_kind}"] = {
                "memory": r["memory_analysis"],
                "coll": r["roofline"]["coll_bytes"]}
    print(json.dumps(out))
""")

REF_COMPILE = textwrap.dedent("""
    import json, math, re, sys
    job = json.loads(sys.argv[1])
    import jax, numpy as np
    # before the dry run's import, which forces 512
    assert len(jax.devices()) == job["devices"], jax.devices()
    from jax.sharding import Mesh
    from repro.analysis import roofline, scancost
    from repro.configs import shapes as rs
    from repro.launch import dryrun
    from repro.models import build_model, moe
    from repro import configs
    rs.SHAPES.clear()
    rs.SHAPES.update({n: rs.ShapeSpec(n, k, t, b)
                      for n, (k, t, b) in job["shapes"].items()})
    axes = tuple(job["axes"])
    tokens = tuple(a for a in axes if a in ("pod", "data"))
    out = {}
    for text in job["meshes"]:
        shape = tuple(int(x) for x in text.split(","))
        mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
        moe.set_ep_sharding("model", tokens, num_groups=math.prod(
            n for a, n in zip(axes, shape) if a in tokens))
        for arch, name in job["mesh_cells"]:
            cfg = configs.get_smoke(arch)
            cell = dryrun.build_cell(cfg, name, mesh)
            with mesh:
                c = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                            out_shardings=cell["out_shardings"],
                            donate_argnums=cell["donate_argnums"]
                            ).lower(*cell["args"]).compile()
            spec = rs.SHAPES[name]
            model = build_model(cfg, attn_impl="xla")
            ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            n = spec.global_batch * (1 if spec.kind == "decode"
                                     else spec.seq_len)
            corr = scancost.corrections(
                cfg, name, mesh, model, ps,
                moe_capacity=dryrun._moe_capacity(cfg, n))
            rep = roofline.analyze(
                c, arch=arch, shape=name, mesh_name=text,
                chips=job["devices"],
                model_flops_value=cell["model_flops"],
                extra_flops=corr["flops"], extra_bytes=corr["bytes"])
            # an MoE decoder's combine: the all-reduce of the float
            # gather (take_along_axis) of the expert outputs onto the
            # tokens, once in the layers' scan body
            combine = sum(
                sum(roofline.collective_bytes(line).values())
                for line in c.as_text().splitlines()
                if "while/body" in line and "take_along_axis" in line
                and re.search(r"=\\s*(f32|bf16)\\[[^=]* all-reduce", line)
            ) * cfg.n_layers if cfg.family == "moe" else 0
            out[f"{text}/{arch}/{name}"] = {
                "arg": c.memory_analysis().argument_size_in_bytes,
                "temp": c.memory_analysis().temp_size_in_bytes,
                "flops": rep.device_flops,
                "coll": rep.coll_bytes + corr.get("coll", 0.0),
                "combine": combine}
    print(json.dumps(out))
""")


def _job():
    return {"shapes": SMOKE_SHAPES, "families": FAMILIES, "meshes": MESHES,
            "mesh_cells": MESH_CELLS, "loop_t": LOOP_T,
            "loop_base": LOOP_BASE, "loop_cells": LOOP_CELLS,
            "mesh3": MESH3, "mesh3_shapes": MESH3_SHAPES,
            "mesh3_cells": MESH3_CELLS, "production": PROD_CELLS}


def _ref_jobs():
    """The reference's compiles: the 2-D cells on 4 forced host devices,
    the 3-D ones on 8."""
    return [{"shapes": SMOKE_SHAPES, "meshes": MESHES,
             "mesh_cells": MESH_CELLS, "devices": 4,
             "axes": ("data", "model")},
            {"shapes": MESH3_SHAPES, "meshes": (MESH3,),
             "mesh_cells": MESH3_CELLS, "devices": 8, "axes": MESH3_AXES}]


def _dot_flops(jaxpr, contracting_only=False) -> int:
    """2 x output elements x contracted size of every ``dot_general``
    (with ``contracting_only``, of those that contract a dim); a scan's
    body times its length, any other sub-jaxpr once."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval.shape
            if lhs_c or not contracting_only:
                total += 2 * math.prod(eqn.outvars[0].aval.shape) * (
                    math.prod(a[i] for i in lhs_c))
        times = eqn.params["length"] if eqn.primitive.name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, Jaxpr):
                    total += times * _dot_flops(sub, contracting_only)
    return total


def _reference_dot_flops():
    """The reference's dot FLOPs of every (family, shape) cell at 1 x 1.
    Its dry-run module forces 512 host devices on import unless JAX has
    started; it is imported after JAX has, and the variable restored."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as r_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from jax.sharding import Mesh

    from repro import configs as r_configs
    from repro.configs import shapes as r_shapes
    from repro.models import ssm as r_ssm

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    saved_shapes = dict(r_shapes.SHAPES)
    r_shapes.SHAPES.clear()
    r_shapes.SHAPES.update({n: r_shapes.ShapeSpec(n, k, t, b)
                            for n, (k, t, b) in SMOKE_SHAPES.items()})
    out = {}
    try:
        for fam, (arch, chunk) in FAMILIES.items():
            r_ssm.MLSTM_CHUNK = chunk
            for shape in SMOKE_SHAPES:
                cell = r_dryrun.build_cell(r_configs.get_smoke(arch), shape,
                                           mesh)
                jaxpr = jax.make_jaxpr(cell["fn"])(*cell["args"]).jaxpr
                out[f"{fam}/{shape}"] = _dot_flops(jaxpr)
                out[f"{fam}/{shape}/contracting"] = _dot_flops(jaxpr, True)
    finally:
        r_ssm.MLSTM_CHUNK = None
        r_shapes.SHAPES.clear()
        r_shapes.SHAPES.update(saved_shapes)
    return out


class _Procs:
    """Subprocesses started side by side, each collected by a thread of
    its own, so that each one's seconds from the launch are its own
    (``seconds``); :meth:`result` waits for one until its
    :data:`TIMEOUT_S` from the launch."""

    def __init__(self, cmds):
        self.started = time.monotonic()
        self.procs, self.out, self.seconds, self.threads = {}, {}, {}, {}
        for name, (argv, env) in cmds.items():
            self.procs[name] = subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            self.threads[name] = threading.Thread(
                target=self._collect, args=(name,), daemon=True)
            self.threads[name].start()

    def _collect(self, name):
        self.out[name] = self.procs[name].communicate()
        self.seconds[name] = time.monotonic() - self.started

    def result(self, name):
        """The JSON of ``name``'s last line; raises if it failed or
        outran its limit."""
        limit = TIMEOUT_S[name.split(":")[0]]
        thread = self.threads[name]
        thread.join(timeout=max(self.started + limit - time.monotonic(), 0))
        if thread.is_alive():
            self.procs[name].kill()
            thread.join()
            raise AssertionError(f"{name}: not done in {limit} s")
        so, se = self.out[name]
        assert self.procs[name].returncode == 0, se[-4000:]
        return json.loads(so.strip().splitlines()[-1])

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()


def _commands():
    """The port's counts (:data:`PARTS`), the reference's compiled cells
    and its production cells, as (argv, env) by process name."""
    job = json.dumps(_job())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmds = {part: ([sys.executable, "-c", PORT, part, job], env)
            for part in PARTS}
    for i, ref in enumerate(_ref_jobs()):
        cmds[f"ref:{i}"] = (
            [sys.executable, "-c", REF_COMPILE, json.dumps(ref)],
            dict(subprocess_env(ref["devices"]), OMP_NUM_THREADS="1"))
    cmds["ref_production"] = (
        [sys.executable, "-c", REF_PRODUCTION, json.dumps(PROD_CELLS)],
        dict(subprocess_env(512), OMP_NUM_THREADS="1"))
    return cmds


@pytest.fixture(scope="module")
def started():
    """Every process of :func:`_commands`, started side by side; each
    fixture below waits for its own, so that one that fails or outruns
    its limit errors only the tests that read it."""
    procs = _Procs(_commands())
    yield procs
    procs.close()


def _merged(procs, *names):
    out = {}
    for name in names:
        out.update(procs.result(name))
    return out


@pytest.fixture(scope="module")
def port_flops(started):
    return _merged(started, "flops:0", "flops:1")


@pytest.fixture(scope="module")
def ref_dots(started):
    """The reference's dot FLOPs, walked here while the processes run."""
    return _reference_dot_flops()


@pytest.fixture(scope="module")
def port_mesh(started):
    return started.result("mesh")


@pytest.fixture(scope="module")
def port_mesh3(started):
    return started.result("mesh3")


@pytest.fixture(scope="module")
def ref_mesh(started):
    return started.result("ref:0")


@pytest.fixture(scope="module")
def ref_mesh3(started):
    return started.result("ref:1")


@pytest.fixture(scope="module")
def port_loops(started):
    return _merged(started, "loops:0", "loops:1")


@pytest.fixture(scope="module")
def port_production(started):
    return started.result("production")


@pytest.fixture(scope="module")
def ref_production(started):
    return started.result("ref_production")


@pytest.fixture
def port_cell(request, key):
    """The port's counts of mesh cell ``key`` (a 3-D one from the
    multi-pod process)."""
    three = key in MESH3_KEYS
    return request.getfixturevalue("port_mesh3" if three else "port_mesh")[key]


@pytest.fixture
def ref_cell(request, key):
    """The reference's compiled figures of mesh cell ``key``."""
    three = key in MESH3_KEYS
    return request.getfixturevalue("ref_mesh3" if three else "ref_mesh")[key]


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_by_one_matmul_flops_equal_reference_dots(port_flops, ref_dots,
                                                     family, shape):
    """Exactly, but for the chunked mLSTM's sequence cells.  There the
    reference's ``jnp.einsum("bhs,bhsk,bhsv->bhkv")`` forms its first
    pair as a ``dot_general`` that contracts nothing (the port's
    ``torch.einsum``, as a multiply): its prefill equals the reference's
    contracting dots exactly.  In training, besides, JAX's scan
    transposes the chunk body by recomputing its forward products in the
    backward scan, where autograd keeps them: 3.1 % fewer FLOPs than
    the reference's contracting dots at these shapes, held within 5 %
    below them."""
    key = f"{family}/{shape}"
    got, dots = port_flops[key], ref_dots[key]
    if family != "xlstm_chunked" or shape == "decode_32k":
        assert got == dots > 0
    elif shape == "prefill_32k":
        assert got == ref_dots[key + "/contracting"] < dots
    else:
        contracting = ref_dots[key + "/contracting"]
        assert 0.95 * contracting <= got < contracting


MESH3_KEYS = [f"{MESH3}/{a}/{s}" for a, s in MESH3_CELLS]
MESH_KEYS = [f"{m}/{a}/{s}" for m in MESHES for a, s in MESH_CELLS] + (
    MESH3_KEYS)


@pytest.mark.parametrize("key", MESH_KEYS)
def test_argument_bytes_equal_reference_compiled(port_cell, ref_cell, key):
    got = port_cell["memory"]["argument_size_in_bytes"]
    assert got == ref_cell["arg"] > 0


@pytest.mark.parametrize("key", MESH_KEYS)
def test_flops_and_collectives_within_bounds_of_reference(port_cell,
                                                          ref_cell, key):
    """FLOPs and collective bytes a device against the reference's.  An
    MoE decoder's combine is held apart: the port reduces the (G, N, d)
    sum of the expert outputs once, after the top-k sum, reduce-scattered
    onto d, where GSPMD all-reduces the gather of all k rows (G, N k, d)
    -- k times the rows and n times the result bytes on a model axis of
    n (olmoe's (1, 4) prefill: 4,096 B a layer against 32,768).  So the
    combine must move fewer bytes than GSPMD's, and the rest of the cell
    is held to the bounds."""
    mine, ref = port_cell, ref_cell
    lo, hi = FLOPS_RATIO
    assert lo <= mine["flops"] / ref["flops"] <= hi
    lo, hi = DECODE_COLL_RATIO if "decode" in key else COLL_RATIO
    got, want = sum(mine["collectives"].values()), ref["coll"]
    if ref["combine"]:
        assert 0 < mine["combine"] < ref["combine"]
        got, want = got - mine["combine"], want - ref["combine"]
    assert lo <= got / want <= hi


@pytest.mark.parametrize("key", MESH_KEYS)
def test_temporaries_within_bounds_of_reference_compiled(port_cell, ref_cell,
                                                         key):
    """The port's peak of live bytes above the arguments against the
    reference's compiled ``temp_size_in_bytes``, within
    :data:`TEMP_RATIO`."""
    got = port_cell["memory"]["temp_size_in_bytes"]
    lo, hi = TEMP_RATIO
    assert lo <= got / ref_cell["temp"] <= hi


def _prod(port_production, ref_production, arch, shape, mesh_kind="single"):
    key = f"{arch}/{shape}/{mesh_kind}"
    got = port_production[key]
    assert got["status"] == "ok", got["error"]
    return got, ref_production[key]


@pytest.mark.parametrize("arch,mesh_kind", PROD_SPLIT)
def test_production_train_cell_splits_attention_and_mlp(
        port_production, ref_production, arch, mesh_kind):
    """``train_4k`` at published widths where the model axis of 16 does
    not divide the heads (qwen3-14b: 40 over 8 KV heads; qwen2-7b: 28
    over 4) or meets q, k and v as partial sums it cannot split by KV
    head (internlm2-1.8b on the multi-pod mesh: 8 KV heads, 8 rows a
    rank): every rank attends its share, by heads (one KV head picked
    for each rank's q heads) or by rows, where it attended all heads of
    all its rows; and on the multi-pod mesh the MLP's products keep the
    work split where their input is a partial sum (the whole (8, 4,096,
    8,192) hidden was every rank's).  The temporaries no more than the
    reference's compiled ones (the multi-pod cell's within
    :data:`MULTIPOD_TEMP_RATIO` of them), and the multi-pod cell's FLOPs
    a device at most :data:`MULTIPOD_FLOPS_SHARE` of the single-pod
    cell's, whose rows a rank are twice as many."""
    got, ref = _prod(port_production, ref_production, arch, "train_4k",
                     mesh_kind)
    temp = got["memory_analysis"]["temp_size_in_bytes"]
    want = ref["memory"]["temp_size_in_bytes"]
    if mesh_kind == "multipod":
        assert temp <= MULTIPOD_TEMP_RATIO * want
        single, _ = _prod(port_production, ref_production, arch,
                          "train_4k")
        assert got["flops"] <= MULTIPOD_FLOPS_SHARE * single["flops"]
    else:
        assert temp <= want


#: the train cells held to no whole-vocab tensor at their peak: PROD_TRAIN's
#: on the 16 x 16 mesh, and internlm2's on the multi-pod mesh (8 rows a
#: rank under a model axis of 16)
NO_VOCAB_CELLS = [pytest.param(a, "single", id=a) for a in PROD_TRAIN] + [
    pytest.param("internlm2-1.8b", "multipod", id="internlm2-1.8b-multipod")]


@pytest.mark.parametrize("arch,mesh_kind", NO_VOCAB_CELLS)
def test_production_train_cell_holds_no_whole_vocab(port_production,
                                                    ref_production, arch,
                                                    mesh_kind):
    """``train_4k`` at published widths on the 16 x 16 mesh, and
    internlm2's on the 2 x 16 x 16 mesh: the logits leave the head split
    on V (or, a partial sum, are reduce-scattered onto V before the
    loss reads them) and the loss picks its labels by a masked sum, so
    no tensor with the whole vocab as its last dim is among the largest
    live at the peak (it was the label gather's backward: a zeros of the
    global (256, 4,096, V) logits).  The MoE dispatch
    buffer and the expert outputs are split as the reference constrains
    them, so no tensor at the peak holds as many elements as the global
    tokens (256 x 4,096 x d): it was the combine gather's backward, a
    zeros of the global (G, E C, d) buffer, 40 GiB.  The temporaries
    within 2x the reference's compiled ones, and arguments plus
    temporaries within the H100's 80 GiB."""
    from repro_torch.configs import shapes

    got, ref = _prod(port_production, ref_production, arch, "train_4k",
                     mesh_kind)
    # the loss reads the logits split on V over ``model``, never partial
    assert got["logits"] and all(read[-1] == "S2" and "P" not in read
                                 for _, read in got["logits"]), got["logits"]
    assert all(shape[-1] != got["vocab"]
               for _, shape, _, _ in got["peak_temporaries"])
    spec = shapes.SHAPES["train_4k"]
    tokens = spec.global_batch * spec.seq_len * got["d_model"]
    assert all(math.prod(shape) < tokens
               for _, shape, _, _ in got["peak_temporaries"])
    mem = got["memory_analysis"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < (
        HBM_BYTES)
    assert mem["temp_size_in_bytes"] <= 2 * ref["memory"][
        "temp_size_in_bytes"]


def test_multipod_train_cell_builds_rope_tables_once(port_production,
                                                   ref_production):
    """internlm2's ``train_4k`` on the 2 x 16 x 16 mesh: RoPE's angle
    tables are built from the positions every row shares, (1, 4,096) --
    not one a row of the global batch of 256 on every rank, three
    (256, 1, 4,096, 64) float32 tables of 256 MiB among the largest
    temporaries at the peak (ROADMAP fault 33)."""
    from repro_torch import configs
    from repro_torch.configs import shapes

    got, _ = _prod(port_production, ref_production, "internlm2-1.8b",
                   "train_4k", "multipod")
    spec, cfg = shapes.SHAPES["train_4k"], configs.get("internlm2-1.8b")
    table = (spec.seq_len, cfg.hd // 2)
    assert not [shape for _, shape, _, _ in got["peak_temporaries"]
                if len(shape) > 2 and shape[0] == spec.global_batch
                and tuple(shape[-2:]) == table], got["peak_temporaries"]


@pytest.mark.parametrize("arch", PROD_PREFILL)
def test_production_prefill_cell_attends_by_kv_head(port_production,
                                                    ref_production, arch):
    """``prefill_32k`` at published widths on the 16 x 16 mesh, olmoe's
    cache split by layer (its 16 layers number its 16 KV heads): every
    rank attends each layer on its own KV head, where the rank holding
    the layer scored all 16 heads' (T, T) (324 GiB); xlstm-125m's
    recurrences on each rank's own part of the state (its forget gate
    ran on the global batch: 15.22 GiB against the reference's 0.86).
    So the temporaries stay within 2x the reference's compiled ones and
    the total within the H100's 80 GiB."""
    got, ref = _prod(port_production, ref_production, arch, "prefill_32k")
    mem = got["memory_analysis"]
    assert mem["temp_size_in_bytes"] <= 2 * ref["memory"][
        "temp_size_in_bytes"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < (
        HBM_BYTES)


@pytest.mark.parametrize("arch", PROD_DECODE)
def test_production_decode_collectives_within_10x_of_reference(
        port_production, ref_production, arch):
    """``decode_32k`` at published widths on the 16 x 16 mesh: no cache
    leaf and no parameter gathered (the port gathered 16.9-550 GB a
    step), so its collective bytes stay within 10x (:data:`DECODE_COLL_RATIO`)
    of the reference's compiled ones (10.07-8,600 MB)."""
    got, ref = _prod(port_production, ref_production, arch, "decode_32k")
    assert 0 < got["coll"] <= DECODE_COLL_RATIO[1] * ref["coll"]


def _pinned(table):
    """This torch's entry of a table keyed by torch version; a version
    the table does not pin is skipped, with the versions it does."""
    import torch

    version = ".".join(torch.__version__.split(".")[:2])
    if version not in table:
        pytest.skip(f"counts pinned for torch {', '.join(table)} only, "
                    f"this is {torch.__version__}")
    return table[version]


@pytest.mark.parametrize("key", MESH_KEYS)
def test_collectives_by_kind_equal_this_torch_count(port_cell, key):
    """Exactly what this torch's DTensor issues for rank 0
    (:data:`MESH_COLL`): a collective booked under the wrong kind,
    counted twice or missed changes the count."""
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    want = dict(zip(kinds, _pinned(MESH_COLL)[key]))
    assert port_cell["collectives"] == want


@pytest.mark.parametrize("key", MESH3_KEYS)
def test_no_activation_of_a_3d_cell_is_strided(port_cell, key):
    """No DTensor op of the step reads an input placed ``_StridedShard``
    (``dryrun.Meter.strided``): DTensor plans such a placement's
    redistributions by a graph search, which held three multi-pod cells
    past the sweep's budget.  The view rule of ``distributed.rules``
    moves the split a flatten would make strided to a kept dim."""
    assert port_cell["strided_ops"] == 0


def test_sharded_cells_split_the_work(port_mesh, port_flops):
    """Per device, a (2, 2) or (1, 4) train cell computes less than the
    whole model does at 1 x 1, and memory is that of one rank."""
    for text in MESHES:
        c = port_mesh[f"{text}/internlm2-1.8b/train_4k"]
        assert 0 < c["flops"] < port_flops["dense/train_4k"]
        m = c["memory"]
        assert m["alias_size_in_bytes"] <= m["output_size_in_bytes"]
        assert m["temp_size_in_bytes"] > 0


def test_dense_block_collectives_equal_hand_count(port_mesh):
    """One dense block's forward (smoke internlm2, float32, swiglu) on a
    (1, 2) mesh, x replicated.  Attention is local (Megatron's column
    and row split, heads divide); ``wo``'s output is a partial sum.

    torch 2.11's DTensor moves Megatron's two all-reduces of B T d f32:
    ``wo``'s and the down projection's partial outputs.

    torch 2.13's keeps ``wo``'s partial sum through the residual add and
    into ``ln2``:

    * all-reduce: ``ln2`` reads the partial residual twice (its mean
      square and its product; DTensor keeps no reduced copy), B T d f32
      each, and SwiGLU's ``silu`` the partial gate output, B T ff f32;
    * all-gather: ``ln2``'s output is partial too, so the gate's and
      the up projection's weights come whole, d ff f32 each;
    * reduce-scatter: the partial ``h`` to the down projection's rows,
      B T ff / 2 f32."""
    b = port_mesh["block"]
    B, T, d, ff = b["B"], b["T"], b["d"], b["ff"]
    by_version = {
        "2.11": (4 * 2 * B * T * d, 0, 0),
        "2.13": (4 * (2 * B * T * d + B * T * ff), 4 * 2 * d * ff,
                 4 * B * T * ff // 2),
    }
    reduce, gather, scatter = _pinned(by_version)
    assert b["coll"] == {
        "all-reduce": reduce,
        "all-gather": gather,
        "reduce-scatter": scatter,
        "all-to-all": 0,
        "collective-permute": 0,
    }


@pytest.mark.parametrize("cell", [f"{a}/{s}/{c}" for a, s, c in LOOP_CELLS])
def test_loop_composition_equals_the_whole_loop(port_loops, cell):
    """FLOPs and collective bytes exactly (their check holds); bytes and
    memory, which no polynomial in T gives (``scancost``), within
    :data:`MODELLED_REL` of the whole run at these lengths."""
    r = port_loops[cell]
    assert max(r["lengths"]) < LOOP_T
    assert r["check"]["flops"] and all(
        v for k, v in r["check"].items() if k.startswith("coll/"))
    got, want = r["composed"], r["whole"]
    assert got["flops"] == want["flops"] > 0
    assert got["coll"] == want["coll"]
    assert abs(got["bytes"] - want["bytes"]) <= MODELLED_REL * want["bytes"]
    for k, v in want["memory"].items():
        assert abs(got["memory"][k] - v) <= MODELLED_REL * v, k


def test_ruled_skips_equal_reference():
    from repro import configs as r_configs
    from repro.configs import shapes as r_shapes
    from repro_torch import configs
    from repro_torch.configs import shapes

    assert list(shapes.SHAPES) == list(r_shapes.SHAPES)
    skipped = 0
    for arch in configs.ARCH_IDS:
        for name in shapes.SHAPES:
            got = shapes.applicable(configs.get(arch), name)
            assert got == r_shapes.applicable(r_configs.get(arch), name)
            skipped += got is not None
    assert skipped == 8


@pytest.fixture
def bf16_reduce():
    from repro.models import layers as r_layers
    from repro_torch.models import layers

    yield r_layers, layers
    r_layers.REDUCE_IN_COMPUTE_DTYPE = False
    layers.REDUCE_IN_COMPUTE_DTYPE = False


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_bf16_reduce_forward_within_phase5_bounds(bf16_reduce, arch):
    """The smoke model in bfloat16 with ``REDUCE_IN_COMPUTE_DTYPE`` in
    both packages (the reference's CPU runs bf16 x bf16 = bf16 products,
    not bf16 x bf16 = f32 ones): max |diff| within 5 % of max |logits|,
    argmax agreement at least 90 % (phase 5's bounds)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as r_configs
    from repro.models import build_model as r_build
    from repro_torch import configs
    from repro_torch.models import build_model, params_from_jax

    r_layers, layers = bf16_reduce
    r_layers.REDUCE_IN_COMPUTE_DTYPE = layers.REDUCE_IN_COMPUTE_DTYPE = True
    r_cfg = dataclasses.replace(r_configs.get_smoke(arch),
                                compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype="bfloat16")
    r_model = r_build(r_cfg, attn_impl="xla")
    params = r_model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(r_model.forward(params, {"tokens": jnp.asarray(tokens)}),
                      dtype=np.float32)
    model = build_model(cfg, attn_impl="xla", device="cpu")
    got = model.forward(params_from_jax(cfg, params, device="cpu"),
                        {"tokens": torch.as_tensor(tokens)}).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_bf16_reduce_products_leave_in_the_compute_dtype(bf16_reduce):
    import torch

    _, layers = bf16_reduce
    p = {"w": torch.ones(8, 4, dtype=torch.bfloat16),
         "b": torch.zeros(4, dtype=torch.bfloat16)}
    x = torch.ones(2, 8, dtype=torch.bfloat16)
    assert layers.matmul_acc(x, p["w"]).dtype == torch.float32
    layers.REDUCE_IN_COMPUTE_DTYPE = True
    assert layers.matmul_acc(x, p["w"]).dtype == torch.bfloat16
    assert layers.dense_apply(p, x, "bfloat16").dtype == torch.bfloat16


def test_meter_refuses_a_torch_without_its_patch_points(monkeypatch):
    """A DTensor internal the meter replaces is missing: entering it
    raises with the torch version, and leaves no other patch behind."""
    import re

    import torch
    from torch.distributed.tensor import _sharding_prop, placement_types

    from repro_torch.launch import dryrun

    prop = _sharding_prop.ShardingPropagator
    before = prop.__dict__["_propagate_tensor_meta_non_cached"]
    monkeypatch.delattr(placement_types, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
        with dryrun.Meter():
            pass
    assert prop.__dict__["_propagate_tensor_meta_non_cached"] is before
