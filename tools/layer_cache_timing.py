"""Time decode on a KV cache split by layer, both ways, across four gloo
ranks on the CPU; or price both ways with the dry run's roofline.

``distributed.rules.split_cache_attention`` attends a layer of a cache
split by layer on every rank's own KV heads where they divide over the
ranks (``heads``), else on the rank that holds the layer alone
(``serial``).  This tool takes ``serial`` where the heads divide by
replacing the private ``rules._by_heads`` in its own processes.

The timing: olmoe's smoke config with its depth raised from 2 to 4
layers, so that the layers number the KV heads (4) and the reference's
cache rule (``sharding.cache_specs``) splits the stacked cache by layer
over ``model``.  On each mesh, (1, 4) and (2, 2), a batch of 8 prefills
16 tokens into a 64-slot cache, then decodes 16 steps, under each mode
in turn (``heads``, ``serial``, ``heads``, ``serial``, ... for
``--repeats`` rounds, after one untimed warm-up of each).  Prints, per
mesh and mode, the median and range of the 16 steps' wall seconds on
rank 0 (between barriers), and the largest difference of the two
modes' logits over the largest logit.

With ``--dryrun``: olmoe-1b-7b's ``decode_32k`` on the single-pod
16 x 16 mesh (``launch.dryrun.run_cell``, attention ``xla``) under each
mode: rank 0's roofline terms (compute, memory and collective seconds
from datasheet constants) and its collective bytes; and, since the
roofline prices one rank while ``serial`` runs the layers' attention
one holder after another, the time the holders take to read their
layers' cache slices in turn (layers x one slice / the HBM rate)
against the time ``heads`` takes to move each slice over a link
(layers x one slice / the link rate).

  PYTHONPATH=src python tools/layer_cache_timing.py [--repeats 5]
  PYTHONPATH=src python tools/layer_cache_timing.py --dryrun
"""
import argparse
import dataclasses
import datetime
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

MESHES = ((1, 4), (2, 2))
MODES = ("heads", "serial")
B, PROMPT, SLOTS, STEPS = 8, 16, 64, 16


def _run(model, params, cache, tokens):
    """Prefill, then STEPS decode steps: their logits and the decode's
    wall seconds (between barriers)."""
    logits, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]},
                                  cache)
    out = [logits]
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(STEPS):
        logits, cache = model.decode_step(params, tokens[:, PROMPT + i],
                                          cache, PROMPT + i)
        out.append(logits)
    dist.barrier()
    return out, time.perf_counter() - t0


def _attend(mode):
    """Take ``mode``'s path in ``rules.split_cache_attention`` in this
    process."""
    from repro_torch.distributed import rules

    if not hasattr(rules, "_by_heads_default"):
        rules._by_heads_default = rules._by_heads
    rules._by_heads = (rules._by_heads_default if mode == "heads"
                       else lambda hq, hkv, ranks: False)


def _dryrun():
    """Print the dry run's roofline terms of olmoe-1b-7b's decode_32k
    under each mode, and the serialized read against the moved slices."""
    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun

    arch, shape = "olmoe-1b-7b", "decode_32k"
    cfg, spec = configs.get(arch), shapes.SHAPES[shape]
    mesh = dryrun.MESHES["single"]
    data, model = mesh.shape
    # one layer's K and V on its holder: the batch over data, whole else
    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    slice_bytes = (2 * spec.global_batch // data * spec.seq_len
                   * cfg.n_kv_heads * cfg.hd * item)
    print(f"{arch} {shape} on {mesh.shape}: a layer's cache slice "
          f"{slice_bytes / 1e6:.1f} MB on its holder, {cfg.n_layers} "
          f"layers; HBM {roofline.HBM_BW / 1e9:.0f} GB/s, link "
          f"{roofline.ICI_LINK_BW / 1e9:.0f} GB/s")
    with tempfile.TemporaryDirectory() as tmp:
        for mode in MODES:
            _attend(mode)
            r = dryrun.run_cell(arch, shape, "single", results_dir=tmp)
            assert r["status"] == "ok", r.get("error")
            t = r["roofline"]
            print(f"  {mode:6s} rank 0: compute {t['t_compute']:.6f} s, "
                  f"memory {t['t_memory']:.6f} s, collective "
                  f"{t['t_collective']:.6f} s "
                  f"({t['coll_bytes'] / 1e6:.1f} MB), bound {t['bottleneck']}")
    _attend("heads")
    print(f"  serial: the holders read {cfg.n_layers} slices in turn, "
          f"{cfg.n_layers * slice_bytes / roofline.HBM_BW:.6f} s a step; "
          f"heads: {cfg.n_layers} slices over a link, "
          f"{cfg.n_layers * slice_bytes * (model - 1) / model / roofline.ICI_LINK_BW:.6f}"
          f" s, then a sixteenth of each read, "
          f"{slice_bytes / roofline.HBM_BW:.6f} s")


def _rank(rank, world, store_path, repeats):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600))
    cfg = dataclasses.replace(configs.get_smoke("olmoe-1b-7b"), n_layers=4)
    model = build_model(cfg, attn_impl="xla", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT + STEPS),
                           generator=torch.Generator().manual_seed(1))
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        placed = sharding.place(params, sharding.param_shardings(params, mesh),
                                mesh)
        pl = sharding.cache_shardings(model.init_cache(B, SLOTS), cfg, mesh,
                                      batch=B)
        times = {m: [] for m in MODES}
        logits = {}
        for r in range(repeats + 1):
            for mode in MODES:
                _attend(mode)
                cache = sharding.place(model.init_cache(B, SLOTS), pl, mesh)
                with torch.no_grad(), implicit_replication():
                    out, secs = _run(model, placed, cache, tokens)
                if r:
                    times[mode].append(secs)
                logits[mode] = [x.full_tensor() if isinstance(x, DTensor)
                                else x for x in out]
        _attend("heads")
        if rank == 0:
            diff = max((a - b).abs().max().item() / b.abs().max().item()
                       for a, b in zip(logits["heads"], logits["serial"]))
            split = [str(p) for p in pl["k"]]
            print(f"mesh {shape}: cache {split}, {STEPS} decode steps of "
                  f"batch {B} (olmoe smoke, 4 layers); heads vs serial "
                  f"logits max|diff|/max {diff:.3g}")
            for mode in MODES:
                t = times[mode]
                print(f"  {mode:6s} median {statistics.median(t):.4f} s "
                      f"(min {min(t):.4f}, max {max(t):.4f}) over "
                      f"{len(t)} runs", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dryrun", action="store_true",
                    help="price both modes with the dry run instead")
    args = ap.parse_args(argv)
    if args.dryrun:
        _dryrun()
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(4, os.path.join(tmp, "store"),
                                        args.repeats),
                           nprocs=4, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
