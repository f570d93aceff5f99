"""Two training ranks on one CUDA card: the smoke internlm2-1.8b
(float32) over a (1, 2) ``DeviceMesh`` of two ``gloo`` processes on
cuda:0.  NCCL takes one rank a device, so on a one-card machine gloo,
which moves the card's tensors through the host, is the only way to run
the sharded step across ranks.  Prints what happened: the two-rank loss
against one rank's and the collectives' time, or the error that stopped
it (a rank that dies is named with its stage and frames).  Exits 0
either way: this records an outcome, it checks nothing.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/gloo_probe.py
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

ARCH = "internlm2-1.8b"
#: the smoke step's batch (as ``chip_smoke.py``'s card-vs-CPU step)
BATCH, SEQ_LEN = 2, 128
#: a probe not done by then is stopped
TIMEOUT_S = 150


def _gloo_probe_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the probe (see :func:`probe`)."""
    import datetime
    import faulthandler
    import traceback

    import torch
    import torch.distributed as dist

    out_dir = pathlib.Path(out_dir)
    fault = open(out_dir / f"rank{rank}.fault", "w")
    faulthandler.enable(file=fault)

    def stage(name):   # what the rank was doing, should it die
        (out_dir / f"rank{rank}.stage").write_text(name)

    out = {}
    try:
        stage("init_process_group")
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, 2), rank=rank,
            world_size=2,
            timeout=datetime.timedelta(seconds=TIMEOUT_S - 30))
        from repro_torch import configs
        from repro_torch.data import TokenStream
        from repro_torch.distributed import sharding
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime.train import init_train_state, make_train_step

        dev = torch.device("cuda", 0)
        cfg = configs.get_smoke(ARCH)
        stage("unsharded step")
        model = build_model(cfg, device=dev)
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
            vocab=cfg.vocab, batch=BATCH, seq_len=SEQ_LEN,
            seed=0).batch_at(0).items()}
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        _, m1 = step(init_train_state(model, gen()), batch)
        out["loss_one_rank"] = m1["loss"].item()
        stage("make_local_mesh")
        mesh = make_local_mesh(2, device=dev)
        stage("distribute_state")
        state = sharding.distribute_state(init_train_state(model, gen()), mesh)
        dbatch = sharding.distribute_batch(batch, mesh)
        stage("sharded step")
        state, m2 = step(state, dbatch)
        out["loss_two_ranks"] = m2["loss"].item()
        keys = ("gloo", "all_reduce", "allreduce", "all_gather", "allgather",
                "reduce_scatter", "broadcast")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            state, m3 = step(state, dbatch)
            m3["loss"].item()
            out["step_s"] = time.perf_counter() - t
        stage("profile")
        coll = [e for e in prof.key_averages()
                if any(k in e.key.lower() for k in keys)]
        out["collective_s"] = sum(e.self_cpu_time_total for e in coll) / 1e6
        out["collectives"] = {e.key: e.count for e in coll}
        dist.destroy_process_group()
    except Exception as e:  # a probe: record what stopped it
        out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        out["trace"] = traceback.format_exc()[-2000:]
    with open(out_dir / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def probe() -> dict:
    """Rank 0's loss against its one-rank step, a step's seconds and the
    gloo collectives' host time in it (``torch.profiler``); or the error
    that stopped a rank, with where it was.  A probe that hangs is
    stopped."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _gloo_probe_rank, args=(str(pathlib.Path(tmp) / "store"), tmp),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        out = {}
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    out["error"] = (f"timed out after {TIMEOUT_S} "
                                    "s")
                    break
        except Exception as e:
            out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [json.load(open(f)) for f in sorted(
            pathlib.Path(tmp).glob("rank*.json"))]
        if out.get("error") and len(ranks) < 2:   # a rank died: where
            for r in range(2):
                st = pathlib.Path(tmp) / f"rank{r}.stage"
                fl = pathlib.Path(tmp) / f"rank{r}.fault"
                frames = [ln.strip() for ln in (fl.read_text().splitlines()
                                                if fl.exists() else [])
                          if ln.strip().startswith("File")][:16]
                out[f"rank{r}_stage"] = st.read_text() if st.exists() else None
                out[f"rank{r}_frames"] = frames
            out["error"] += (f" (rank 0 in {out['rank0_stage']}: "
                             f"{' <- '.join(out['rank0_frames'][:8])})")
    for r in ranks:
        out.setdefault("error", r.get("error"))
    if ranks and "loss_two_ranks" in ranks[0]:
        out.update({k: ranks[0][k] for k in ranks[0] if k != "trace"})
    if out.get("error"):
        print(f"  two ranks on cuda:0 (gloo, smoke, (1, 2) mesh): not run -- "
              f"{out['error']}")
    else:
        out.pop("error", None)
        print(f"  two ranks on cuda:0 (gloo, smoke, (1, 2) mesh): loss "
              f"{out['loss_two_ranks']:.6f} vs one rank "
              f"{out['loss_one_rank']:.6f}; a step {out['step_s']:.3f} s, "
              f"gloo collectives {out['collective_s']:.3f} s of it "
              f"({sum(out['collectives'].values())} calls)")
    return out


if __name__ == "__main__":
    print(json.dumps(probe(), default=str))
