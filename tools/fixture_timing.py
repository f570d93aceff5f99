"""Time the subprocesses behind the module fixtures of
``tests/test_torch_distributed.py`` (``worlds``) and
``tests/test_torch_dryrun.py`` (``dryrun``) on the CPU, idle or beside
busy processes, against the limits the tests give them.

``worlds``: starts the test module's worlds as its fixture does (every
part side by side, the reference's files written meanwhile in their
order), and prints, per part, the seconds from launch to its last input
file (``inputs``) and from then to its end (``run``) beside its deadline
(``tests/torch_dist_worker.DEADLINE_S``, counted from its inputs), and
the second at which each reference file was written.

``dryrun``: starts the test module's processes side by side and prints
each one's seconds from the launch beside its limit (``TIMEOUT_S``),
and the seconds of the reference's dot FLOPs walked meanwhile.

With ``--busy N``, N processes spin on the CPU for the whole run (the
load of a tier-1 run's other test workers); they are stopped at the end.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fixture_timing.py worlds [--busy 8]
  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fixture_timing.py dryrun [--busy 8]
"""
import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "tests"),
                os.path.join(HERE, "..", "src")]


def _spin():
    while True:
        pass


def _worlds() -> dict:
    import test_torch_distributed as t
    import torch_dist_worker as worker

    out = {"parts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        w = t._Worlds(tmp)
        out["written"] = {n: round(s - w.started, 1)
                          for n, s in w.written.items()}
        out["failed"] = w.failed
        for part in t.PARTS:
            try:
                sec = w.result(part)["seconds"]
                out["parts"][part] = {k: round(v, 1) for k, v in sec.items()}
            except BaseException as e:   # noqa: BLE001 -- reported
                out["parts"][part] = {"error": repr(e)[-400:]}
            out["parts"][part]["deadline"] = worker.DEADLINE_S[part]
        w.close()
        out["total"] = round(time.monotonic() - w.started, 1)
    return out


def _dryrun() -> dict:
    import test_torch_dryrun as t

    out = {"parts": {}}
    procs = t._Procs(t._commands())
    try:
        start = time.monotonic()
        t._reference_dot_flops()
        out["dots"] = round(time.monotonic() - start, 1)
        for name in procs.procs:
            try:
                procs.result(name)
                out["parts"][name] = {"seconds": round(procs.seconds[name], 1)}
            except BaseException as e:   # noqa: BLE001 -- reported
                out["parts"][name] = {"error": repr(e)[-400:]}
            out["parts"][name]["limit"] = t.TIMEOUT_S[name.split(":")[0]]
        out["total"] = round(time.monotonic() - procs.started, 1)
    finally:
        procs.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("fixture", choices=("worlds", "dryrun"))
    ap.add_argument("--busy", type=int, default=0,
                    help="processes spinning on the CPU meanwhile")
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    busy = [ctx.Process(target=_spin, daemon=True) for _ in range(args.busy)]
    for p in busy:
        p.start()
    try:
        out = _worlds() if args.fixture == "worlds" else _dryrun()
    finally:
        for p in busy:
            p.kill()
            p.join()
    out["busy"] = args.busy
    print(json.dumps(out, indent=1))
    return 0 if all("error" not in r for r in out["parts"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
