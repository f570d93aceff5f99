"""Run the dry run's sweep (every arch's four shapes on the single-pod
and the multi-pod mesh, ``python -m repro_torch.launch.dryrun --arch A
--mesh M``, one process each, ``--jobs`` at a time) from a source tree,
and print each cell's arguments and temporaries (GiB), FLOPs a device
and collective bytes (GB); with ``--against DIR``, each against another
sweep's records, flagging a cell worse by more than 2 % in any of
them.  Ends with the count of ok, skipped and error cells and of cells
that read a strided input, by mesh.

  PYTHONPATH=src python tools/dryrun_sweep.py --out /tmp/sweep [--src SRC]
      [--jobs 4] [--against /tmp/parent_sweep]
  python tools/dryrun_sweep.py --out /tmp/sweep --no-run --against ...
"""
import argparse
import concurrent.futures
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("whisper-tiny", "command-r-plus-104b", "internlm2-1.8b",
         "qwen3-14b", "qwen2-7b", "dbrx-132b", "olmoe-1b-7b", "xlstm-125m",
         "jamba-1.5-large-398b", "chameleon-34b")
MESHES = ("single", "multipod")
#: a cell worse than the other sweep's by more than this share is flagged
WORSE = 1.02


def _run(src, out, arch, mesh):
    env = dict(os.environ, PYTHONPATH=src)
    with open(os.path.join(out, f"log_{arch}_{mesh}.txt"), "w") as log:
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", mesh, "--results", out], env=env, stdout=log,
            stderr=subprocess.STDOUT).returncode


def _records(out):
    recs = {}
    for path in glob.glob(os.path.join(out, "*__*__*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _terms(r):
    m, ro = r["memory_analysis"], r["roofline"]
    return (m["argument_size_in_bytes"] / 2 ** 30,
            m["temp_size_in_bytes"] / 2 ** 30, ro["device_flops"],
            ro["coll_bytes"] / 1e9)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--against", default=None)
    ap.add_argument("--no-run", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if not args.no_run:
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(lambda am: _run(os.path.abspath(args.src),
                                          args.out, *am),
                          [(a, m) for m in MESHES for a in ARCHS]))
    recs = _records(args.out)
    other = _records(args.against) if args.against else {}
    counts = {m: {"ok": 0, "skipped": 0, "error": 0, "strided": 0}
              for m in MESHES}
    worse = 0
    for key in sorted(recs):
        r = recs[key]
        counts[key[2]][r["status"]] += 1
        counts[key[2]]["strided"] += bool(r.get("strided_ops"))
        name = "/".join(key)
        if r["status"] != "ok":
            print(f"{name:<45} {r['status']} {r.get('error', '')[:200]}")
            continue
        arg, tmp, flops, coll = _terms(r)
        line = (f"{name:<45} {arg:.2f}+{tmp:.2f} GiB  flops {flops:.4g}  "
                f"coll {coll:.4g} GB")
        o = other.get(key)
        if o is not None and o["status"] == "ok":
            _, otmp, oflops, ocoll = _terms(o)
            bad = [n for n, a, b in (("tmp", tmp, otmp),
                                     ("flops", flops, oflops),
                                     ("coll", coll, ocoll))
                   if a > WORSE * b]
            worse += bool(bad)
            line += (f"  | against {otmp:.2f} GiB, {oflops:.4g}, "
                     f"{ocoll:.4g} GB" + (f"  WORSE {bad}" if bad else ""))
        print(line)
    print(json.dumps({"counts": counts, "worse": worse}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
