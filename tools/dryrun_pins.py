"""Print this torch's entry of ``MESH_COLL`` in
``tests/test_torch_dryrun.py``: the collective result bytes by kind
(all-reduce, all-gather, reduce-scatter, all-to-all, collective-permute)
that DTensor issues for rank 0 in each smoke mesh cell of the test, and
which of them differ from the entry pinned for this torch, if any.

Runs the test module's port side (``PORT``, parts ``mesh`` and
``mesh3``) in subprocesses, as its fixture does; no JAX.

  PYTHONPATH=src python tools/dryrun_pins.py
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "tests"),
                os.path.join(HERE, "..", "src")]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def main() -> int:
    import torch

    import test_torch_dryrun as t

    job = json.dumps(t._job())
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", t.PORT, part, job],
                              env=env, stdout=subprocess.PIPE, text=True)
             for part in ("mesh", "mesh3")]
    got = {}
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        if p.returncode:
            return p.returncode
        got.update(json.loads(out.strip().splitlines()[-1]))
    version = ".".join(torch.__version__.split(".")[:2])
    pinned = t.MESH_COLL.get(version, {})
    print(f'"{version}": {{')
    for key in t.MESH_KEYS:
        row = tuple(got[key]["collectives"][k] for k in KINDS)
        mark = "" if pinned.get(key) == row else "   # differs"
        print(f'    "{key}": {row},{mark}')
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
