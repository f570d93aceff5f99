"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Every ``*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` -- one
``nvcc`` process per source, all started together -- and linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the sources and flags, so a stale build is never
loaded.  Nothing is built when this module is imported: the first
:func:`library` call builds (or finds) the library.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Iterator, List, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (
    pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
)
SOURCES = (
    "helmholtz.cu", "gemm_chain.cu", "flash_attention.cu",
    "flash_attention_sm90.cu", "flash_attention_bwd.cu",
    "flash_attention_bwd_sm90.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas register/shared-memory reports)
build_log: List[str] = []
#: wall seconds the last build took (0.0 when the library was cached)
build_seconds = 0.0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  A library built from the same sources is reused."""
    global build_seconds
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    build_log.clear()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = pathlib.Path(tmp) / (pathlib.Path(src).stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            build_log.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(build_log)
            )
        staged = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *objs, "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)  # atomic: a reader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_helmholtz.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.repro_helmholtz.restype = ci
        lib.repro_helmholtz_tile.argtypes = [ci, ci, ci, vp]
        lib.repro_helmholtz_tile.restype = ci
        lib.repro_gemm_chain_tile.argtypes = [vp, ci, ci, vp]
        lib.repro_gemm_chain_tile.restype = ci
        lib.repro_gemm_chain.argtypes = [vp, ci, ci, ci, vp]
        lib.repro_gemm_chain.restype = ci
        lib.repro_gemm_chain_limits.argtypes = [vp]
        lib.repro_gemm_chain_limits.restype = ci
        cf = ctypes.c_float
        lib.repro_flash_attention.argtypes = [
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, ci, ci, ci, vp]
        lib.repro_flash_attention.restype = ci
        lib.repro_flash_attention_sm90.argtypes = [
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, ci, ci, vp]
        lib.repro_flash_attention_sm90.restype = ci
        lib.repro_flash_attention_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
            ci, cf, ci, vp]
        lib.repro_flash_attention_bwd.restype = ci
        lib.repro_flash_attention_bwd_sm90.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
            ci, cf, vp]
        lib.repro_flash_attention_bwd_sm90.restype = ci
        lib.repro_cuda_error_string.argtypes = [ci]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch --
    too much shared memory, a bad configuration -- never runs, and a
    later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    """The kernels' storage dtype code (0 float32, 1 bfloat16)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels store float32 or bfloat16, got {dtype}")
    return codes[dtype]


@contextlib.contextmanager
def launch_on(device) -> Iterator[ctypes.c_void_p]:
    """The device guard of every launch: ``device`` (the tensors' card) is
    the current CUDA device inside the block, so a kernel that reads
    ``cudaGetDevice`` (the persistent grids size themselves by its SM
    count) runs on it; yields PyTorch's current stream on ``device`` as
    a C pointer."""
    import torch

    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
