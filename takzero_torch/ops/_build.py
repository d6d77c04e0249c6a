"""Build and load the port's CUDA kernels (``takzero_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
into a shared library with a plain C interface under ``<repo>/build/``
(listed in ``.gitignore``), then loaded with ctypes.  Nothing here runs at
import time: the first kernel launch (or :func:`build_all`) triggers the
build.  Libraries are named by a hash of their source and flags, so an
edited source is rebuilt and never mixed with a stale one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (source, {symbol: argtypes})
KERNELS = {
    "topk": ("topk.cu", {"topk_launch": [_P, _P, _P, _I, _I, _I, _P]}),
    "simhash": ("simhash.cu", {"simhash_launch": [_P, _P, _P, _I, _I, _I, _P]}),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("takzero_torch: nvcc not found (set CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile (in parallel) and load the named kernels.

    Returns the seconds each compile took (0 for a library already built
    or loaded).  Raises with nvcc's output if any build fails.
    """
    names = list(KERNELS) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp,
                out,
            )
        errors, seconds = [], {}
        for name, (proc, tmp, out) in procs.items():
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}:\n{log}")
            else:
                os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for sym, argtypes in KERNELS[name][1].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return {n: seconds.get(n, 0.0) for n in names}


def lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"takzero_torch: {what} launch failed with CUDA error {err}")
