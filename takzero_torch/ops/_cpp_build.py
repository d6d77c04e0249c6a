"""Build the port's copy of the C++ rules (``takzero_torch/cpp/``).

The sources are copies of ``takzero_tpu/cpp/`` (the rules oracle, the exact
tinue solver, the native target loader and the reference-architecture MCTS
bench), compiled with the host C++ compiler (``$CXX``, else ``g++``) and the
JAX package's Makefile flags into ``<repo>/build/`` (listed in
``.gitignore``), never into either package's ``cpp/``.  Two targets:

* ``tak_oracle``: ``tak_oracle.cpp``, ``tak_io.cpp`` and ``tak_solver.cpp``
  linked into one shared library, as JAX's ``libtak_oracle.so``;
* ``tak_mcts_bench``: an executable.

Nothing here runs at import time.  Outputs are named by a hash of every
source of the target, every header and the flags, so an edited header
rebuilds; each build writes a per-pid temporary file and ``os.replace``s it
into place, so processes that build at once never load a half-written file.
There is no fallback: a missing or failing compiler raises with its output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ._build import BUILD_DIR

CPP = Path(__file__).resolve().parent.parent / "cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
# name -> (sources, extra flags, output file name pattern)
TARGETS = {
    "tak_oracle": (("tak_oracle.cpp", "tak_io.cpp", "tak_solver.cpp"), ["-shared"], "lib{name}-{tag}.so"),
    "tak_mcts_bench": (("tak_mcts_bench.cpp",), [], "{name}-{tag}"),
}

_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("takzero_torch: no C++ compiler found (set CXX or install g++)")
    return cxx


def output_path(name: str) -> Path:
    sources, extra, pattern = TARGETS[name]
    h = hashlib.sha256()
    for src in (*sources, *sorted(p.name for p in CPP.glob("*.hpp"))):
        h.update(src.encode() + b"\0" + (CPP / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + extra).encode())
    return BUILD_DIR / pattern.format(name=name, tag=h.hexdigest()[:12])


def build(name: str) -> Path:
    """The built target's path, compiling it first if it is not there."""
    sources, extra, _ = TARGETS[name]
    out = output_path(name)
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *CXX_FLAGS, *extra, "-o", str(tmp), *(str(CPP / s) for s in sources)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"takzero_torch: building {name} failed ({' '.join(cmd)}):\n"
                + proc.stdout.decode(errors="replace")
            )
        os.replace(tmp, out)
    return out
