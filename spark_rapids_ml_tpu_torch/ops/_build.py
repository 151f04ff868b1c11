#
# Build and load the port's CUDA kernels.
#
# Each source csrc/<name>.cu has a plain C interface.  At first use nvcc
# compiles it for sm_90a into build/torch_kernels/lib<name>-<hash>.so under
# the repository root, keyed by a hash of the source, of the local headers
# it includes (#include "..." of csrc/, followed through headers), and of the
# flags, and the library is loaded with ctypes.  build() starts one nvcc per source, all at
# once, and waits for them together.  Nothing here runs at import time.  The
# first load of a library in the process counts precompile.compile
# (ops/precompile.py).
#

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

from .. import profiling

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> Dict[str, bytes]:
    """csrc/<name>.cu and every local header it includes, directly or
    through another header, by path relative to csrc/."""
    found: Dict[str, bytes] = {}
    pending = [f"{name}.cu"]
    while pending:
        rel = pending.pop()
        if rel in found:
            continue
        found[rel] = (CSRC / rel).read_bytes()
        pending.extend(m.decode() for m in _LOCAL_INCLUDE.findall(found[rel]))
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for rel, text in sorted(_sources(name).items()):
        digest.update(rel.encode() + b"\0" + text + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc printed for `name` (ptxas registers, shared memory,
    spills), or "" when it has not been built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together.  Returns the seconds each build took (0.0 when the
    library was already there).  Raises RuntimeError if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds: Dict[str, float] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out, time.perf_counter()))
    failures = []
    for name, proc, tmp, out, t0 in running:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
            # a first load is a build the serving steady state must not
            # do: the serving engine's warm-cache watermark reads it
            profiling.incr_counter("precompile.compile")
        return lib
