"""Builds the port's CUDA sources with ``nvcc`` and binds them with ctypes.

Each source under ``siddhi_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface, for ``sm_90a``, at first CUDA use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/lib<stem>-<hash>.so csrc/<stem>.cu

The library name carries a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and a
built one is reused. ``_build/`` is git-ignored.
``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
# one build at a time: the engine's async drivers can reach a kernel's first
# launch on their worker threads, and two bridges starting together must not
# build the same library twice
_lock = threading.Lock()
build_seconds: dict[str, float] = {}   # per source: nvcc wall time (0.0 if reused)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _target(stem: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{stem}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _start(stem: str):
    """Starts nvcc for ``stem`` unless its library exists; returns
    ``(popen or None, tmp path, target path, t0)``."""
    src, out = _target(stem)
    if os.path.exists(out):
        return None, None, out, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(stem: str, started) -> ctypes.CDLL:
    proc, tmp, out, t0 = started
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
        os.replace(tmp, out)
        build_seconds[stem] = time.perf_counter() - t0
    else:
        build_seconds.setdefault(stem, 0.0)
    # PyDLL keeps the interpreter lock through a call: an entry point only
    # enqueues launches and returns, and releasing the lock for it would
    # cost the calling thread up to a switch interval to win it back from
    # a busy producer thread
    return ctypes.PyDLL(out)


def build_all(stems) -> dict[str, ctypes.CDLL]:
    """Builds (or reuses) every named source, one nvcc each, in parallel.
    Thread-safe: a caller that finds a build in progress waits for it."""
    with _lock:
        todo = [s for s in stems if s not in _libs]
        started = {s: _start(s) for s in todo}
        for s in todo:
            _libs[s] = _finish(s, started[s])
        return {s: _libs[s] for s in stems}


def load(stem: str) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu`` (built on first call)."""
    lib = _libs.get(stem)
    return lib if lib is not None else build_all([stem])[stem]


def sources() -> list[str]:
    """Stems of every CUDA source of the port."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
