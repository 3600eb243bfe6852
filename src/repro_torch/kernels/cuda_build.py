"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (``vamana_host.cu`` holds
host code only; the host compiler never fuses a product into a sum,
``-ffp-contract=off``) into
``build/<name>-<hash>.so`` under the repository root, at first use
(:func:`load`) or ahead of it (:func:`build`, which starts one ``nvcc`` per
source, all together).  The hash covers the source, the shared headers and
the flags, so an edited kernel never loads a stale library.  The C entry
points take raw device pointers and the current stream, and return
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

Nothing here runs at import: the CPU tests import every module, and this
host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("fused_scan", "gather_distance", "masked_distance",
           "filtered_topk", "vamana_host", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC,-ffp-contract=off",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns seconds per compiled
    source; each compiler log (with ``-Xptxas -v``'s register and shared
    memory report) is kept as ``build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if missing), with
    ``argtypes``/``restype`` declared for every function in
    ``signatures``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t) -> int | None:
    """Device pointer of a tensor for ctypes (None for an absent operand)."""
    return None if t is None else t.data_ptr()
