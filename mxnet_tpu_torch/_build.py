"""Builds the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``. No source includes
PyTorch's headers, so a build takes seconds. Libraries go under
``build/mxnet_tpu_torch/`` beside the package, and each file name carries a
hash of its source, of the ``csrc/`` headers the source includes
(``#include "hopper_tma.cuh"``) and of its flags, so a changed source,
header or flag builds anew. The sources of one call are compiled by
concurrent ``nvcc`` processes. Flags are per library: ``rtc_runtime``
links NVRTC and the driver API (``-lnvrtc -lcuda``), ``flash_attention``
and ``flash_attention_bwd`` the driver API (``-lcuda``, for
``cuTensorMapEncodeTiled``), the driver through the toolkit's
``lib64/stubs`` at link time and the installed driver at run time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

from .base import MXNetError

__all__ = ["SOURCES", "build", "load", "library_path"]

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mxnet_tpu_torch"

# library name -> source file under csrc/
SOURCES = {"lstm_cell": "lstm_cell.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "rtc_runtime": "rtc_runtime.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# library name -> libraries it links beyond the CUDA runtime
LINKS = {"rtc_runtime": ("-lnvrtc", "-lcuda"),
         "flash_attention": ("-lcuda",),
         "flash_attention_bwd": ("-lcuda",)}


def link_flags(name: str) -> tuple:
    """The flags library ``name`` adds after its source on nvcc's line:
    ``rtc_runtime`` links NVRTC and the CUDA driver API, the two attention
    libraries the driver API (``cuTensorMapEncodeTiled``)."""
    if name not in LINKS:
        return ()
    lib = os.path.join(os.path.dirname(os.path.dirname(_nvcc())), "lib64")
    return ("-L" + lib, "-L" + os.path.join(lib, "stubs"),
            "-Xlinker", "-rpath", "-Xlinker", lib, *LINKS[name])


_LOADED: Dict[str, ctypes.CDLL] = {}
# read by compiler.stats(): libraries found built, built, loaded
COUNTERS = {"cache_hits": 0, "cache_misses": 0, "compiled": 0, "loaded": 0}


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output, -Xptxas -v included


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                     "mxnet_tpu_torch are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def included_headers(path: Path) -> list:
    """The files under ``csrc/`` that ``path`` includes with ``#include
    "..."``, and theirs in turn, each once, in the order first met."""
    found, todo = [], [path]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            header = CSRC / name.decode()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    source = CSRC / SOURCES[name]
    text = b"".join(p.read_bytes()
                    for p in [source, *included_headers(source)])
    flags = NVCC_FLAGS + link_flags(name)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, BuildResult]:
    """Compile every named library that is not built yet, all at once;
    raise MXNetError naming each source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        out = library_path(name)
        log_file = out.with_suffix(".log")
        if out.exists():
            log = log_file.read_text() if log_file.exists() else ""
            results[name] = BuildResult(out, 0.0, log)
            COUNTERS["cache_hits"] += 1
            continue
        COUNTERS["cache_misses"] += 1
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name]),
               *link_flags(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        COUNTERS["compiled"] += 1
        results[name] = BuildResult(out, seconds, log)
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LOADED[name] = lib
        COUNTERS["loaded"] += 1
    return lib
