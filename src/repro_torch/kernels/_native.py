"""Build and load the CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each source under ``repro_torch/csrc/`` has a plain C interface and is
compiled on its own (``-gencode arch=compute_90a,code=sm_90a``) into
``build/repro_torch_kernels/`` at the root of the checkout, at first use or
all together (in parallel) through :func:`build`.  A library is rebuilt
when its source or a shared header is newer than it.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = (
    "scrub", "paged_decode", "paged_prefill", "repair_matmul", "flash_attention",
    "mlstm_chunk", "tile_fill",
)
_HEADERS = ("repair.cuh", "hopper.cuh", "attention_wgmma.cuh")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so", BUILD_DIR / f"{name}.log"


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    if not lib.exists():
        return True
    newest = max(
        [src.stat().st_mtime] + [(CSRC / h).stat().st_mtime for h in _HEADERS]
    )
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, float]:
    """Compile the named sources, one ``nvcc`` process each, all started
    together.  Returns the wall seconds of the whole build per source that
    was (re)built; the compiler's output (with ``-Xptxas -v``'s register and
    shared-memory report) goes to ``<name>.log`` beside each library."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        src, lib, log = _paths(name)
        tmp = lib.with_suffix(".so.tmp")
        cmd = [nvcc, *_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, lib, log,
        )
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    elapsed = time.perf_counter() - t0
    return {name: elapsed for name in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if it is missing or
    stale."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _loaded[name] = lib
    return lib


def function(name: str, fn: str, signature) -> ctypes._CFuncPtr:
    """The entry point ``fn`` of the library ``name``, with its argument
    types set once (a wrapper's host path calls this on every launch);
    every entry point returns ``cudaGetLastError()`` as int."""
    entry = _entries.get((name, fn))
    if entry is None:
        entry = getattr(library(name), fn)
        entry.argtypes = signature
        entry.restype = I
        _entries[(name, fn)] = entry
    return entry


def build_log(name: str) -> str:
    """The compiler output of the last build of one source."""
    return _paths(name)[2].read_text()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def int8_array(values) -> ctypes.Array:
    """A host int32[8] for a detector-constants argument."""
    return (ctypes.c_int * 8)(*[int(v) for v in values])


P = ctypes.c_void_p
HOST_INTS = ctypes.POINTER(ctypes.c_int)
I = ctypes.c_int
LL = ctypes.c_longlong
U = ctypes.c_uint
F = ctypes.c_float
