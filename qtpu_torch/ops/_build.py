"""Build and load the hand-written CUDA kernels (``qtpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is built
when a module is imported: a kernel is built at its first launch, or
explicitly with :func:`build` (which starts one ``nvcc`` per source, all
together).  The library name carries a digest of the sources and flags, so
a stale build is never loaded; the build directory is git-ignored.  A
variant built with extra ``-D`` defines (the clock64 probes of
``ops/probe_k1.py``, ``ops/probe_k2.py``, ``ops/probe_tail.py`` and
``ops/probe_chain.py``, ``ops/probe_k4.py``) gets a
library of its own.
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
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = {"qmatmul": "qmatmul.cu", "qconv": "qconv.cu",
           "qdepthwise": "qdepthwise.cu", "qproj": "qproj.cu",
           "qtail": "qtail.cu", "qblock": "qblock.cu",
           "qstage": "qstage.cu", "qivr": "qivr.cu",
           "qstage_wg": "qstage_wg.cu", "qivr_wg": "qivr_wg.cu",
           "qstage_proj_wg": "qstage_proj_wg.cu", "qstem": "qstem.cu"}
HEADERS = ("epilogue.cuh", "igemm.cuh", "wgmma_gemm.cuh", "wgmma_narrow.cuh",
           "fused_tail.cuh", "wgmma_tail.cuh", "grid_phase.cuh",
           "wgmma_phase.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[tuple, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
# name -> {"seconds": build time, "log": nvcc's ptxas report}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the CUDA "
                       "kernels build only on a machine with the toolkit")


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join((*FLAGS, *defines)).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          defines: Sequence[str] = ()) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, started together, with the extra
    ``defines`` (``-D`` flags) if any.  Raises on any failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name, defines)
        if out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, *defines, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: build_info[n] for n in names}


def launch(fn: ctypes._CFuncPtr, dev, *args) -> int:
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``dev`` appended, with ``dev`` made the current device: a kernel runs
    on the device current at its launch, and the per-device state of the
    launchers (the shared-memory opt-in, the SM count, the occupancy) is
    read there.  Returns the entry's CUDA error code."""
    import torch

    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def load(name: str, symbol: str, argtypes: Sequence,
         defines: Sequence[str] = ()) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name`` (its variant built
    with ``defines``), built if needed.

    Every pointer and the stream are ``c_void_p`` in ``argtypes``: without
    them ctypes would pass 32-bit ints and cut the pointers.
    """
    key = (name, symbol, *defines)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get((name, *defines))
        if lib is None:
            path = _target(name, defines)
            if not path.exists():
                build([name], defines)
            lib = _libs[(name, *defines)] = ctypes.CDLL(str(path))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn
