"""ctypes bindings for the host preprocessing library (port of
qtpu/data/native.py over the port's own ``qtpu_torch/csrc/preprocess.cpp``).

The library is built with ``g++`` at its first use into the git-ignored
``qtpu_torch/build/``, under a name that carries a digest of the source
and flags, so a stale build is never loaded, and its
``qtpu_native_version()`` is checked against :data:`ABI_VERSION`.  Unlike
qtpu's ``load_native``, a failed build raises: the serving path never
falls back silently.  Beside each function is its plain numpy
version (``*_plain``), the reference the tests hold it to.

* :func:`preprocess_quantize` — uint8 NHWC pixels → int8 codes on the
  stem's affine grid, ``(x/255 − mean)/std`` quantized as
  ``ops.qops.quantize_act`` does (the host int8 ingest);
* :func:`preprocess_f32` — the same normalization to float32;
* :func:`pack_batch` — the serving scheduler's one copy of a round's
  images into the zero-padded bucket buffer, with qtpu's checks (numpy
  alone: qtpu's threaded gather is not ported).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "csrc" / "preprocess.cpp"
BUILD_DIR = _PKG / "build"
# a portable x86-64 level (SSE4.1's rounding instructions), not the build
# host's own: a library built on one machine may be loaded on another
FLAGS = ("-O3", *(("-march=x86-64-v2",) if platform.machine() == "x86_64"
                  else ()), "-ffp-contract=off", "-shared", "-fPIC")
ABI_VERSION = 3         # qtpu_native_version() in preprocess.cpp
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libqtpu_preprocess-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile to a temporary name and move it into place, so a reader
    never maps a half-written library and a concurrent build is harmless."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SRC.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def load_native() -> ctypes.CDLL:
    """The library, built on its first call; raises if it cannot be built,
    or if what loads is not at :data:`ABI_VERSION` (the name carries the
    source's digest, so only a damaged file can be)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.qtpu_native_version.restype = ctypes.c_int
        if lib.qtpu_native_version() != ABI_VERSION:
            raise RuntimeError(f"{path}: ABI version "
                               f"{lib.qtpu_native_version()}, not "
                               f"{ABI_VERSION}")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.qtpu_preprocess_quantize.argtypes = [
            p, i64, i64, i64, i64, p, p, ctypes.c_float, ctypes.c_int32, p,
            ctypes.c_int]
        lib.qtpu_preprocess_f32.argtypes = [p, i64, i64, i64, i64, p, p, p,
                                            ctypes.c_int]
        _lib = lib
        return lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _threads(threads: int) -> int:
    return threads or min(os.cpu_count() or 1, 8)


def _stats(images_u8, mean, std):
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    c = images_u8.shape[-1]
    mean = np.ascontiguousarray(
        np.broadcast_to(np.asarray(mean, np.float32).reshape(-1), (c,)))
    std = np.ascontiguousarray(
        np.broadcast_to(np.asarray(std, np.float32).reshape(-1), (c,)))
    return images_u8, mean, std


def preprocess_quantize(images_u8: np.ndarray, mean, std, scale: float,
                        zp_signed: int, threads: int = 0) -> np.ndarray:
    """uint8 (N, H, W, C) → int8 codes on the affine grid (``scale``,
    signed zero point ``zp_signed``): ``round((x/255 − mean)/std / scale
    + zp_signed + 128)`` clipped to [0, 255], minus 128, half to even."""
    images_u8, mean, std = _stats(images_u8, mean, std)
    n, h, w, c = images_u8.shape
    out = np.empty(images_u8.shape, np.int8)
    load_native().qtpu_preprocess_quantize(
        _as_c(images_u8), n, h, w, c, _as_c(mean), _as_c(std),
        ctypes.c_float(scale), ctypes.c_int32(zp_signed), _as_c(out),
        _threads(threads))
    return out


def preprocess_quantize_plain(images_u8: np.ndarray, mean, std,
                              scale: float, zp_signed: int) -> np.ndarray:
    """:func:`preprocess_quantize` in numpy (float32 throughout)."""
    images_u8, mean, std = _stats(images_u8, mean, std)
    x = (images_u8.astype(np.float32) / np.float32(255.0) - mean) / std
    q = np.round(x / np.float32(scale) + np.float32(zp_signed + 128))
    return (np.clip(q, 0, 255) - 128).astype(np.int8)


def preprocess_f32(images_u8: np.ndarray, mean, std,
                   threads: int = 0) -> np.ndarray:
    """uint8 (N, H, W, C) → ``(x/255 − mean)/std`` in float32."""
    images_u8, mean, std = _stats(images_u8, mean, std)
    n, h, w, c = images_u8.shape
    out = np.empty(images_u8.shape, np.float32)
    load_native().qtpu_preprocess_f32(_as_c(images_u8), n, h, w, c,
                                      _as_c(mean), _as_c(std), _as_c(out),
                                      _threads(threads))
    return out


def preprocess_f32_plain(images_u8: np.ndarray, mean, std) -> np.ndarray:
    """:func:`preprocess_f32` in numpy."""
    images_u8, mean, std = _stats(images_u8, mean, std)
    return ((images_u8.astype(np.float32) / np.float32(255.0) - mean)
            / std).astype(np.float32)


def pack_batch(images, pad_to: Optional[int] = None, dtype=None,
               shape=None) -> np.ndarray:
    """Equally-shaped images copied into one contiguous ``(pad_to, ...)``
    batch, the rows past ``len(images)`` zero.  ``dtype``/``shape``: the
    batch's (default: the first image's).  Every image must have the shape
    exactly (``np.stack``'s rule: no broadcast), and a dtype is cast only
    where numpy's "same_kind" allows (f64 → f32, never f32 → uint8).  Only
    the padding tail is zeroed."""
    n = len(images)
    if n == 0:
        raise ValueError("pack_batch needs at least one image")
    first = np.asarray(images[0])
    dtype = np.dtype(dtype) if dtype is not None else first.dtype
    shape = tuple(shape) if shape is not None else first.shape
    rows = n if pad_to is None else int(pad_to)
    if rows < n:
        raise ValueError(f"pad_to={pad_to} < batch size {n}")
    out = np.empty((rows, *shape), dtype)
    for i, im in enumerate(images):
        a = np.asarray(im)
        if a.shape != shape:
            raise ValueError(
                f"pack_batch: image shape {a.shape} != batch shape {shape}")
        if a.dtype != dtype and not np.can_cast(a.dtype, dtype,
                                                casting="same_kind"):
            raise ValueError(
                f"pack_batch: refusing unsafe cast {a.dtype} -> {dtype}")
        out[i] = a
    out[n:] = 0                          # zero only the padding tail
    return out
