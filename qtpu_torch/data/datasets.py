"""Datasets (port of qtpu/data/datasets.py): MNIST / CIFAR-10 / ImageNet
loaders with a deterministic synthetic fallback.

Every loader, in qtpu's order:

1. an ``.npz`` cache (``$QTPU_DATA_DIR/<name>_<split>.npz``),
2. an ImageFolder tree (``$QTPU_DATA_DIR/<name>/<split>/<class>/*.jpg``,
   decoded with PIL, resized and center-cropped to the dataset's shape),
3. the deterministic synthetic set, with the dataset's shapes and class
   count, flagged by ``Dataset.synthetic``.

qtpu's third source, a Hugging Face ``datasets`` cache, is left out (it
needs a download).  Real data is read only from ``$QTPU_DATA_DIR``: where
the variable is unset the port reads no directory (qtpu falls back to a
fixed directory of its own), so a run reads nothing outside what it is
given.  numpy only (PIL for folders); the synthetic images are
qtpu's byte for byte: the same generators drawn in the same order.

``first=k`` returns the first ``k`` samples of the ``n``-sample set
without building the other ``n - k``: the synthetic set draws labels,
jitter and shifts for all ``n`` before the noise, and the noise of a
``standard_normal`` prefix equals the prefix of the larger draw.  A
calibration that reads ``calib_batches × batch_size`` images of an
``n_train`` set needs no more.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    images: np.ndarray          # (N, H, W, C) float32, roughly [0, 1]
    labels: np.ndarray          # (N,) int32
    num_classes: int
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.images)


_SPECS = {
    "mnist": dict(shape=(28, 28, 1), num_classes=10),
    "cifar10": dict(shape=(32, 32, 3), num_classes=10),
    "imagenet": dict(shape=(224, 224, 3), num_classes=1000),
}


def _smooth_prototypes(rng: np.random.Generator, num_classes: int,
                       shape: Tuple[int, int, int]) -> np.ndarray:
    """Per-class low-frequency patterns: coarse noise upsampled bilinearly."""
    h, w, c = shape
    coarse = rng.standard_normal((num_classes, max(h // 4, 2),
                                  max(w // 4, 2), c))
    ys = np.linspace(0, coarse.shape[1] - 1, h)
    xs = np.linspace(0, coarse.shape[2] - 1, w)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[2] - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    top = coarse[:, y0][:, :, x0] * (1 - wx) + coarse[:, y0][:, :, x1] * wx
    bot = coarse[:, y1][:, :, x0] * (1 - wx) + coarse[:, y1][:, :, x1] * wx
    protos = top * (1 - wy) + bot * wy
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-9)
    return protos.astype(np.float32)


def synthetic_dataset(name: str, split: str, n: Optional[int] = None,
                      noise: float = 0.25, seed: int = 0,
                      first: Optional[int] = None) -> Dataset:
    """qtpu's deterministic synthetic stand-in shaped like the named dataset
    (at most 50 distinct labels, valid for the nominal class count);
    ``first``: only its first ``first`` samples, the same bytes."""
    spec = _SPECS[name]
    shape, num_classes = spec["shape"], spec["num_classes"]
    if n is None:
        n = 10_000 if split == "train" else 2_000
    k = n if first is None else min(first, n)
    effective = min(num_classes, 50)
    protos = _smooth_prototypes(np.random.default_rng(seed + 12345),
                                effective, shape)
    rng = np.random.default_rng(seed + (0 if split == "train" else 777))
    labels = rng.integers(0, effective, size=n).astype(np.int32)
    scale = rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
    offset = rng.uniform(-0.1, 0.1, size=(n, 1, 1, 1)).astype(np.float32)
    sh = rng.integers(-2, 3, size=(n, 2))
    labels, sh = labels[:k], sh[:k]
    imgs = protos[labels].copy()
    # brightness/contrast jitter
    imgs *= scale[:k]
    imgs += offset[:k]
    # small circular shifts (vectorized per unique offset)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            m = (sh[:, 0] == dy) & (sh[:, 1] == dx)
            if m.any() and (dy or dx):
                imgs[m] = np.roll(imgs[m], (dy, dx), axis=(1, 2))
    imgs += rng.standard_normal(imgs.shape).astype(np.float32) * noise
    return Dataset(images=imgs.astype(np.float32), labels=labels,
                   num_classes=num_classes, synthetic=True)


def _data_dir() -> Optional[str]:
    return os.environ.get("QTPU_DATA_DIR")


def _try_npz(name: str, split: str, n: Optional[int]) -> Optional[Dataset]:
    """``$QTPU_DATA_DIR/<name>_<split>.npz`` with ``images``/``labels``;
    uint8 images are scaled by 1/255."""
    if _data_dir() is None:
        return None
    path = os.path.join(_data_dir(), f"{name}_{split}.npz")
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        imgs, labels = z["images"], z["labels"]
    if n:
        imgs, labels = imgs[:n], labels[:n]
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    return Dataset(images=np.ascontiguousarray(imgs, np.float32),
                   labels=np.asarray(labels, np.int32),
                   num_classes=_SPECS[name]["num_classes"], synthetic=False)


_IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def _decode_resize(path: str, shape: Tuple[int, int, int]) -> np.ndarray:
    """PIL decode → shorter-side resize → center crop to (H, W, C)."""
    from PIL import Image

    h, w, c = shape
    with Image.open(path) as im:
        im = im.convert("L" if c == 1 else "RGB")
        sw, sh = im.size
        scale = max(h / sh, w / sw) * (256 / 224 if h >= 64 else 1.0)
        im = im.resize((max(int(round(sw * scale)), w),
                        max(int(round(sh * scale)), h)), Image.BILINEAR)
        sw, sh = im.size
        left, top = (sw - w) // 2, (sh - h) // 2
        im = im.crop((left, top, left + w, top + h))
        arr = np.asarray(im, np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr


def _try_folder(name: str, split: str, n: Optional[int]) -> Optional[Dataset]:
    """ImageFolder layout ``<dir>/<name>/<split>/<class>/*.jpg``: class
    index = rank of the sorted class directory name, files interleaved by
    class (a truncated ``n`` keeps label diversity); ``val`` and ``test``
    stand in for each other."""
    if _data_dir() is None:
        return None
    base = os.path.join(_data_dir(), name)
    aliases = {"test": ("test", "val", "validation"),
               "val": ("val", "validation", "test")}
    root = None
    for s in aliases.get(split, (split,)):
        cand = os.path.join(base, s)
        if os.path.isdir(cand):
            root = cand
            break
    if root is None:
        return None
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        return None
    spec = _SPECS[name]
    per_class = {}
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        fs = sorted(f for f in os.listdir(cdir)
                    if f.lower().endswith(_IMG_EXTS))
        per_class[ci] = [(os.path.join(cdir, f), ci) for f in fs]
    files = []
    for i in range(max((len(v) for v in per_class.values()), default=0)):
        for ci in range(len(classes)):
            if i < len(per_class[ci]):
                files.append(per_class[ci][i])
    if not files:
        return None
    if n:
        files = files[:n]
    imgs = np.stack([_decode_resize(p, spec["shape"]) for p, _ in files])
    labels = np.asarray([lab for _, lab in files], np.int32)
    return Dataset(images=imgs, labels=labels,
                   num_classes=spec["num_classes"], synthetic=False)


def load_dataset(name: str, split: str = "train", n: Optional[int] = None,
                 synthetic_ok: bool = True, seed: int = 0,
                 first: Optional[int] = None) -> Dataset:
    """Load a named dataset; fall back to synthetic when real data is
    absent.  ``first``: only the first ``first`` samples of the ``n``-sample
    set (each source's samples are a prefix of a larger ``n``'s)."""
    if name not in _SPECS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(_SPECS)}")
    head = n if first is None else (first if not n else min(n, first))
    for loader in (_try_npz, _try_folder):
        real = loader(name, split, head)
        if real is not None:
            return real
    if not synthetic_ok:
        raise RuntimeError(
            f"dataset {name!r} unavailable offline and synthetic_ok=False")
    return synthetic_dataset(name, split, n=n, seed=seed, first=first)


def batches(ds: Dataset, batch_size: int, *, seed: int = 0,
            shuffle: bool = True, drop_remainder: bool = True
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of (images, labels) minibatches."""
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = len(idx) // batch_size * batch_size if drop_remainder else len(idx)
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        yield ds.images[sel], ds.labels[sel]
