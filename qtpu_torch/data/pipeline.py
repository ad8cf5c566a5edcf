"""Input pipeline over the port's datasets (port of
qtpu/data/pipeline.py:grain_batches, without ``grain``).

:func:`grain_batches` is a ``torch.utils.data.DataLoader`` over an
in-memory :class:`~qtpu_torch.data.datasets.Dataset`: a global shuffle
from a seeded ``torch.Generator``, a fresh order each epoch, the remainder
dropped, worker processes optional.  It yields ``(images, labels)`` numpy
pairs with the semantics of qtpu's grain loader and of
:func:`qtpu_torch.data.datasets.batches` (shuffle by seed, drop
remainder); the orders themselves are each generator's own.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from qtpu_torch.data.datasets import Dataset


class _ArraySource(torch.utils.data.Dataset):
    """Map-style dataset over the in-memory arrays."""

    def __init__(self, ds: Dataset):
        self._ds = ds

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, idx: int):
        return self._ds.images[idx], self._ds.labels[idx]


def _stack(items):
    return (np.stack([im for im, _ in items]),
            np.asarray([lb for _, lb in items]))


def grain_batches(ds: Dataset, batch_size: int, *, seed: int = 0,
                  shuffle: bool = True, num_epochs: int = 1,
                  worker_count: int = 0
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``num_epochs`` epochs of ``(images, labels)`` minibatches."""
    gen = torch.Generator().manual_seed(seed)
    loader = DataLoader(_ArraySource(ds), batch_size=batch_size,
                        shuffle=shuffle, drop_last=True, generator=gen,
                        num_workers=worker_count, collate_fn=_stack)
    for _ in range(num_epochs):
        yield from loader
