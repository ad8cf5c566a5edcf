"""Data loading (port of qtpu/data): real datasets when available, the
deterministic synthetic fallback otherwise, and the seeded batch loader."""
from qtpu_torch.data.datasets import (Dataset, batches, load_dataset,
                                      synthetic_dataset)
from qtpu_torch.data.pipeline import grain_batches

__all__ = ["Dataset", "batches", "grain_batches", "load_dataset",
           "synthetic_dataset"]
