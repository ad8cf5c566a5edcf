"""Data loading (port of qtpu/data): real datasets when available, the
deterministic synthetic fallback otherwise."""
from qtpu_torch.data.datasets import (Dataset, batches, load_dataset,
                                      synthetic_dataset)

__all__ = ["Dataset", "batches", "load_dataset", "synthetic_dataset"]
