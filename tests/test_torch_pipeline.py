"""qtpu_torch's ``grain_batches`` (a seeded torch DataLoader, no grain):
the semantics of tests/test_datasets.py::test_grain_pipeline_matches_semantics
on the port's synthetic MNIST — drop the remainder, cover the set, shuffle
(not the identity order), the same batches for one seed — and a fresh
order each epoch.  No JAX, no tolerance (equal arrays)."""
import numpy as np

from qtpu_torch.data import grain_batches, load_dataset


def test_grain_batches_semantics():
    ds = load_dataset("mnist", "train", n=70)          # synthetic fallback
    got = list(grain_batches(ds, 16, seed=3))
    assert len(got) == 4                                # 70 // 16
    xs = np.concatenate([b[0] for b in got])
    ys = np.concatenate([b[1] for b in got])
    assert xs.shape == (64, 28, 28, 1) and ys.shape == (64,)
    # each image drawn from the set once: rows are distinct images of it
    rows = {im.tobytes() for im in ds.images}
    assert len({im.tobytes() for im in xs}) == 64
    assert all(im.tobytes() in rows for im in xs)
    for (x1, y1), (x2, y2) in zip(got, grain_batches(ds, 16, seed=3)):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    assert not np.array_equal(ys, ds.labels[:64])
    other = np.concatenate([b[1] for b in grain_batches(ds, 16, seed=4)])
    assert not np.array_equal(ys, other)


def test_grain_batches_epochs_and_no_shuffle():
    ds = load_dataset("mnist", "train", n=40)
    two = list(grain_batches(ds, 8, seed=0, num_epochs=2))
    assert len(two) == 10
    e1 = np.concatenate([b[1] for b in two[:5]])
    e2 = np.concatenate([b[1] for b in two[5:]])
    assert sorted(e1.tolist()) == sorted(e2.tolist()) == sorted(
        ds.labels.tolist())
    assert not np.array_equal(e1, e2)
    flat = np.concatenate([b[0] for b in grain_batches(ds, 8,
                                                       shuffle=False)])
    np.testing.assert_array_equal(flat, ds.images)
