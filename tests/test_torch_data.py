"""The port's data loaders (qtpu_torch/data) against qtpu's (qtpu/data), and
the calibration batches of the port's ``freeze_from_config`` against
qtpu's ``_freeze_from_config``.

* The synthetic sets are qtpu's byte for byte (images and labels) for
  mnist, cifar10 and imagenet, both splits; ``first=k`` gives qtpu's
  first ``k`` samples of the same ``n``-sample set.
* ``load_dataset`` reads the same ``.npz`` cache and ImageFolder tree from
  ``$QTPU_DATA_DIR`` as qtpu, and falls back to the same synthetic set.
* ``freeze_from_config`` hands ``calibrate`` exactly qtpu's batches
  ``ds.images[i*bs:(i+1)*bs]`` of ``load_dataset(cfg.dataset, "train",
  n=cfg.n_train, seed=0)``, empty ones dropped.
"""
import dataclasses

import numpy as np
import pytest

from qtpu.data import datasets as J
from qtpu.examples.configs import CONFIGS as J_CONFIGS
from qtpu_torch.data import datasets as T
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.serve import cli

SMALL_N = {"mnist": 40, "cifar10": 30, "imagenet": 5}


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("QTPU_DATA_DIR", str(tmp_path))
    return tmp_path


def assert_same(a, b):
    assert a.images.dtype == b.images.dtype == np.float32
    assert a.images.shape == b.images.shape
    assert a.images.tobytes() == b.images.tobytes()
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.labels.dtype == b.labels.dtype
    assert (a.num_classes, a.synthetic) == (b.num_classes, b.synthetic)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", sorted(SMALL_N))
def test_synthetic_dataset_equals_qtpu(name, split):
    n = SMALL_N[name]
    assert_same(T.synthetic_dataset(name, split, n=n, seed=3),
                J.synthetic_dataset(name, split, n=n, seed=3))


@pytest.mark.parametrize("name", sorted(SMALL_N))
def test_first_k_equals_qtpu_prefix(name):
    """Only the first k images are built, and they are qtpu's first k of
    the n-image set (labels, jitter and shifts are drawn for all n before
    the noise)."""
    n = SMALL_N[name] * 2
    k = n // 3
    ref = J.synthetic_dataset(name, "train", n=n, seed=0)
    got = T.synthetic_dataset(name, "train", n=n, seed=0, first=k)
    assert len(got) == k
    assert got.images.tobytes() == ref.images[:k].tobytes()
    np.testing.assert_array_equal(got.labels, ref.labels[:k])
    # first beyond n is n
    assert_same(T.synthetic_dataset(name, "train", n=n, first=n + 5),
                J.synthetic_dataset(name, "train", n=n))


@pytest.mark.parametrize("name", sorted(SMALL_N))
def test_load_dataset_falls_back_to_qtpus_synthetic_set(data_dir, name):
    n = SMALL_N[name]
    ref = J.load_dataset(name, "train", n=n, seed=1)
    assert ref.synthetic
    assert_same(T.load_dataset(name, "train", n=n, seed=1), ref)
    got = T.load_dataset(name, "train", n=n, seed=1, first=2)
    assert got.images.tobytes() == ref.images[:2].tobytes()
    with pytest.raises(RuntimeError):
        T.load_dataset(name, "train", synthetic_ok=False)
    with pytest.raises(ValueError):
        T.load_dataset("svhn")


def test_npz_cache_equals_qtpu(data_dir):
    rng = np.random.default_rng(0)
    np.savez(data_dir / "mnist_train.npz",
             images=rng.integers(0, 256, (12, 28, 28)).astype(np.uint8),
             labels=np.arange(12) % 10)
    np.savez(data_dir / "cifar10_test.npz",
             images=rng.random((6, 32, 32, 3)).astype(np.float32),
             labels=np.arange(6))
    for name, split in (("mnist", "train"), ("cifar10", "test")):
        ref = J.load_dataset(name, split)
        assert not ref.synthetic
        assert_same(T.load_dataset(name, split), ref)
        assert_same(T.load_dataset(name, split, n=5), J.load_dataset(
            name, split, n=5))
        assert_same(T.load_dataset(name, split, n=5, first=3),
                    J.load_dataset(name, split, n=3))


def test_imagefolder_equals_qtpu(data_dir):
    from PIL import Image

    rng = np.random.default_rng(1)
    for ci, wnid in enumerate(["n01440764", "n01443537", "n01484850"]):
        cdir = data_dir / "imagenet" / "val" / wnid
        cdir.mkdir(parents=True)
        for j in range(2):
            arr = rng.integers(0, 256, (37 + 13 * ci, 61 + 7 * j, 3),
                               dtype=np.uint8)
            Image.fromarray(arr).save(cdir / f"img{j}.png")
    ref = J.load_dataset("imagenet", "test")        # 'val' as the alias
    assert not ref.synthetic and ref.images.shape == (6, 224, 224, 3)
    assert_same(T.load_dataset("imagenet", "test"), ref)
    assert_same(T.load_dataset("imagenet", "test", n=4, first=3),
                J.load_dataset("imagenet", "test", n=3))


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batches_equal_qtpus(shuffle, drop):
    ds_t = T.synthetic_dataset("mnist", "train", n=23)
    ds_j = J.synthetic_dataset("mnist", "train", n=23)
    got = list(T.batches(ds_t, 5, seed=4, shuffle=shuffle,
                         drop_remainder=drop))
    ref = list(J.batches(ds_j, 5, seed=4, shuffle=shuffle,
                         drop_remainder=drop))
    assert len(got) == len(ref) == (4 if drop else 5)
    for (xi, yi), (xr, yr) in zip(got, ref):
        assert xi.tobytes() == xr.tobytes()
        np.testing.assert_array_equal(yi, yr)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("name", ["resnet50_imagenet_int8_ptq_fp32stem",
                                  "resnet50_int4w_int8a_qat"])
@pytest.mark.parametrize("calib_batches", [3, 4])
def test_freeze_from_config_calibrates_on_qtpus_batches(
        data_dir, monkeypatch, name, calib_batches):
    """n_train = 10, batch_size = 4: batches of 4, 4 and 2 images, a fourth
    one empty (dropped) — the 224² images of the synthetic ImageNet set,
    whatever the (narrowed) config's image size, as in qtpu."""
    assert CONFIGS[name].n_train == J_CONFIGS[name].n_train == 2048
    cfg = dataclasses.replace(CONFIGS[name], image_size=32, num_classes=10,
                              width=16, n_train=10, batch_size=4,
                              calib_batches=calib_batches)
    seen = []

    def capture(model, policy, batches):
        seen.extend(batches)
        raise _Captured

    monkeypatch.setattr(cli, "calibrate", capture)
    with pytest.raises(_Captured):
        cli.freeze_from_config(cfg, device="cpu")
    ds = J.load_dataset(cfg.dataset, "train", n=cfg.n_train, seed=0)
    ref = [ds.images[i * cfg.batch_size:(i + 1) * cfg.batch_size]
           for i in range(cfg.calib_batches)]
    ref = [b for b in ref if len(b)]
    assert [len(b) for b in seen] == [4, 4, 2]
    assert len(seen) == len(ref)
    for got, want in zip(seen, ref):
        assert got.shape == want.shape == (len(want), 224, 224, 3)
        assert got.tobytes() == want.tobytes()
