"""qtpu_torch's host preprocessing library (``data/native.py`` over
``csrc/preprocess.cpp``) against its numpy versions and qtpu's
(mirrors tests/test_native.py; no card).

Tolerance: none — the int8 codes and the normalized float32 pixels are
equal bit for bit (division, not a reciprocal; no FMA contraction;
half-to-even rounding on both sides), the packed batches equal
``np.stack`` and qtpu's ``pack_batch``.  The library builds under
``qtpu_torch/build/``; a source that does not compile raises instead of
falling back.
"""
import numpy as np
import pytest

from qtpu.data import native as jnative
from qtpu_torch.data import native

RNG = np.random.default_rng(0)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def test_library_builds_under_the_build_dir():
    lib = native.load_native()
    assert lib.qtpu_native_version() == native.ABI_VERSION
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "build" and path.parent.parent.name == \
        "qtpu_torch"


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "preprocess.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_native()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("scale,zp,mean,std", [
    (0.02, 5, MEAN, STD), (0.0173, -37, MEAN, STD), (1 / 255, -128, 0.0, 1.0),
    (0.5, 0, (0.5,), (0.25,))])
def test_quantize_equals_plain_and_qtpu(scale, zp, mean, std):
    imgs = RNG.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    got = native.preprocess_quantize(imgs, mean, std, scale, zp)
    plain = native.preprocess_quantize_plain(imgs, mean, std, scale, zp)
    m3 = np.broadcast_to(np.asarray(mean, np.float32), (3,))
    s3 = np.broadcast_to(np.asarray(std, np.float32), (3,))
    ref = jnative.preprocess_quantize(imgs, m3, s3, scale, zp)
    assert got.dtype == np.int8 and got.shape == imgs.shape
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


def test_f32_equals_plain_and_qtpu():
    imgs = RNG.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    got = native.preprocess_f32(imgs, MEAN, STD)
    np.testing.assert_array_equal(got, native.preprocess_f32_plain(
        imgs, MEAN, STD))
    np.testing.assert_array_equal(got, jnative.preprocess_f32(imgs, MEAN,
                                                              STD))


def test_threads_give_equal_results():
    imgs = RNG.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
    a = native.preprocess_quantize(imgs, MEAN, STD, 0.02, 0, threads=1)
    b = native.preprocess_quantize(imgs, MEAN, STD, 0.02, 0, threads=8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        native.preprocess_f32(imgs, MEAN, STD, threads=1),
        native.preprocess_f32(imgs, MEAN, STD, threads=8))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int8])
def test_pack_batch_matches_stack(dtype):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 200, (17, 13, 3)).astype(dtype)
            for _ in range(9)]
    np.testing.assert_array_equal(native.pack_batch(imgs), np.stack(imgs))
    out = native.pack_batch(imgs, pad_to=12)
    assert out.shape == (12, 17, 13, 3) and out.dtype == dtype
    np.testing.assert_array_equal(out[:9], np.stack(imgs))
    assert not out[9:].any()
    np.testing.assert_array_equal(out, jnative.pack_batch(imgs, pad_to=12))


def test_pack_batch_validates():
    imgs = [np.zeros((4, 4, 3), np.float32)] * 2
    with pytest.raises(ValueError):
        native.pack_batch(imgs, pad_to=1)
    with pytest.raises(ValueError):
        native.pack_batch([])
    with pytest.raises(ValueError):
        native.pack_batch([np.zeros((4, 4, 3), np.float32),
                           np.zeros((4, 5, 3), np.float32)])


def test_pack_batch_no_silent_broadcast_or_unsafe_cast():
    """``np.stack``'s rule, not assignment's: a broadcastable shape
    raises, a float image is not truncated into a uint8 batch, and a
    "same_kind" cast (f64 → f32) goes through."""
    with pytest.raises(ValueError):
        native.pack_batch([np.ones((4, 4, 3), np.float32),
                           np.full((4, 4, 1), 7.0, np.float32)])
    with pytest.raises(ValueError):
        native.pack_batch([np.zeros((4, 4, 3), np.uint8),
                           np.ones((4, 4, 3), np.float32)])
    with pytest.raises(ValueError):
        native.pack_batch([np.ones((4, 4, 3), np.float32)], dtype=np.uint8)
    out = native.pack_batch([np.full((2, 2, 1), 0.5, np.float64)],
                            dtype=np.float32, shape=(2, 2, 1))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.full((1, 2, 2, 1), 0.5,
                                               np.float32))


def test_pack_batch_noncontiguous_sources():
    base = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    imgs = [base[0, ::2], base[1, ::2]]
    np.testing.assert_array_equal(native.pack_batch(imgs), np.stack(imgs))
