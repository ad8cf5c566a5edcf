"""Spatial partitioning (halo-exchange conv and pool) on a world of four
CPU ranks (gloo) against qtpu's single-device oracle (mirrors
tests/test_spatial.py case for case).

The parent draws qtpu's inputs, computes qtpu's unsharded results
(``qops.qconv2d``, XLA's SAME conv and ``reduce_window``) and hands the
inputs to four worker ranks that import no JAX (``python
tests/test_torch_spatial.py spatial <dir>``).  Each rank cuts its block
(``spatial_local``), runs ``spatial_conv2d`` / ``spatial_max_pool`` and
saves its output block; the parent puts the blocks back together by the
ranks' mesh coordinates.  The mesh is ``sp = 4`` (qtpu's spatial split of
its int8 cases; its sp = 8 cases run at sp = 4 on four ranks), and the
int8 cases also at (dp, sp) = (2, 2).  Integer results are exact (the
int32 accumulators of K2's and K3's raw entries, their plain versions
here); fp32 to qtpu's rtol 1e-5 / atol 1e-5.  The bad geometries raise
``ValueError`` as qtpu's do.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QCONV = [(kh, kw, s, zp) for kh, kw, s in ((3, 3, 1), (3, 3, 2), (1, 1, 1),
                                            (7, 7, 2))
         for zp in (None, 5)]
MESHES = ((1, 4), (2, 2))           # (dp, sp)


def _assemble(blocks):
    """Whole tensor from {(data, spatial): block}."""
    dps = sorted({k[0] for k in blocks})
    sps = sorted({k[1] for k in blocks})
    return np.concatenate([np.concatenate([blocks[(i, j)] for j in sps],
                                          axis=1) for i in dps], axis=0)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from qtpu.ops import qops
    from qtpu_torch.parallel.launch import run_world

    d = tmp_path_factory.mktemp("spatial")
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    i8 = lambda k, s: np.asarray(jax.random.randint(      # noqa: E731
        k, s, -128, 128, dtype=jnp.int8))
    arrays, ref = {"x": i8(k1, (2, 16, 16, 8))}, {}
    for kh, kw, s, zp in QCONV:
        w = i8(k2, (kh, kw, 8, 16))
        arrays[f"w{kh}{s}"] = w
        ref[(kh, s, zp)] = np.asarray(qops.qconv2d(
            jnp.asarray(arrays["x"]), jnp.asarray(w), strides=(s, s),
            zp=None if zp is None else jnp.asarray(zp, jnp.int32)))
    # fp32 chain
    a, b, c = jax.random.split(key, 3)
    xf = jax.random.normal(a, (2, 32, 32, 4))
    w1 = jax.random.normal(b, (3, 3, 4, 8)) * 0.1
    w2 = jax.random.normal(c, (3, 3, 8, 8)) * 0.1
    conv = lambda x, w, s: jax.lax.conv_general_dilated(   # noqa: E731
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ref["fp32_chain"] = np.asarray(conv(conv(xf, w1, 1), w2, 2))
    arrays.update(xf=np.asarray(xf), w1=np.asarray(w1), w2=np.asarray(w2))
    # depthwise
    wd = i8(k2, (3, 3, 1, 8))
    arrays["wd"] = wd
    ref["depthwise"] = np.asarray(qops.qconv2d(
        jnp.asarray(arrays["x"]), jnp.asarray(wd), strides=(1, 1), groups=8))
    # the stem chain: 7x7/2 conv -> requant -> 3x3/2 max-pool -> 3x3 conv
    s1, s2, s3 = jax.random.split(key, 3)
    xs, ws1, ws2 = i8(s1, (2, 64, 64, 3)), i8(s2, (7, 7, 3, 8)), \
        i8(s3, (3, 3, 8, 8))
    requant = lambda acc: jnp.clip(acc // 256, -128, 127).astype(jnp.int8)
    y = requant(qops.qconv2d(jnp.asarray(xs), jnp.asarray(ws1),
                             strides=(2, 2)))
    pool = jax.lax.reduce_window(
        y, jnp.asarray(-128, jnp.int8), jax.lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), ((0, 0), (0, 1), (0, 1), (0, 0)))
    ref["stem_pool"] = np.asarray(pool)
    ref["stem_out"] = np.asarray(qops.qconv2d(pool, jnp.asarray(ws2)))
    arrays.update(xs=xs, ws1=ws1, ws2=ws2)
    xp = jax.random.normal(key, (2, 32, 32, 4))
    ref["pool_fp32"] = np.asarray(jax.lax.reduce_window(
        xp, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        ((0, 0), (0, 1), (0, 1), (0, 0))))
    arrays["xp"] = np.asarray(xp)
    np.savez(d / "inputs.npz", **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = run_world([sys.executable, os.path.abspath(__file__), "spatial",
                     str(d)], 4, str(d / "rdzv"), timeout_s=60,
                    backend="gloo", env=env)
    for r in res:
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
    out = [torch.load(d / f"spatial_rank{r}.pt", weights_only=False)
           for r in range(4)]

    def whole(name):
        return _assemble({o["coord"][name]: o[name] for o in out})

    return whole, ref, out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}sp{m[1]}")
@pytest.mark.parametrize("kh,kw,stride,zp", QCONV)
def test_spatial_qconv_exact(spatial, kh, kw, stride, zp, mesh):
    whole, ref, _ = spatial
    got = whole(("qconv", kh, stride, zp, mesh))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref[(kh, stride, zp)])


def test_spatial_conv_fp32_and_chaining(spatial):
    whole, ref, out = spatial
    # the first conv's output stayed H-sharded: each block is its rows
    assert all(o["chain_mid_rows"] == 8 for o in out)
    np.testing.assert_allclose(whole("fp32_chain"), ref["fp32_chain"],
                               rtol=1e-5, atol=1e-5)


def test_spatial_depthwise(spatial):
    whole, ref, _ = spatial
    np.testing.assert_array_equal(whole("depthwise"), ref["depthwise"])


def test_spatial_rejects_bad_geometry(spatial):
    _, _, out = spatial
    for o in out:
        assert o["bad_h"] == "ValueError"
        assert o["bad_stride"] == "ValueError"


def test_spatial_rejects_halo_larger_than_shard(spatial):
    _, _, out = spatial
    for o in out:
        assert o["halo"][0] == "ValueError" and "halo" in o["halo"][1]


def test_spatial_max_pool_and_stem_chain(spatial):
    whole, ref, _ = spatial
    np.testing.assert_array_equal(whole("stem_pool"), ref["stem_pool"])
    np.testing.assert_array_equal(whole("stem_out"), ref["stem_out"])


def test_spatial_max_pool_fp32(spatial):
    whole, ref, _ = spatial
    np.testing.assert_array_equal(whole("pool_fp32"), ref["pool_fp32"])


# -- the ranks (no JAX) -------------------------------------------------------

def _rank_spatial(d):
    import torch.distributed as dist

    from qtpu_torch.parallel import (initialize_from_env, make_spatial_mesh,
                                     spatial_conv2d, spatial_local,
                                     spatial_max_pool)
    from qtpu_torch.parallel.distributed import shutdown

    initialize_from_env(backend="gloo")
    a = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(d, "inputs.npz")).items()}
    out = {"coord": {}}

    def put(name, mesh, y):
        out[name] = y.numpy()
        out["coord"][name] = (mesh.coord("data"), mesh.coord("spatial"))

    meshes = {m: make_spatial_mesh(sp=m[1], dp=m[0]) for m in MESHES}
    for m, mesh in meshes.items():
        xl = spatial_local(a["x"], mesh)
        for kh, kw, s, zp in QCONV:
            put(("qconv", kh, s, zp, m), mesh, spatial_conv2d(
                xl, a[f"w{kh}{s}"], mesh, strides=(s, s), zp=zp))
    mesh = meshes[(1, 4)]
    y = spatial_conv2d(spatial_local(a["xf"], mesh), a["w1"], mesh)
    out["chain_mid_rows"] = y.shape[1]
    put("fp32_chain", mesh, spatial_conv2d(y, a["w2"], mesh,
                                           strides=(2, 2)))
    put("depthwise", mesh, spatial_conv2d(spatial_local(a["x"], mesh),
                                          a["wd"], mesh, groups=8))
    y = spatial_conv2d(spatial_local(a["xs"], mesh), a["ws1"], mesh,
                       strides=(2, 2))
    y = torch.clamp(torch.div(y, 256, rounding_mode="floor"), -128,
                    127).to(torch.int8)
    y = spatial_max_pool(y, mesh)
    put("stem_pool", mesh, y)
    put("stem_out", mesh, spatial_conv2d(y, a["ws2"], mesh))
    put("pool_fp32", mesh, spatial_max_pool(spatial_local(a["xp"], mesh),
                                            mesh))
    for name, fn in (
            ("bad_h", lambda: spatial_local(
                torch.zeros((1, 18, 16, 4), dtype=torch.int8), mesh)),
            ("bad_stride", lambda: spatial_conv2d(
                torch.zeros((1, 3, 16, 4), dtype=torch.int8),
                torch.zeros((3, 3, 4, 4), dtype=torch.int8), mesh,
                strides=(2, 2))),
            ("halo", lambda: spatial_conv2d(
                torch.zeros((1, 2, 16, 4), dtype=torch.int8),
                torch.zeros((7, 7, 4, 4), dtype=torch.int8), mesh))):
        try:
            fn()
            out[name] = ("none", "")
        except ValueError as e:
            out[name] = ("ValueError", str(e))
    out["bad_h"], out["bad_stride"] = out["bad_h"][0], out["bad_stride"][0]
    torch.save(out, os.path.join(d, f"spatial_rank{dist.get_rank()}.pt"))
    shutdown()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
