"""qtpu_torch histogram observer, KL threshold search and KL calibration
against qtpu's, on the CPU (mirrors tests/test_calib.py).

* ``hist_update`` bins exactly as qtpu's: the counts of the same seeded
  numpy batches are **equal** (float32 arrays compared bit for bit), the
  2^24 case included; counts sum to n, values above amax clamp to the last
  bin.
* ``kl_threshold`` (the port's own copy) returns **equal** thresholds on
  the same histograms; int4 clips no wider than int8; an empty histogram
  falls back to amax.
* ``calibrate`` with ``act_observer="kl"`` on a narrowed ResNet-18 (CIFAR
  stem, stage sizes (1, 1, 1, 1), width 8), a narrowed ResNet-20 (stage
  sizes (1, 1, 1), width 8) and on LeNet-5, with qtpu's
  seeded weights carried across by ``load_flax_variables``, on the same
  numpy batches.  The first layer's input is the batch itself, so its
  histogram, threshold and ``act_scale`` are equal.  Deeper layers'
  histograms come from two fp32 conv implementations (XLA's and
  PyTorch's), which sum in different orders: a value on a bin edge may
  change bins, so their ``hist_amax`` agrees to rtol 1e-5, their counts
  hold the same total and cumulative counts within max(2, 1e-3 of the
  total) at every bin (each moved value shifts one bin's cumulative count
  by one), and their thresholds agree to within one bin width (``amax /
  2048``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.calib import kl as jkl
from qtpu.calib import observers as jobs
from qtpu.models import get_model as j_get_model
from qtpu.nn import LayerQuantSpec as JSpec
from qtpu.nn import QuantPolicy as JPolicy
from qtpu.transform import calibrate as j_calibrate
from qtpu.transform import convert_model
from qtpu_torch.calib import kl as tkl
from qtpu_torch.calib import observers as tobs
from qtpu_torch.models import get_model, load_flax_variables
from qtpu_torch.nn import LayerQuantSpec, QuantMode, QuantPolicy
from qtpu_torch.nn.act_quant import ActQuant
from qtpu_torch.transform import calibrate

KEY = jax.random.PRNGKey(0)


def _batches(seed, shapes, outliers=False):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        x = rng.standard_normal(s).astype(np.float32)
        if outliers:
            x.reshape(-1)[:5] *= 60.0
        out.append(x)
    return out


def _port_hist(batches, amax, nbins):
    st = tobs.hist_set_range(tobs.hist_init(nbins), np.float32(amax))
    for b in batches:
        st = tobs.hist_update(st, torch.from_numpy(b))
    return st


def _qtpu_hist(batches, amax, nbins):
    st = jobs.hist_set_range(jobs.hist_init(nbins), jnp.float32(amax))
    for b in batches:
        st = jobs.hist_update(st, jnp.asarray(b))
    return st


def test_hist_counts_sum_to_n():
    st = tobs.hist_set_range(tobs.hist_init(64), 1.0)
    st = tobs.hist_update(st, torch.linspace(-1, 1, 1000))
    assert float(st["counts"].sum()) == 1000.0
    assert st["counts"].dtype == torch.float32


def test_hist_overflow_clamps_to_last_bin():
    st = tobs.hist_set_range(tobs.hist_init(16), 1.0)
    st = tobs.hist_update(st, torch.tensor([10.0, -20.0]))
    assert float(st["counts"][-1]) == 2.0


def test_hist_counts_do_not_saturate_at_2_24():
    """A bin already at 2^24 still gains a batch's 1000 (counted in
    integers first, then added), as qtpu's."""
    st = tobs.hist_set_range(tobs.hist_init(8), 1.0)
    st["counts"][0] = 2.0 ** 24
    st = tobs.hist_update(st, torch.zeros(1000))
    assert float(st["counts"][0]) == 2.0 ** 24 + 1000.0
    js = jobs.hist_set_range(jobs.hist_init(nbins=8), jnp.float32(1.0))
    js = {**js, "counts": js["counts"].at[0].set(2.0 ** 24)}
    js = jobs.hist_update(js, jnp.zeros((1000,), jnp.float32))
    np.testing.assert_array_equal(st["counts"].numpy(),
                                  np.asarray(js["counts"]))


@pytest.mark.parametrize("nbins,outliers", [(2048, False), (2048, True),
                                            (64, False)])
def test_hist_update_matches_qtpu(nbins, outliers):
    """Three batches of different shapes into one histogram: counts equal
    to qtpu's bit for bit; amax a float32 value off every power of two."""
    batches = _batches(3, [(4, 7, 7, 8), (2, 9, 5, 3), (1000,)], outliers)
    amax = float(np.float32(max(np.abs(b).max() for b in batches) * 0.9))
    got = _port_hist(batches, amax, nbins)
    ref = _qtpu_hist(batches, amax, nbins)
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(ref["counts"]))
    assert float(got["amax"]) == float(ref["amax"])
    assert float(got["counts"].sum()) == sum(b.size for b in batches)


@pytest.mark.parametrize("dist", ["gaussian", "laplace", "outliers",
                                  "relu"])
@pytest.mark.parametrize("bits", [8, 4])
def test_kl_threshold_matches_qtpu(dist, bits):
    """The port's copy of the search returns qtpu's threshold on the same
    device-built histogram (2048 bins, 200k samples)."""
    rng = np.random.default_rng(7)
    x = (rng.laplace(size=200_000) if dist == "laplace"
         else rng.standard_normal(200_000)).astype(np.float32)
    if dist == "outliers":
        x[:10] *= 100.0
    if dist == "relu":
        x = np.maximum(x, 0.0)
    amax = float(np.abs(x).max())
    counts = _port_hist([x], amax, tobs.HIST_NBINS)["counts"].numpy()
    t = tkl.kl_threshold(counts, amax, bits=bits)
    assert t == jkl.kl_threshold(counts, amax, bits=bits)
    assert 0 < t <= amax


def test_kl_threshold_behaviour():
    """tests/test_calib.py's properties on the port's copy: a Gaussian
    keeps the mass above its 95th percentile, gross outliers are clipped,
    int4 clips no wider than int8, an empty histogram falls back."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(200_000)
    counts, _ = np.histogram(np.abs(x), bins=2048, range=(0.0, np.abs(x).max()))
    amax = float(np.abs(x).max())
    t8 = tkl.kl_threshold(counts, amax, bits=8)
    assert np.quantile(np.abs(x), 0.95) < t8 <= amax
    assert tkl.kl_threshold(counts, amax, bits=4) <= t8 * 1.05
    x[:10] *= 100.0
    counts, _ = np.histogram(np.abs(x), bins=2048, range=(0.0, np.abs(x).max()))
    assert tkl.kl_threshold(counts, float(np.abs(x).max())) < \
        0.5 * float(np.abs(x).max())
    assert tkl.kl_threshold(np.zeros(2048), 1.0) == 1.0


def test_minmax_finalizers_match_qtpu():
    st = tobs.minmax_update(tobs.minmax_init(), torch.tensor([-0.7, 2.3]))
    js = jobs.minmax_update(jobs.minmax_init(), jnp.array([-0.7, 2.3]))
    for bits in (8, 4):
        s, z = tobs.minmax_to_affine(st, bits)
        js_, jz = jobs.minmax_to_affine(js, bits)
        assert float(s) == float(js_) and float(z) == float(jz)
        assert float(tobs.minmax_to_symmetric(st, bits)) == float(
            jobs.minmax_to_symmetric(js, bits))


# -- calibrate with the KL observer, against qtpu's ----------------------------

MODELS = {
    "resnet18": dict(kw=dict(num_classes=10, cifar_stem=True, width=8),
                     stages=(1, 1, 1, 1), shape=(4, 16, 16, 3),
                     first="stem"),
    "resnet20": dict(kw=dict(num_classes=10, cifar_stem=True, width=8),
                     stages=(1, 1, 1), shape=(4, 16, 16, 3), first="stem"),
    "lenet5": dict(kw=dict(num_classes=10), stages=None,
                   shape=(4, 28, 28, 1), first="conv1"),
}


def _kl_pair(name):
    """qtpu's and the port's calibration of the same seeded model on the
    same two batches, every layer on the KL observer."""
    c = MODELS[name]
    m = j_get_model(name, **c["kw"])
    if c["stages"]:
        m = m.clone(stage_sizes=c["stages"])
    batches = _batches(11, [c["shape"], c["shape"]])
    jpol = JPolicy(default=JSpec(act_observer="kl"))
    qm = convert_model(m, jpol)
    v = dict(jax.jit(qm.init)(KEY, jnp.asarray(batches[0])))
    jv = j_calibrate(qm, v, [jnp.asarray(b) for b in batches])
    tm = get_model(name, **c["kw"], **({"stage_sizes": c["stages"]}
                                      if c["stages"] else {}))
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, v["params"]),
                        jax.tree_util.tree_map(np.asarray,
                                               v.get("batch_stats", {})))
    pol = QuantPolicy(default=LayerQuantSpec(act_observer="kl"))
    return c, jv, calibrate(tm, pol, batches), (tm, pol, batches)


@pytest.fixture(scope="module", params=sorted(MODELS))
def kl_pair(request):
    return _kl_pair(request.param)


def _jnode(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree["in_q"]


def test_kl_calibrate_matches_qtpu(kl_pair):
    c, jv, got, _ = kl_pair
    stats, qparams = got["quant_stats"], got["quant_params"]
    assert set(got["seconds"]) == {"range", "hist", "search"}
    for path, st in stats.items():
        js = _jnode(jv["quant_stats"], path)
        jq = _jnode(jv["quant_params"], path)
        amax, jamax = float(st["hist_amax"]), float(js["hist_amax"])
        counts, jcounts = st["hist"].numpy(), np.asarray(js["hist"])
        t = tkl.kl_threshold(counts, amax)
        jt = jkl.kl_threshold(jcounts, jamax)
        assert float(qparams[path]["act_zp"]) == 0.0
        if path == c["first"]:
            # the batch itself: equal histogram, threshold and scale
            assert amax == jamax, path
            np.testing.assert_array_equal(counts, jcounts, err_msg=path)
            assert t == jt
            assert float(qparams[path]["act_scale"]) == float(
                jq["act_scale"])
            continue
        np.testing.assert_allclose(amax, jamax, rtol=1e-5, err_msg=path)
        n = float(jcounts.sum())
        assert float(counts.sum()) == n, path
        moved = np.abs(np.cumsum(counts, dtype=np.float64)
                       - np.cumsum(jcounts, dtype=np.float64)).max()
        assert moved <= max(2.0, 1e-3 * n), (path, moved)
        assert abs(t - jt) <= jamax / tobs.HIST_NBINS, (path, t, jt)


def test_kl_calibrate_is_idempotent(kl_pair):
    """A second calibrate of the same model starts from fresh state."""
    _, _, got, args = kl_pair
    again = calibrate(*args)
    for path, q in got["quant_params"].items():
        assert float(q["act_scale"]) == float(
            again["quant_params"][path]["act_scale"])
        np.testing.assert_array_equal(
            got["quant_stats"][path]["hist"].numpy(),
            again["quant_stats"][path]["hist"].numpy())


def test_pact_still_raises():
    """Calibration takes PACT layers now, recording (0, α); the integer
    forward still refuses them (their α needs the fake-quant gradient)."""
    m = get_model("lenet5", num_classes=10)
    pol = QuantPolicy(default=LayerQuantSpec(act_observer="pact"))
    got = calibrate(m, pol, [np.zeros((1, 28, 28, 1), np.float32)])
    assert float(got["quant_stats"]["conv1"]["max"]) == 6.0
    aq = ActQuant(LayerQuantSpec(act_observer="pact"))
    with pytest.raises(ValueError, match="PACT"):
        aq(torch.zeros(2, 2), QuantMode.QUANT_EMA, emit_qparams=True)
