"""The launchable server of qtpu_torch on the CPU (mirrors
tests/test_serve_cli.py): ``python -m qtpu_torch.serve`` as a subprocess
(READY line, ``/predict``, ``/healthz``, ``/stats``, SIGTERM → rc 0 and
the STOPPED line), the multi-rank flags (``--tp 2``, ``--dp 2`` and
``--round-timeout`` each under a two-rank gloo launch: both ranks serve
their own clients, the READY lines name the mesh, the processes and the
backend, SIGTERM stops both with rc 0), the refusals (no card without
``--device cpu``, a mesh of more ranks than run, ``--uint8-ingest`` on
the module path),
``--save-frozen``/``--load-frozen``, and ``build_engine`` against qtpu's
``build_engine`` with the same flags:

* the host int8 ingest (``--uint8-ingest`` onto a quantized stem) and the
  bf16 stem (``--stem-dtype bfloat16``), each on the tree qtpu's
  ``build_engine`` froze, carried over (``serve/frozen.from_numpy_tree``)
  and served through ``--load-frozen``: the host codes equal qtpu's, the
  stem's output codes follow the tie rule (equal, except one step on at
  most 0.1% of elements), and the logits agree to rel-L2 ≤ 1e-4 with
  equal argmax against qtpu's ``_forward`` with the same flags run op by
  op; against qtpu's served logits, to within 1e-4 of the distance from
  its op-by-op forward to them (its jitted forward moves codes at ties,
  ROADMAP C10: 3.8e-3 rel-L2 for the bf16 stem);
* the whole slice: one torchvision-named ``.pth`` of seeded weights into
  qtpu's ``build_engine(torch_ckpt=...)`` and the port's: the frozen trees
  are equal (int8 and int32 leaves exactly, f32 leaves to rtol 1e-6) and
  the logits agree to rel-L2 ≤ 1e-4 with equal argmax.

The configs are narrowed (width 8, a few calibration images); the ImageNet
and torch-checkpoint cases serve at 96² because qtpu's ``resnet_arch``
takes ``cifar_stem = image_size ≤ 64`` where the model takes the config's
flag (ROADMAP C9): at 32² qtpu's engine would run a CIFAR stem over the
model's ImageNet stem.
"""
import dataclasses
import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.examples.configs import CONFIGS as J_CONFIGS
from qtpu.serve.cli import build_engine as j_build_engine
from qtpu.serve.fused_ops import grid_of as j_grid_of
from qtpu.serve.resnet_engine import ResNetInt8Engine as JEngine
from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.serve.cli import build_engine, main
from qtpu_torch.serve.fused_ops import grid_of
from qtpu_torch.serve.frozen import from_numpy_tree
from qtpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(image_size=96, num_classes=10, width=8, n_train=8,
             calib_batches=1, batch_size=4)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_codes(a, b, frac=1e-3):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def _post_npy(url, arr, timeout=60):
    buf = io.BytesIO()
    np.save(buf, arr)
    r = urllib.request.urlopen(url, buf.getvalue(), timeout=timeout)
    return np.load(io.BytesIO(r.read()))


# -- the server process -----------------------------------------------------

def _lines(proc):
    """The process's stdout lines on a queue (reads never block a test)."""
    q = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    return q


def _wait_for(q, prefix, timeout):
    seen, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = q.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        if line.startswith(prefix):
            return json.loads(line[len(prefix):]), seen
    raise AssertionError(f"no {prefix} line:\n" + "".join(seen))


def test_server_process_end_to_end():
    proc = subprocess.Popen(
        [sys.executable, "-m", "qtpu_torch.serve", "--config",
         "lenet_mnist_int8", "--device", "cpu", "--port", "0", "--host",
         "127.0.0.1", "--buckets", "2,4", "--max-wait-ms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    try:
        q = _lines(proc)
        info, _ = _wait_for(q, "QTPU_SERVE_READY ", 240)
        assert info["device"] == "cpu" and info["serve_path"] == "module"
        assert info["raw_dtype"] == "float32" and info["buckets"] == [2, 4]
        url = f"http://127.0.0.1:{info['port']}"
        imgs = np.random.default_rng(0).normal(
            size=(4, 28, 28, 1)).astype(np.float32)
        logits = _post_npy(url + "/predict", imgs)
        assert logits.shape == (4, 10) and np.isfinite(logits).all()
        assert urllib.request.urlopen(url + "/healthz",
                                      timeout=30).status == 200
        stats = json.loads(urllib.request.urlopen(url + "/stats",
                                                  timeout=30).read())
        assert stats["images"] >= 4 and stats["rounds_per_bucket"]
        proc.send_signal(signal.SIGTERM)
        stopped, _ = _wait_for(q, "QTPU_SERVE_STOPPED ", 60)
        assert stopped["images"] == stats["images"]
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_no_card_without_device_cpu_exits():
    """Without ``--device cpu`` and without a card the server stops with
    ``resolve_device``'s message; it never carries on on the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "qtpu_torch.serve",
                        "--config", "lenet_mnist_int8", "--port", "0"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "QTPU_SERVE_READY" not in r.stdout


def _ready_line(path, proc, timeout):
    """The READY info a rank printed to its log file."""
    prefix = "QTPU_SERVE_READY "
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in path.read_text().splitlines():
            if line.startswith(prefix):
                return json.loads(line[len(prefix):])
        assert proc.poll() is None, path.read_text()
        time.sleep(0.05)
    raise AssertionError(f"no READY line:\n{path.read_text()}")


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--round-timeout", "5"]])
def test_multi_host_flags_exit(flags, tmp_path):
    """Each multi-rank flag under a two-rank launch (``QTPU_*`` variables,
    gloo): both ranks serve their own clients — the same tree, so the same
    image gets the same logits from either rank — and exit 0 on SIGTERM."""
    from qtpu_torch.parallel.launch import join_world, kill_world, start_world

    cmd = [sys.executable, "-m", "qtpu_torch.serve", "--config",
           "lenet_mnist_int8", "--device", "cpu", "--port", "0",
           "--host", "127.0.0.1", "--buckets", "2,4", *flags]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = start_world(cmd, 2, str(tmp_path / "rdzv"), env=env, cwd=ROOT)
    try:
        infos = [_ready_line(out, p, 120) for p, out in procs]
        imgs = np.random.default_rng(1).normal(
            size=(3, 28, 28, 1)).astype(np.float32)
        got = [_post_npy(f"http://127.0.0.1:{i['port']}/predict",
                         imgs[:2 + r]) for r, i in enumerate(infos)]
        for p, _ in procs:
            p.send_signal(signal.SIGTERM)
        res = join_world(procs, 60)
    finally:
        kill_world(procs)
    tp = 2 if flags[0] == "--tp" else 1
    for r, (i, res_r) in enumerate(zip(infos, res)):
        assert res_r.returncode == 0, res_r.output
        assert "QTPU_SERVE_STOPPED " in res_r.output
        assert i["mesh"] == f"dp={2 // tp},tp={tp}" and i["rank"] == r
        assert i["processes"] == 2 and i["backend"] == "gloo"
        assert i["buckets"] == [2, 4]
        assert i["watchdog"] is (flags[0] == "--round-timeout")
        assert got[r].shape == (2 + r, 10) and np.isfinite(got[r]).all()
    if flags[0] == "--round-timeout":
        assert infos[0]["round_timeout_s"] == 5.0
    np.testing.assert_array_equal(got[0], got[1][:2])


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--tp", "0"]])
def test_mesh_needs_its_ranks(flags, capsys):
    """One process cannot be a mesh of two: the CLI says how to start the
    ranks instead of serving a mesh that is not there."""
    with pytest.raises(SystemExit) as e:
        main(["--config", "lenet_mnist_int8", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert "QTPU_COORDINATOR" in capsys.readouterr().err


def test_uint8_ingest_refused_on_module_path():
    with pytest.raises(SystemExit, match="flat-engine"):
        build_engine(CONFIGS["lenet_mnist_int8"], uint8_ingest=True,
                     device="cpu")


def test_conflicting_weight_sources_refused():
    cfg = CONFIGS["resnet50_imagenet_int8_ptq"]
    for kw in (dict(torch_ckpt="x.pth", load_state="y"),
               dict(torch_ckpt="x.pth", load_frozen="z"),
               dict(load_state="y", load_frozen="z")):
        with pytest.raises(SystemExit, match="conflict"):
            build_engine(cfg, device="cpu", **kw)


def test_save_frozen_load_frozen_roundtrip(tmp_path):
    cfg = dataclasses.replace(CONFIGS["lenet_mnist_int8"], n_train=64,
                              calib_batches=2, batch_size=16)
    frozen = str(tmp_path / "frozen")
    x = np.random.default_rng(5).normal(size=(4, 28, 28, 1)).astype(
        np.float32)
    eng_a, info_a = build_engine(cfg, buckets=(4,), max_wait_ms=50.0,
                                 save_frozen=frozen, device="cpu")
    try:
        y_a = eng_a.predict(x)
    finally:
        eng_a.stop()
    eng_b, info_b = build_engine(cfg, buckets=(4,), max_wait_ms=50.0,
                                 load_frozen=frozen, device="cpu")
    try:
        y_b = eng_b.predict(x)
    finally:
        eng_b.stop()
    assert info_a["calib_seconds"] and info_b["calib_seconds"] is None
    np.testing.assert_array_equal(y_a, y_b)


# -- against qtpu's build_engine on one carried-over tree --------------------

def _carried(j_engine, tmp_path):
    """qtpu's frozen tree as the port's, saved for ``--load-frozen``."""
    tree = from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                  j_engine.vars),
                           device="cpu")
    path = str(tmp_path / "carried")
    ckpt.save(path, tree)
    return path


@pytest.mark.parametrize("case", ["int8_ingest", "bf16_stem"])
def test_against_qtpu_build_engine(case, tmp_path):
    ingest = case == "int8_ingest"
    name = ("resnet50_imagenet_int8_ptq" if ingest
            else "resnet50_imagenet_int8_ptq_fp32stem")
    jcfg = dataclasses.replace(J_CONFIGS[name], **SMALL)
    cfg = dataclasses.replace(CONFIGS[name], **SMALL)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    flags = (dict(uint8_ingest=True, mean=mean, std=std) if ingest else {})
    rng = np.random.default_rng(11)
    x8 = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    x = (x8 if ingest else
         rng.standard_normal((4, 96, 96, 3)).astype(np.float32))
    jeng, jinfo = j_build_engine(
        jcfg, buckets=(4,), max_wait_ms=50.0,
        stem_dtype=None if ingest else jnp.bfloat16, **flags)
    try:
        j_served = jeng.predict(x)
        path = _carried(jeng, tmp_path)
        jtree = jeng.vars
    finally:
        jeng.stop()
    eng, info = build_engine(
        cfg, buckets=(4,), max_wait_ms=50.0, load_frozen=path,
        stem_dtype=None if ingest else torch.bfloat16, device="cpu",
        **flags)
    try:
        served = eng.predict(x)
    finally:
        eng.stop()
    assert (info["serve_path"], info["raw_dtype"]) == (
        jinfo["serve_path"], jinfo["raw_dtype"])

    # qtpu's engine op by op on the same tree and flags, and the port's
    from qtpu.serve.dispatch import resnet_arch as j_arch
    from qtpu_torch.serve.dispatch import resnet_arch
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    jflat = JEngine(jtree, j_arch("resnet50", num_classes=10, image_size=96,
                                  width=8),
                    stem_dtype=jnp.float32 if ingest else jnp.bfloat16,
                    normalize=(mean, std) if ingest else None)
    tflat = ResNetInt8Engine(ckpt.load(path),
                             resnet_arch("resnet50", num_classes=10,
                                         image_size=96, width=8,
                                         cifar_stem=False),
                             device="cpu",
                             stem_dtype=None if ingest else torch.bfloat16)
    if ingest:
        from qtpu.data.native import preprocess_quantize as j_pq
        from qtpu_torch.data.native import preprocess_quantize

        s, zp = tflat.stem_grid()[:2]
        codes = preprocess_quantize(x8, mean, std, s, zp)
        np.testing.assert_array_equal(
            codes, j_pq(x8, np.asarray(mean, np.float32),
                        np.asarray(std, np.float32), s, zp))
        j_in, t_in = jnp.asarray(codes), torch.from_numpy(codes)
    else:
        j_in, t_in = jnp.asarray(x), torch.from_numpy(x)
    first = tflat._block_names()[0][0]
    j_stem = jflat._stem(j_in, j_grid_of(jflat._node(first, "conv1")),
                         pre_quantized=ingest)
    t_stem = tflat._stem(t_in, grid_of(tflat._node(first, "conv1")),
                         pre_quantized=ingest)
    assert_codes(t_stem.numpy(), j_stem)
    j_ref = np.asarray(jflat._forward(j_in, pre_quantized=ingest))
    assert served.shape == (4, 10) and np.isfinite(served).all()
    assert rel_l2(served, j_ref) <= 1e-4, rel_l2(served, j_ref)
    # qtpu's served (jitted) logits: no further off than its own op-by-op
    # forward is from them
    assert rel_l2(served, j_served) <= rel_l2(j_ref, j_served) + 1e-4, (
        rel_l2(served, j_served), rel_l2(j_ref, j_served))
    assert (served.argmax(-1) == j_ref.argmax(-1)).all()


def test_whole_slice_torch_ckpt_against_qtpu(tmp_path):
    """One torchvision ``.pth`` → qtpu's and the port's ``build_engine``."""
    from test_torch_import_torch import TVBasicBlock, TVResNet, _randomize

    tnet = _randomize(TVResNet(TVBasicBlock, (2, 2, 2, 2), width=8,
                               nclass=10), seed=5)
    pth = str(tmp_path / "r18.pth")
    torch.save(tnet.state_dict(), pth)
    narrow = dict(cifar_stem=False, width=8, act_observer="minmax",
                  n_train=64, calib_batches=1, batch_size=16,
                  image_size=96)
    jeng, jinfo = j_build_engine(
        dataclasses.replace(J_CONFIGS["resnet18_cifar10_int8_kl"], **narrow),
        buckets=(4,), max_wait_ms=50.0, torch_ckpt=pth)
    x = np.random.default_rng(2).random((4, 96, 96, 3)).astype(np.float32)
    try:
        j_logits = jeng.predict(x)
        jtree = jax.tree_util.tree_map(np.asarray, jeng.vars)
    finally:
        jeng.stop()
    eng, info = build_engine(
        dataclasses.replace(CONFIGS["resnet18_cifar10_int8_kl"], **narrow),
        buckets=(4,), max_wait_ms=50.0, torch_ckpt=pth, device="cpu")
    try:
        logits = eng.predict(x)
        tree = eng.vars
    finally:
        eng.stop()
    assert info["serve_path"] == jinfo["serve_path"] == "flat-engine"
    assert info["torch_pad"] is True

    def leaves(t, p=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{p}/{k}")
            else:
                yield f"{p}/{k}", v
    jl, tl = dict(leaves(jtree)), dict(leaves(tree))
    assert set(jl) == set(tl)
    for k, jv in jl.items():
        tv = tl[k]
        if k.endswith("act_sym"):
            assert bool(tv) == bool(jv), k
            continue
        tv = tv.numpy()
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, k
        if np.issubdtype(jv.dtype, np.integer):
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0,
                                       err_msg=k)
    assert rel_l2(logits, j_logits) <= 1e-4, rel_l2(logits, j_logits)
    assert (logits.argmax(-1) == j_logits.argmax(-1)).all()
