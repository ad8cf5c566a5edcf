"""The parallel runtime's device rules on the card (no JAX: ``python -m
pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py``).

Every test here is ``gpu``-marked and skips without the cards it needs:

* the device guard and the per-device launcher state: K1, K2 and K3 each
  launched on ``cuda:1`` while ``cuda:0`` is current — the shared-memory
  opt-in, the SM count and the occupancy are the launch device's, the
  result equals the plain version on the same inputs and the current
  device is left as it was (two cards);
* tensor parallelism on one card: two ranks over gloo, both on
  ``cuda:0``, run a narrowed-resolution ResNet-50 (full width, 64² input)
  through ``ResNetInt8Engine`` over ``shard_variables``' slices — logits
  bit-equal to the unsharded engine, every K1 and K2 launch counted by
  route and none on the plain versions (one card).

The TP test starts its ranks as ``python tests/test_torch_gpu_parallel.py
tp2 <dir>``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RNG = np.random.default_rng(14)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _i8(shape):
    return torch.from_numpy(RNG.integers(-128, 128, shape).astype(np.int8))


def _launch(kernel, x, w):
    """(the kernel's raw accumulator, its plain version's)."""
    from qtpu_torch.ops import qconv, qdepthwise, qmatmul

    if kernel == "K1":
        args = dict(raw_acc=True)
        return (qmatmul.qmatmul_folded(x, w, None, None, **args),
                qmatmul.qmatmul_folded_plain(x.cpu(), w.cpu(), None, None,
                                             **args))
    if kernel == "K2":
        args = dict(kernel_hw=(3, 3), stride=1, pads=((1, 1), (1, 1)),
                    zp=0, raw_acc=True)
        return (qconv.qconv2d_folded(x, w, None, None, **args),
                qconv.qconv2d_folded_plain(x.cpu(), w.cpu(), None, None,
                                           **args))
    args = dict(kernel_hw=(3, 3), stride=1, padding="SAME", zp=0,
                raw_acc=True)
    return (qdepthwise.qdepthwise_folded(x, w, None, None, **args),
            qdepthwise.qdepthwise_folded_plain(x.cpu(), w.cpu(), None, None,
                                               **args))


SHAPES = {"K1": ((512, 256), (128, 256)),
          "K2": ((2, 28, 28, 64), (64, 9 * 64)),
          "K3": ((2, 28, 28, 96), (9, 96))}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_launch_on_second_card(two_cards, kernel):
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    xs, ws = SHAPES[kernel]
    x, w = _i8(xs).to(dev), _i8(ws).to(dev)
    got, want = _launch(kernel, x, w)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert got.device == dev
    assert torch.equal(got.cpu(), want)
    # and on cuda:0 after cuda:1: each device's opt-in is its own
    got0, _ = _launch(kernel, x.to("cuda:0"), w.to("cuda:0"))
    assert torch.equal(got0.cpu(), want)


@pytest.mark.gpu
def test_tp2_one_card_gloo(card, tmp_path):
    from qtpu_torch.parallel.launch import run_world

    res = run_world([sys.executable, os.path.abspath(__file__), "tp2",
                     str(tmp_path)], 2, str(tmp_path / "rdzv"),
                    timeout_s=300, backend="gloo")
    for r in res:
        assert r.returncode == 0, r.output
    out = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for o in out:
        assert o["equal"], o
        assert o["plain_calls"] == 0, o
        assert o["k1"] == 37 and o["k2"] == 16, o   # 52 convs + the fc
        assert o["all_gathers"] == 49, o            # 3 a block + the fc


def _tp2_rank(out_dir: str) -> int:
    """One rank of :func:`test_tp2_one_card_gloo`."""
    import dataclasses

    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.ops import qconv, qmatmul
    from qtpu_torch.parallel import collectives, distributed
    from qtpu_torch.parallel.mesh import make_mesh, shard_variables
    from qtpu_torch.serve.cli import freeze_from_config
    from qtpu_torch.serve.dispatch import resnet_arch
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine

    distributed.initialize_from_env(backend="gloo")
    dev = distributed.rank_device()
    cfg = dataclasses.replace(CONFIGS["resnet50_imagenet_int8_ptq_fp32stem"],
                              image_size=64, n_train=8, calib_batches=1,
                              batch_size=8)
    tree = (freeze_from_config(cfg, device=dev)
            if distributed.rank() == 0 else None)
    tree = distributed.broadcast_tree(tree, dev)
    arch = resnet_arch(cfg.model, num_classes=cfg.num_classes,
                       image_size=224)            # the ImageNet stem
    ref = ResNetInt8Engine(tree, arch, device=dev)
    tp = ResNetInt8Engine(shard_variables(tree, make_mesh(dp=1, tp=2)),
                          arch, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 64, 64, 3)).astype(np.float32))
    tp.forward(x)                                  # warm
    for f, routes in ((qmatmul.qmatmul_folded, ("", "_wgmma", "_igemm")),
                      (qconv.qconv2d_folded,
                       ("", "_wgmma", "_stem", "_igemm"))):
        for r in routes:
            setattr(f, f"launches{r}", 0)
    qmatmul.qmatmul_folded_plain.calls = qconv.qconv2d_folded_plain.calls = 0
    collectives.reset_counts()
    y = tp.forward(x)
    torch.cuda.synchronize()
    result = dict(
        k1=qmatmul.qmatmul_folded.launches,
        k2=qconv.qconv2d_folded.launches,
        k1_routes={k: getattr(qmatmul.qmatmul_folded, f"launches_{k}")
                   for k in ("wgmma", "igemm")},
        k2_routes={k: getattr(qconv.qconv2d_folded, f"launches_{k}")
                   for k in ("wgmma", "stem", "igemm")},
        plain_calls=(qmatmul.qmatmul_folded_plain.calls
                     + qconv.qconv2d_folded_plain.calls),
        all_gathers=collectives.counts["all_gather"],
        host_staged=collectives.counts["all_gather.host_staged"],
        equal=bool(torch.equal(y, ref.forward(x))))
    with open(os.path.join(out_dir, f"rank{distributed.rank()}.json"),
              "w") as f:
        json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["tp2"]:
        sys.exit(_tp2_rank(sys.argv[2]))
    sys.exit(f"unknown role {sys.argv[1:]}")
