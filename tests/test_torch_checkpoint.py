"""qtpu_torch's checkpoints (``utils/checkpoint.py`` on ``torch.save``;
no JAX): a frozen serving tree round-trips leaf for leaf (dtype, shape and
value equal; ``_`` cache keys dropped; ``act_sym`` back as a Python
bool), a ``target`` that differs in structure, dtype or shape raises, and
``examples.run --save-state`` then ``--load-state`` gives the same fp32
baseline and quantized results (equal, no tolerance)."""
import dataclasses
import json

import pytest
import torch

from qtpu_torch.examples.configs import CONFIGS
from qtpu_torch.serve.cli import freeze_from_config
from qtpu_torch.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def tree():
    """A narrowed fp32-stem ResNet-50's frozen tree: int8 ``qweights``,
    the stem's fp32 ``params``/``batch_stats``."""
    cfg = dataclasses.replace(
        CONFIGS["resnet50_imagenet_int8_ptq_fp32stem"], image_size=32,
        num_classes=10, width=8, n_train=8, calib_batches=1, batch_size=4)
    return freeze_from_config(cfg, device="cpu")


def _leaves(t, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_frozen_tree_round_trip(tree, tmp_path):
    cached = {**tree, "qweights": {
        **tree["qweights"], "fc": {**tree["qweights"]["fc"],
                                   "_epi": {"memo": torch.ones(2)}}}}
    ckpt.save(str(tmp_path / "frozen"), cached)
    got = ckpt.load(str(tmp_path / "frozen"), target=tree)
    want = dict(_leaves(tree))
    have = dict(_leaves(got))
    assert set(have) == set(want) and "/qweights/fc/_epi/memo" not in have
    assert {"params", "batch_stats"} <= set(got) and got["params"]["stem"]
    for k, v in want.items():
        if k.endswith("act_sym"):
            assert type(have[k]) is bool and have[k] == v, k
        else:
            assert have[k].dtype == v.dtype, k
            assert have[k].shape == v.shape, k
            assert torch.equal(have[k], v), k
    assert any(v.dtype == torch.int8 for v in have.values()
               if isinstance(v, torch.Tensor))


def test_target_mismatch_raises(tree, tmp_path):
    path = str(tmp_path / "frozen")
    ckpt.save(path, tree)
    node = tree["qweights"]["fc"]
    for bad in ({**node, "bias": node["bias"][:-1]},            # shape
                {**node, "bias": node["bias"].double()},        # dtype
                {**node, "extra": torch.zeros(1)},              # structure
                {**node, "act_sym": torch.zeros(())}):          # bool leaf
        target = {**tree, "qweights": {**tree["qweights"], "fc": bad}}
        with pytest.raises(ValueError, match="checkpoint"):
            ckpt.load(path, target=target)


def test_save_state_then_load_state(tmp_path, capsys):
    from qtpu_torch.examples.run import main

    state = str(tmp_path / "state")
    common = ["--config", "lenet_mnist_int8", "--device", "cpu", "--quiet",
              "--set", "n_train=256", "--set", "n_eval=128",
              "--set", "batch_size=64", "--set", "calib_batches=1"]
    assert main([*common, "--set", "fp32_epochs=1",
                 "--save-state", state]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # no training on load: a different fp32 budget must not matter
    assert main([*common, "--set", "fp32_epochs=3",
                 "--load-state", state]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("fp32_top1", "fp32_top5", "quant_top1", "quant_top5"):
        assert first[k] == second[k], k
    sd = ckpt.load(state)
    assert set(sd) >= {"conv1.conv.weight", "fc3.weight"}
