"""qtpu_torch's torchvision checkpoint import against torchvision-named
reference nets and against qtpu's import (mirrors tests/test_import_torch.py).

The reference nets below are this file's own copies of torchvision's
module naming and geometry (conv1/bn1/layerN.M.convK/downsample/fc;
features.N.conv.* / classifier.1 for MobileNet-v2).  Every parameter and
BatchNorm statistic is randomized from a seed, the ``state_dict`` is
imported into the port's model (``torch_pad=True``) and, from the same
``.pth``, into qtpu's.  Tolerance: the port's fp32 eval logits equal the
reference net's and qtpu's to rel-L2 ≤ 1e-5 (fp32 convs in other orders).
Full-size ResNet-34/50/101 checkpoints map key for key; leftover keys and
shape mismatches raise; LeNet-5 and MobileNet-v1 are refused by name.
``examples.run --torch-ckpt`` runs end to end on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from qtpu.data.import_torch import import_torch_state as j_import
from qtpu.models import get_model as j_get_model
from qtpu_torch.data.import_torch import (import_mobilenet_v2_state,
                                          import_resnet_state,
                                          import_torch_state,
                                          load_torch_checkpoint,
                                          supported_models)
from qtpu_torch.models import get_model
from qtpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet

REL = 1e-5


def _randomize(net: tnn.Module, seed: int) -> tnn.Module:
    """Every parameter and BN running statistic from a seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        for m in net.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) + 0.5)
    return net.eval()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------ torchvision-named nets --

class TVBasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, cin, w, stride):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, w, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(w)
        self.conv2 = tnn.Conv2d(w, w, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(w)
        self.downsample = None
        if stride != 1 or cin != w:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, w, 1, stride, bias=False), tnn.BatchNorm2d(w))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idn)


class TVBottleneck(tnn.Module):
    expansion = 4

    def __init__(self, cin, w, stride):
        super().__init__()
        out = w * 4
        self.conv1 = tnn.Conv2d(cin, w, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(w)
        self.conv2 = tnn.Conv2d(w, w, 3, stride, 1, bias=False)   # v1.5
        self.bn2 = tnn.BatchNorm2d(w)
        self.conv3 = tnn.Conv2d(w, out, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, out, 1, stride, bias=False),
                tnn.BatchNorm2d(out))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idn)


class TVResNet(tnn.Module):
    """conv1/bn1/maxpool/layerN/fc, torchvision's names and geometry."""

    def __init__(self, block, stage_sizes, width, nclass):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cin, self.stages = width, []
        for i, n in enumerate(stage_sizes):
            w, blocks = width * 2 ** i, []
            for j in range(n):
                blocks.append(block(cin, w, 2 if (i > 0 and j == 0) else 1))
                cin = w * block.expansion
            setattr(self, f"layer{i + 1}", tnn.Sequential(*blocks))
            self.stages.append(f"layer{i + 1}")
        self.fc = tnn.Linear(cin, nclass)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


class TVConvBNReLU(tnn.Sequential):
    def __init__(self, cin, cout, k, stride, groups=1):
        super().__init__(
            tnn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                       bias=False),
            tnn.BatchNorm2d(cout), tnn.ReLU6(inplace=True))


class TVInvertedResidual(tnn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        layers = [TVConvBNReLU(cin, hidden, 1, 1)] if expand != 1 else []
        layers += [TVConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
                   tnn.Conv2d(hidden, cout, 1, bias=False),
                   tnn.BatchNorm2d(cout)]
        self.conv = tnn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class TVMobileNetV2(tnn.Module):
    """features.N / classifier.1, torchvision's names."""

    def __init__(self, nclass):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        feats, cin = [TVConvBNReLU(3, 32, 3, 2)], 32
        for t, c, n, s in cfg:
            for j in range(n):
                feats.append(TVInvertedResidual(cin, c, s if j == 0 else 1,
                                                t))
                cin = c
        feats.append(TVConvBNReLU(cin, 1280, 1, 1))
        self.features = tnn.Sequential(*feats)
        self.classifier = tnn.Sequential(tnn.Dropout(0.2),
                                         tnn.Linear(1280, nclass))

    def forward(self, x):
        return self.classifier(self.features(x).mean(dim=(2, 3)))


# ------------------------------------------------------------------ parity --

def _parity(tnet, port, jmodel, name, path, hw):
    """TV net → .pth → the port's model and qtpu's; logits of all three."""
    torch.save(tnet.state_dict(), path)
    sd = load_torch_checkpoint(path)
    import_torch_state(name, sd, port)
    x = torch.randn(2, 3, hw, hw, generator=torch.Generator().manual_seed(7))
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        ref = tnet(x).numpy()
        got = port(x_nhwc).numpy()
    jv = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)),
                     train=False)
    jv = j_import(name, sd, jv)
    jy = np.asarray(jmodel.apply(jv, jnp.asarray(x_nhwc.numpy()),
                                 train=False))
    assert _rel(got, ref) <= REL, _rel(got, ref)
    assert _rel(got, jy) <= REL, _rel(got, jy)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_resnet_parity(kind, tmp_path):
    tv_block, block = ((TVBasicBlock, BasicBlock) if kind == "basic"
                       else (TVBottleneck, Bottleneck))
    from qtpu.models.resnet import BasicBlock as JBasic
    from qtpu.models.resnet import Bottleneck as JBottle
    from qtpu.models.resnet import ResNet as JResNet

    ncls = 5 if kind == "basic" else 7
    tnet = _randomize(TVResNet(tv_block, (1, 2), width=8, nclass=ncls),
                      seed=0 if kind == "basic" else 1)
    port = ResNet(block, (1, 2), num_classes=ncls, width=8,
                  cifar_stem=False, torch_pad=True).eval()
    jm = JResNet(block=JBasic if kind == "basic" else JBottle,
                 stage_sizes=(1, 2), width=8, num_classes=ncls,
                 cifar_stem=False, torch_pad=True)
    _parity(tnet, port, jm, "resnet18", str(tmp_path / "r.pth"), 64)


def test_mobilenet_v2_parity(tmp_path):
    tnet = _randomize(TVMobileNetV2(nclass=11), seed=2)
    port = get_model("mobilenet_v2", num_classes=11, torch_pad=True)
    jm = j_get_model("mobilenet_v2", num_classes=11, torch_pad=True)
    _parity(tnet, port, jm, "mobilenet_v2", str(tmp_path / "m.pth"), 96)


@pytest.mark.parametrize("name,block,stages", [
    ("resnet34", TVBasicBlock, (3, 4, 6, 3)),
    ("resnet50", TVBottleneck, (3, 4, 6, 3)),
    ("resnet101", TVBottleneck, (3, 4, 23, 3))])
def test_full_resnet_key_coverage(name, block, stages):
    """Every tensor of a full-size torchvision checkpoint maps onto the
    port's model and every model tensor is filled (structure at real
    scale; the minis above hold the numbers)."""
    tnet = TVResNet(block, stages, width=64, nclass=1000)
    port = get_model(name, num_classes=1000, torch_pad=True)
    sd = tnet.state_dict()
    import_torch_state(name, sd, port)
    assert torch.equal(port.stem.conv.weight, sd["conv1.weight"])
    last = f"layer4_{stages[-1] - 1}"
    conv = "conv3" if block is TVBottleneck else "conv2"
    assert torch.equal(getattr(getattr(port, last), conv).bn.running_var,
                       sd[f"layer4.{stages[-1] - 1}.bn"
                          f"{conv[-1]}.running_var"])
    assert torch.equal(port.fc.weight, sd["fc.weight"])


def test_leftover_keys_raise():
    tnet = TVResNet(TVBasicBlock, (1,), width=8, nclass=3)
    port = ResNet(BasicBlock, (1,), num_classes=3, width=8,
                  cifar_stem=False, torch_pad=True)
    sd = dict(tnet.state_dict())
    sd["layer9.0.conv1.weight"] = torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError, match="not consumed"):
        import_resnet_state(sd, port)


def test_shape_mismatch_raises():
    tnet = TVResNet(TVBasicBlock, (1,), width=16, nclass=3)   # wrong width
    port = ResNet(BasicBlock, (1,), num_classes=3, width=8,
                  cifar_stem=False, torch_pad=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_resnet_state(tnet.state_dict(), port)


def test_missing_key_raises():
    tnet = TVMobileNetV2(nclass=3)
    sd = dict(tnet.state_dict())
    del sd["features.3.conv.1.1.running_var"]
    with pytest.raises(KeyError, match="missing"):
        import_mobilenet_v2_state(
            sd, get_model("mobilenet_v2", num_classes=3, torch_pad=True))


def test_checkpoint_wrappers_unwrapped(tmp_path):
    """A ``{"state_dict": ...}`` wrapper and DDP's ``module.`` prefix."""
    sd = TVResNet(TVBasicBlock, (1,), width=8, nclass=3).state_dict()
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, path)
    got = load_torch_checkpoint(path)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.mark.parametrize("model", ["lenet5", "mobilenet_v1"])
def test_unsupported_models_refused(model):
    from qtpu.data.import_torch import supported_models as j_supported
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.serve.cli import build_engine

    assert supported_models() == j_supported()
    assert model not in supported_models()
    with pytest.raises(ValueError, match="no torch importer"):
        import_torch_state(model, {}, None)
    cfg = next(c for c in CONFIGS.values() if c.model == model)
    with pytest.raises(SystemExit, match="no torch importer"):
        build_engine(cfg, torch_ckpt="x.pth", device="cpu")


def test_run_cli_torch_ckpt(tmp_path, capsys):
    """``examples.run --torch-ckpt model.pth``: the imported net is the fp32
    baseline (no fp32 training), then PTQ calibrates and evaluates on it
    (mirrors tests/test_import_torch.py::test_run_cli_torch_ckpt)."""
    from qtpu_torch.examples.run import main

    tnet = _randomize(TVResNet(TVBasicBlock, (2, 2, 2, 2), width=8,
                               nclass=10), seed=4)
    path = str(tmp_path / "resnet18.pth")
    torch.save(tnet.state_dict(), path)
    rc = main(["--config", "resnet18_cifar10_int8_kl", "--device", "cpu",
               "--torch-ckpt", path, "--quiet",
               "--set", "cifar_stem=False", "--set", "width=8",
               "--set", "act_observer=minmax",
               "--set", "n_train=128", "--set", "n_eval=128",
               "--set", "calib_batches=1", "--set", "batch_size=32"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["quant_top1"] <= 1.0
    assert abs(result["quant_top1"] - result["fp32_top1"]) <= 0.25
