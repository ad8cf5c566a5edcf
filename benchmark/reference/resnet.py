"""Plain reference of ResNet-50 v1 (He et al., "Deep Residual Learning for
Image Recognition", 2016, Table 1): a 7×7/2 stem and 3×3/2 max-pool, four
stages of bottleneck blocks (1×1 reduce, 3×3, 1×1 expand ×4, stride on the
3×3 of each stage's first block, a 1×1 projection where the shape
changes), global average pool, fully connected layer.

Departures from the paper, as the configuration states them: XLA's SAME
padding (lo = total // 2), activations NHWC at the boundary.

``param_specs`` names every weight; ``fp32_forward`` is the float model in
eval mode, reporting each quantized layer's input to ``observe``;
``int8_forward`` is integer inference over a frozen tree
(``reference.pipeline.freeze``): int8 activations between layers, the
stem in float32 when it is excluded, every other conv and the fc on
exact int32 accumulators with the folded epilogue.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import quant as Q

BN_EPS = 1e-5


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, cin, features, stride, has projection) of every block."""
    out, cin = [], cfg["width"]
    for i, n in enumerate(cfg["stage_sizes"]):
        feat = cfg["width"] * 2 ** i
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            out.append((f"layer{i + 1}_{j}", cin, feat, stride,
                        stride != 1 or cin != feat * 4))
            cin = feat * 4
    return out


def layers(cfg: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(path, OIHW weight shape, groups) of every conv, the stem first."""
    out = [("stem", (cfg["width"], cfg["in_channels"], 7, 7), 1)]
    for name, cin, f, _, proj in blocks(cfg):
        out += [(f"{name}/conv1", (f, cin, 1, 1), 1),
                (f"{name}/conv2", (f, f, 3, 3), 1),
                (f"{name}/conv3", (4 * f, f, 1, 1), 1)]
        if proj:
            out.append((f"{name}/down", (4 * f, cin, 1, 1), 1))
    return out


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic, in
    the parameter names of the layers' paths ("/" → ".")."""
    specs = []
    for path, shape, _ in layers(cfg):
        p = path.replace("/", ".")
        specs.append((f"{p}.conv.weight", shape, "conv"))
        specs.append((f"{p}.bn", (shape[0],), "bn"))
    feat = cfg["width"] * 8 * 4
    specs.append(("fc.weight", (cfg["num_classes"], feat), "fc"))
    specs.append(("fc.bias", (cfg["num_classes"],), "bias"))
    return specs


def _conv_bn(params: Dict, path: str, x: torch.Tensor, stride: int,
             act: bool) -> torch.Tensor:
    p = path.replace("/", ".")
    y = Q.bn_eval(Q.fp32_conv_nhwc(x, params[f"{p}.conv.weight"], stride),
                  params[f"{p}.bn"], BN_EPS)
    return torch.relu(y) if act else y


def fp32_forward(cfg: dict, params: Dict, x: torch.Tensor,
                 observe: Callable[[str, torch.Tensor], None]
                 ) -> torch.Tensor:
    """The float model (BatchNorm on running statistics) on NHWC ``x``."""
    x = _conv_bn(params, "stem", x.permute(0, 3, 1, 2), 2, True)
    (hlo, hhi), (wlo, whi) = Q.same_pads(x.shape[2:], (3, 3), (2, 2))
    x = F.max_pool2d(F.pad(x, (wlo, whi, hlo, hhi), value=float("-inf")),
                     3, 2)
    for name, _, _, stride, proj in blocks(cfg):
        observe(f"{name}/conv1", x)
        y = _conv_bn(params, f"{name}/conv1", x, 1, True)
        observe(f"{name}/conv2", y)
        y = _conv_bn(params, f"{name}/conv2", y, stride, True)
        observe(f"{name}/conv3", y)
        y = _conv_bn(params, f"{name}/conv3", y, 1, False)
        if proj:
            observe(f"{name}/down", x)
            r = _conv_bn(params, f"{name}/down", x, stride, False)
        else:
            r = x
        x = torch.relu(y + r)
    pooled = torch.mean(x, dim=(2, 3))
    observe("fc", pooled)
    with Q.fp32_exact():
        return F.linear(pooled, params["fc.weight"], params["fc.bias"])


def _maxpool_codes(y_q: torch.Tensor) -> torch.Tensor:
    pads = Q.same_pads(y_q.shape[1:3], (3, 3), (2, 2))
    yp = Q.pad_nhwc(y_q, pads, -128)
    Hp, Wp = yp.shape[1:3]
    OH, OW = (Hp - 3) // 2 + 1, (Wp - 3) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            s = yp[:, dy:dy + 2 * (OH - 1) + 1:2, dx:dx + 2 * (OW - 1) + 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


def int8_forward(cfg: dict, tree: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of the frozen ``tree`` on normalized float32 NHWC ``x``."""
    bl = blocks(cfg)
    first = tree[f"{bl[0][0]}/conv1"]["grid"]
    y = torch.clamp_min(Q.stem_fp32(tree["stem"], x, 2), 0.0)
    x_q = _maxpool_codes(Q.quantize_act(y, first))
    grid = first
    for k, (name, _, _, stride, proj) in enumerate(bl):
        c1, c2, c3 = (tree[f"{name}/conv{i}"] for i in (1, 2, 3))
        nxt = (tree[f"{bl[k + 1][0]}/conv1"]["grid"] if k + 1 < len(bl)
               else tree["fc"]["grid"])
        a = Q.apply(Q.matmul_acc(x_q, c1["w"]),
                    Q.node_epilogue(c1, out_grid=c2["grid"], relu=True))
        b = Q.apply(Q.conv_acc(a, c2["w"], stride, c2["grid"].zp),
                    Q.node_epilogue(c2, out_grid=c3["grid"], relu=True))
        if proj:
            down = tree[f"{name}/down"]
            x_d = x_q[:, ::stride, ::stride, :]
            res = Q.apply(Q.matmul_acc(x_d, down["w"]),
                          Q.node_epilogue(down))
            e3 = Q.node_epilogue(c3, out_grid=nxt, relu=True, res_f32=True)
        else:
            res = x_q
            e3 = Q.node_epilogue(c3, out_grid=nxt, relu=True, res_grid=grid)
        x_q = Q.apply(Q.matmul_acc(b, c3["w"]), e3, res)
        grid = nxt
    pooled = torch.mean(Q.dequant(x_q, grid), dim=(1, 2))
    return Q.fc_int8(tree["fc"], pooled)
