"""Plain reference of MobileNet-v2 1.0 (Sandler et al., "MobileNetV2:
Inverted Residuals and Linear Bottlenecks", 2018, Table 2): a 3×3/2 stem of
32 channels, 17 inverted residuals (1×1 expand by t, ReLU6; 3×3 depthwise,
ReLU6; 1×1 linear project; the input added where stride is 1 and the
channels match), a 1×1 head of 1280 with ReLU6, global average pool, fully
connected layer.

Departures from the paper, as the configuration states them: XLA's SAME
padding (lo = total // 2), activations NHWC at the boundary.  Interfaces
as ``reference.resnet``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import quant as Q

BN_EPS = 1e-5


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, expansion t, stride) of the inverted residuals,
    from the configuration's ``(t, c, n, s)`` rows."""
    out, cin = [], cfg["stem_channels"]
    for t, c, n, s in cfg["inverted_residuals"]:
        for j in range(n):
            out.append((f"block{len(out)}", cin, c, t, s if j == 0 else 1))
            cin = c
    return out


def layers(cfg: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(path, OIHW weight shape, groups) of every conv, the stem first."""
    out = [("stem", (cfg["stem_channels"], cfg["in_channels"], 3, 3), 1)]
    for name, cin, cout, t, _ in blocks(cfg):
        hid = cin * t
        if t != 1:
            out.append((f"{name}/expand", (hid, cin, 1, 1), 1))
        out += [(f"{name}/dw", (hid, 1, 3, 3), hid),
                (f"{name}/project", (cout, hid, 1, 1), 1)]
    last = cfg["inverted_residuals"][-1][1]
    out.append(("head", (cfg["head_channels"], last, 1, 1), 1))
    return out


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    specs = []
    for path, shape, _ in layers(cfg):
        p = path.replace("/", ".")
        specs.append((f"{p}.conv.weight", shape, "conv"))
        specs.append((f"{p}.bn", (shape[0],), "bn"))
    specs.append(("fc.weight", (cfg["num_classes"], cfg["head_channels"]),
                  "fc"))
    specs.append(("fc.bias", (cfg["num_classes"],), "bias"))
    return specs


def _conv_bn(params: Dict, path: str, x: torch.Tensor, stride: int,
             groups: int, relu6: bool) -> torch.Tensor:
    p = path.replace("/", ".")
    y = Q.bn_eval(Q.fp32_conv_nhwc(x, params[f"{p}.conv.weight"], stride,
                                   groups), params[f"{p}.bn"], BN_EPS)
    return torch.clamp_max(torch.relu(y), 6.0) if relu6 else y


def fp32_forward(cfg: dict, params: Dict, x: torch.Tensor,
                 observe: Callable[[str, torch.Tensor], None]
                 ) -> torch.Tensor:
    x = _conv_bn(params, "stem", x.permute(0, 3, 1, 2), 2, 1, True)
    for name, cin, cout, t, s in blocks(cfg):
        y = x
        if t != 1:
            observe(f"{name}/expand", y)
            y = _conv_bn(params, f"{name}/expand", y, 1, 1, True)
        observe(f"{name}/dw", y)
        y = _conv_bn(params, f"{name}/dw", y, s, cin * t, True)
        observe(f"{name}/project", y)
        y = _conv_bn(params, f"{name}/project", y, 1, 1, False)
        x = y + x if (s == 1 and cin == cout) else y
    observe("head", x)
    x = _conv_bn(params, "head", x, 1, 1, True)
    pooled = torch.mean(x, dim=(2, 3))
    observe("fc", pooled)
    with Q.fp32_exact():
        return F.linear(pooled, params["fc.weight"], params["fc.bias"])


def int8_forward(cfg: dict, tree: Dict, x: torch.Tensor) -> torch.Tensor:
    bl = blocks(cfg)

    def in_grid(k):
        name, _, _, t, _ = bl[k]
        return tree[f"{name}/expand" if t != 1 else f"{name}/dw"]["grid"]

    y = torch.clamp(Q.stem_fp32(tree["stem"], x, 2), 0.0, 6.0)
    grid = in_grid(0)
    x_q = Q.quantize_act(y, grid)
    for k, (name, cin, cout, t, s) in enumerate(bl):
        dw, proj = tree[f"{name}/dw"], tree[f"{name}/project"]
        nxt = in_grid(k + 1) if k + 1 < len(bl) else tree["head"]["grid"]
        y = x_q
        if t != 1:
            ex = tree[f"{name}/expand"]
            y = Q.apply(Q.matmul_acc(y, ex["w"]),
                        Q.node_epilogue(ex, out_grid=dw["grid"], relu=True,
                                        act_max=6.0))
        y = Q.apply(Q.depthwise_acc(y, dw["w"], s, dw["grid"].zp),
                    Q.node_epilogue(dw, out_grid=proj["grid"], relu=True,
                                    act_max=6.0))
        if s == 1 and cin == cout:
            x_q = Q.apply(Q.matmul_acc(y, proj["w"]),
                          Q.node_epilogue(proj, out_grid=nxt, res_grid=grid),
                          x_q)
        else:
            x_q = Q.apply(Q.matmul_acc(y, proj["w"]),
                          Q.node_epilogue(proj, out_grid=nxt))
        grid = nxt
    head = tree["head"]
    y = Q.apply(Q.matmul_acc(x_q, head["w"]),
                Q.node_epilogue(head, relu=True, act_max=6.0))
    return Q.fc_int8(tree["fc"], torch.mean(y, dim=(1, 2)))
