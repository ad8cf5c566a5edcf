"""Every conv and the fc of a bottleneck ResNet (ResNet-50 v1), per image,
from the configuration's sizes: SAME geometry, so a layer of stride s maps
n × n to ⌈n / s⌉ × ⌈n / s⌉; the 3×3/2 max-pool after the stem halves
again.  Each layer: its trace scope (the engines' names), input side,
channels, kernel, stride and groups."""
from __future__ import annotations

from typing import List


def _out(n: int, s: int) -> int:
    return -(-n // s)


def layers(cfg: dict) -> List[dict]:
    n = cfg["image_size"]
    w = cfg["width"]
    out = [dict(path="stem", scope="stem", hw=n, cin=cfg["in_channels"],
                cout=w, k=7, stride=2, groups=1, fp32=True)]
    n = _out(_out(n, 2), 2)
    cin = w
    for i, blocks in enumerate(cfg["stage_sizes"]):
        f = w * 2 ** i
        for j in range(blocks):
            name, s = f"layer{i + 1}_{j}", (2 if i > 0 and j == 0 else 1)
            m = _out(n, s)
            out += [dict(path=f"{name}/conv1", scope=name, hw=n, cin=cin,
                         cout=f, k=1, stride=1, groups=1),
                    dict(path=f"{name}/conv2", scope=name, hw=n, cin=f,
                         cout=f, k=3, stride=s, groups=1),
                    dict(path=f"{name}/conv3", scope=name, hw=m, cin=f,
                         cout=4 * f, k=1, stride=1, groups=1)]
            if s != 1 or cin != 4 * f:
                out.append(dict(path=f"{name}/down", scope=name, hw=n,
                                cin=cin, cout=4 * f, k=1, stride=s,
                                groups=1))
            cin, n = 4 * f, m
    out.append(dict(path="fc", scope="head", hw=1, cin=cin,
                    cout=cfg["num_classes"], k=1, stride=1, groups=1))
    return out


def chained_runs(cfg: dict) -> dict:
    """The block scopes each chained-run scope covers: ``layer{i}_stage``
    a whole stage, ``layer{i}_idrun`` its identity blocks."""
    runs = {}
    for i, blocks in enumerate(cfg["stage_sizes"]):
        names = [f"layer{i + 1}_{j}" for j in range(blocks)]
        runs[f"layer{i + 1}_stage"] = names
        runs[f"layer{i + 1}_idrun"] = names[1:]
    return runs
