"""Every conv and the fc of MobileNet-v2, per image, from the
configuration's sizes (SAME geometry, as ``work.resnet``): the stem, the
inverted residuals of the ``(t, c, n, s)`` rows (expand absent at t = 1,
the depthwise 3×3 carrying the stride), the 1×1 head and the fc, which
the engine runs under one ``head`` scope."""
from __future__ import annotations

from typing import List


def _out(n: int, s: int) -> int:
    return -(-n // s)


def layers(cfg: dict) -> List[dict]:
    n = cfg["image_size"]
    c0 = cfg["stem_channels"]
    out = [dict(path="stem", scope="stem", hw=n, cin=cfg["in_channels"],
                cout=c0, k=3, stride=2, groups=1, fp32=True)]
    n, cin, b = _out(n, 2), c0, 0
    for t, c, reps, s0 in cfg["inverted_residuals"]:
        for j in range(reps):
            name, s, hid = f"block{b}", (s0 if j == 0 else 1), cin * t
            m = _out(n, s)
            if t != 1:
                out.append(dict(path=f"{name}/expand", scope=name, hw=n,
                                cin=cin, cout=hid, k=1, stride=1, groups=1))
            out += [dict(path=f"{name}/dw", scope=name, hw=n, cin=hid,
                         cout=hid, k=3, stride=s, groups=hid),
                    dict(path=f"{name}/project", scope=name, hw=m, cin=hid,
                         cout=c, k=1, stride=1, groups=1)]
            cin, n, b = c, m, b + 1
    out += [dict(path="head", scope="head", hw=n, cin=cin,
                 cout=cfg["head_channels"], k=1, stride=1, groups=1),
            dict(path="fc", scope="head", hw=1, cin=cfg["head_channels"],
                 cout=cfg["num_classes"], k=1, stride=1, groups=1)]
    return out


def chained_runs(cfg: dict) -> dict:
    """A ``block{i}_ivrun`` scope covers block i and the blocks after it
    up to the next scope of the trace; the harness finds that end."""
    return {}
