"""Operations and bytes from an architecture's layer list
(``benchmark/work/<architecture>.py``), counted by the benchmark from the
shapes and never by the system:

* a layer's multiply-adds: ``⌈hw / stride⌉² · cout · k² · cin / groups``,
  each two operations; a depthwise layer's run outside the tensor cores;
* a scope's bytes: its input activation, its weights and its output, each
  once, int8.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Tuple


def arch(cfg: dict):
    return importlib.import_module(f"benchmark.work.{cfg['architecture']}")


def _out(n: int, s: int) -> int:
    return -(-n // s)


def macs(layer: dict) -> int:
    m = _out(layer["hw"], layer["stride"])
    return (m * m * layer["cout"] * layer["k"] * layer["k"] * layer["cin"]
            // layer["groups"])


def is_depthwise(layer: dict) -> bool:
    return layer["groups"] > 1


def model_ops_per_image(cfg: dict) -> float:
    """2 · the multiply-adds of every conv and the fc, the stem included."""
    return 2.0 * sum(macs(x) for x in arch(cfg).layers(cfg))


class ScopeWork:
    """Per trace scope at a batch: tensor-core operations, operations
    outside the tensor cores, and bytes."""

    def __init__(self, cfg: dict, batch: int):
        self.order: List[str] = []
        self.work: Dict[str, List[float]] = {}
        layers = arch(cfg).layers(cfg)
        first, last = {}, {}
        for x in layers:
            sc = x["scope"]
            if sc not in self.work:
                self.order.append(sc)
                self.work[sc] = [0.0, 0.0, 0.0]
                first[sc] = x
            last[sc] = x
            ops = 2.0 * macs(x) * batch
            self.work[sc][1 if is_depthwise(x) else 0] += ops
            self.work[sc][2] += x["cout"] * x["k"] * x["k"] * x["cin"] \
                / x["groups"]
        for sc in self.order:
            a, b = first[sc], last[sc]
            m = _out(b["hw"], b["stride"])
            self.work[sc][2] += batch * (a["hw"] * a["hw"] * a["cin"]
                                         + m * m * b["cout"])
        self.runs = arch(cfg).chained_runs(cfg)

    def blocks(self) -> List[str]:
        return [s for s in self.order if s not in ("stem", "head")]

    def covered(self, scope: str, seen: Iterable[str]) -> List[str]:
        """The block scopes a traced scope stands for: itself, a chained
        run's blocks, or for ``block{i}_ivrun`` block i up to the next
        scope the trace shows."""
        if scope in self.work:
            return [scope]
        if scope in self.runs:
            return list(self.runs[scope])
        if scope.endswith("_ivrun"):
            start = scope[:-len("_ivrun")]
            seen = set(seen)
            blocks = self.blocks()
            i = blocks.index(start)
            out = [start]
            for b in blocks[i + 1:]:
                if b in seen or f"{b}_ivrun" in seen:
                    break
                out.append(b)
            return out
        raise KeyError(f"scope {scope!r} is no layer of the configuration")

    def of(self, scopes: Iterable[str], seen: Iterable[str]
           ) -> Tuple[float, float, float]:
        """(tensor-core ops, other ops, bytes) of the blocks the traced
        ``scopes`` cover."""
        seen = list(seen)
        tc = cc = nb = 0.0
        for s in scopes:
            for b in self.covered(s, seen):
                w = self.work[b]
                tc, cc, nb = tc + w[0], cc + w[1], nb + w[2]
        return tc, cc, nb
