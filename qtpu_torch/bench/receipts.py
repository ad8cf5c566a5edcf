"""Append-only JSONL receipts of measurements (port of
qtpu/bench/receipts.py).

A script that measures writes its raw rows here, one JSON line each, so a
table in PERF.md can be derived again from the rows themselves.  The port
writes under ``bench_receipts_torch/`` at the repository root;
``bench_receipts/`` holds qtpu's TPU rounds and is not written.  Every
record names the device it was measured on — on a card the name and power
limit ``timing.device_label`` reads from ``nvidia-smi`` — and
:func:`log_receipt` raises without one: a time or a rate means nothing
without its device.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIR = os.path.join(_REPO, "bench_receipts_torch")


def receipt_path(name: str) -> str:
    return os.path.join(DIR, f"{name}.jsonl")


def log_receipt(name: str, record: Dict[str, Any],
                path: Optional[str] = None) -> str:
    """Append one JSON line to ``bench_receipts_torch/<name>.jsonl`` (or
    ``path``) and return the file's path.

    ``record`` carries what re-derives its table row (script, variant,
    trial, raw times, derived rates) and a non-empty ``device``; a ``ts``
    (UTC) is added unless present.  Nothing is ever overwritten."""
    device = record.get("device")
    if not isinstance(device, str) or not device.strip():
        raise ValueError(f"receipt {name!r} names no device: a time or a "
                         "rate is kept beside the card's name and power "
                         "limit (timing.device_label)")
    path = path or receipt_path(name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rec = dict(record)
    rec.setdefault("ts", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path
