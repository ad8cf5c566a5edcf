"""qtpu_torch.bench's timing, receipts and profile modules, on the CPU
(no JAX: these have no qtpu counterpart to hold them against beyond their
contracts, which are qtpu's).

* ``time_scan_fit`` returns the per-iteration slope between its two chain
  lengths under a patched clock (a fixed cost a measurement cancels), each
  iteration fed the carry the last one returned;
* ``log_receipt`` appends one line a call, adds a ``ts``, overwrites
  nothing, and raises on a record without its device;
* ``annotate`` is a null context without a profiler and a
  ``user_annotation`` span inside one; ``note_work`` leaves nothing
  outside a trace and, inside, a work note in its scope;
* ``trace`` raises when the profiler cannot start, and when it wrote no
  trace.
"""
import contextlib
import json

import pytest
import torch

from qtpu_torch.bench import profile, receipts, timing
from qtpu_torch.bench.profile import annotate, note_work, recording, trace
from qtpu_torch.bench.tracing import parse_trace


@pytest.mark.parametrize("n_short,n_long", [(2, 6), (5, 20)])
def test_time_scan_fit_slope(monkeypatch, n_short, n_long):
    clock = [100.0]

    def perf_counter():
        clock[0] += 1.0          # each reading costs a fixed second
        return clock[0]

    monkeypatch.setattr(timing.time, "perf_counter", perf_counter)
    fed = []

    def body(c, step):
        fed.append(float(c))
        clock[0] += 0.25         # an iteration's time
        return c + step

    dt = timing.time_scan_fit(body, torch.tensor(0.0), torch.tensor(1.0),
                              n_short=n_short, n_long=n_long, reps=2)
    assert dt == pytest.approx(0.25, rel=1e-12)
    # every chain starts from init and feeds each carry to the next call
    chains = [n_short] * 3 + [n_long] * 3      # a warm chain, then reps
    k = 0
    for n in chains:
        assert fed[k:k + n] == [float(i) for i in range(n)]
        k += n
    assert k == len(fed)


def test_time_scan_fit_rejects_short_long():
    with pytest.raises(ValueError, match="must exceed"):
        timing.time_scan_fit(lambda c: c, torch.zeros(1), n_short=5,
                             n_long=5)


def test_bound_and_peaks():
    assert timing.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert timing.bound(0, 1979e9) == (pytest.approx(1.0), "operations")
    assert timing.bound(0, 0, cuda_core_ops=67e9)[0] == pytest.approx(1.0)
    assert timing.device_label("cpu") == "cpu"


def test_log_receipt_appends(tmp_path):
    p = tmp_path / "r" / "x.jsonl"
    assert receipts.log_receipt("x", {"device": "cpu", "ms": 1.5},
                                path=str(p)) == str(p)
    receipts.log_receipt("x", {"device": "cpu", "ms": 2.5,
                               "ts": "2026-01-01T00:00:00Z"}, path=str(p))
    with pytest.raises(ValueError, match="names no device"):
        receipts.log_receipt("x", {"ms": 3.5}, path=str(p))
    with pytest.raises(ValueError, match="names no device"):
        receipts.log_receipt("x", {"ms": 3.5, "device": " "}, path=str(p))
    rows = [json.loads(line) for line in p.read_text().splitlines()]
    assert [r["ms"] for r in rows] == [1.5, 2.5]
    assert rows[0]["ts"].endswith("Z")
    assert rows[1]["ts"] == "2026-01-01T00:00:00Z"
    assert receipts.receipt_path("abc").endswith(
        "bench_receipts_torch/abc.jsonl")


def test_annotate_records_only_in_a_trace(tmp_path):
    assert not recording()
    assert isinstance(annotate("layer1_0"), contextlib.nullcontext)
    note_work(1, 2)                      # nothing records: a no-op
    with trace(str(tmp_path), "cpu") as t:
        assert recording()
        with annotate("layer1_0"):
            torch.ones(4) + 1
            note_work(10, 20, cuda_core_ops=5)
    assert not recording()
    events = json.load(open(t.path))["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "layer1_0"
               for e in events)
    recs = parse_trace(t.path)
    work = [(r.scope, r.ops, r.bytes, r.cuda_core_ops) for r in recs
            if r.category == "work"]
    assert work == [("layer1_0", 10.0, 20.0, 5.0)]
    assert {r.scope for r in recs if r.category == "cpu_op"} == {"layer1_0"}


def test_trace_warmup_step_is_not_recorded(tmp_path):
    with trace(str(tmp_path), "cpu", warmup=1) as t:
        assert not recording()
        with annotate("warm"):
            torch.ones(2) * 2
        t.step()
        assert recording()
        with annotate("hot"):
            torch.ones(2) * 3
    names = {e["name"] for e in json.load(open(t.path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert "hot" in names and "warm" not in names


class _Refuses:
    def __init__(self, **kw):
        pass

    def __enter__(self):
        raise RuntimeError("profiler unavailable")

    def __exit__(self, *a):
        return False


class _WritesNothing(_Refuses):
    def __enter__(self):
        return self


def test_trace_raises_when_the_profiler_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(profile, "profile", _Refuses)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with trace(str(tmp_path), "cpu"):
            pass
    monkeypatch.setattr(profile, "profile", _WritesNothing)
    with pytest.raises(RuntimeError, match="wrote no trace"):
        with trace(str(tmp_path), "cpu"):
            pass
