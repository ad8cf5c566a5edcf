"""Device ms a batch of the upload, each pool batch copied from pinned host
memory into the graph's static input, in the traced slice of the window
(offline clients): the device time of the ops launched inside the
system's ``qtpu.graph.upload`` spans that open in the slice, over their
number.  A system whose graphed call carries no such span is read by the
slice's host-to-device copies, one a batch (the client copies nothing
else to the card): the mean of their device time."""
from collections import defaultdict

from benchmark.harness.trace import DEVICE_CATS, LAUNCH_CATS, SLICE, _span

UPLOAD = "qtpu.graph.upload"


def read(run):
    events = run.window.slice_events
    if run.client != "offline" or not events:
        return None
    s0, s1 = _span(events, SLICE)
    spans = defaultdict(list)           # host thread -> upload spans
    ops = defaultdict(float)            # correlation -> device us
    copies = []
    for e in events:
        cat = e.get("cat")
        if (cat == "user_annotation" and e["name"] == UPLOAD
                and s0 <= e["ts"] <= s1):
            spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
        elif cat in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                ops[corr] += e["dur"]
            if (cat == "gpu_memcpy" and "HtoD" in e["name"]
                    and s0 <= e["ts"] <= s1):
                copies.append(e["dur"])
    n = sum(len(v) for v in spans.values())
    if not n:
        return 1e-3 * sum(copies) / len(copies) if copies else None
    us = sum(ops.get(e["args"]["correlation"], 0.0) for e in events
             if e.get("cat") in LAUNCH_CATS
             and "correlation" in e.get("args", {})
             and any(a <= e["ts"] <= b for a, b in spans[e.get("tid")]))
    return 1e-3 * us / n
