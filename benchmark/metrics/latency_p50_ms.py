"""Median, over every request due inside the window, of the time from when
it was due to when its logits were on the client's side; a failed request
is infinitely late (open-loop clients)."""
from benchmark.harness.stats import percentile


def read(run):
    if run.client != "open_loop":
        return None
    return percentile(run.window.latencies_s, 50) * 1e3
