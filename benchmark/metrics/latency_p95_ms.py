"""The 95th percentile of ``latency_p50_ms``'s set (open-loop clients)."""
from benchmark.harness.stats import percentile


def read(run):
    if run.client != "open_loop":
        return None
    return percentile(run.window.latencies_s, 95) * 1e3
