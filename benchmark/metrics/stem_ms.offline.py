"""Device ms a batch of the fp32 stem and its glue: the ``stem`` scope's
kernels and the uint8 normalize the engine runs just before it (kernels
of the forward under no scope), from eager forwards of the timed batch."""
from benchmark.harness.trace import OUTSIDE


def read(run):
    if run.client != "offline" or run.scopes is None:
        return None
    times, n = run.scopes
    if "stem" not in times or not n:
        return None
    return 1e3 * (times["stem"] + times.get(OUTSIDE, 0.0)) / n
