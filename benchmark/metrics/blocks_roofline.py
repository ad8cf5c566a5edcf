"""The block scopes' share of their roofline, in %: the sum of each
scope's least time at the card's peaks (``harness.peaks.bound_s`` of the
operations and the bytes — input, weights, output once — that the
benchmark counts from the shapes) over the sum of their device time, from
eager forwards of the timed batch traced with their scopes.  Every scope
other than ``stem`` and ``head`` is a block scope; a chained run's scope
stands for the blocks it covers."""
from benchmark.harness.peaks import bound_s
from benchmark.harness.trace import OUTSIDE


def read(run):
    if run.scopes is None:
        return None
    times, n = run.scopes
    blocks = [s for s in times if s not in ("stem", "head", OUTSIDE)]
    if not blocks or not n:
        return None
    least = sum(bound_s(nb, tc, cc) for tc, cc, nb in
                (run.work.of([s], times) for s in blocks))
    spent = sum(times[s] for s in blocks) / n
    return 100.0 * least / spent
