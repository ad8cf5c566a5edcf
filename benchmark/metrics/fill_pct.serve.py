"""Images served over bucket rows dispatched, in %: ``ServingEngine.
stats()``'s ``images`` and ``rounds_per_bucket`` differenced over the
window (open-loop clients)."""


def read(run):
    if run.client != "open_loop" or not run.window.counters.get("rows"):
        return None
    c = run.window.counters
    return 100.0 * c["images"] / c["rows"]
