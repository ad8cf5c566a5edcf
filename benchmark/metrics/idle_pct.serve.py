"""Share of the traced slice of the window in which no kernel, copy or
fill ran on the card, in % (open-loop clients)."""


def read(run):
    if run.client != "open_loop" or run.slice is None:
        return None
    return 100.0 * run.slice.idle_share
