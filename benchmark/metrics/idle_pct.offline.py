"""Share of the traced slice of the window in which no kernel, copy or
fill ran on the card, in % (offline clients)."""


def read(run):
    if run.client != "offline" or run.slice is None:
        return None
    return 100.0 * run.slice.idle_share
