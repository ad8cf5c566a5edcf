"""Images whose logits reached the host inside the window, over the
window's seconds (offline clients)."""


def read(run):
    if run.client != "offline":
        return None
    return run.window.completed / run.window.seconds
