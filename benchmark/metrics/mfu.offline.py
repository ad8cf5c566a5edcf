"""The model's operations of the batches completed in the traced slice of
the window (2 · multiply-adds of every conv and the fc, the fp32 stem and
the depthwise taps included, counted from the shapes), over the slice's
wall time and the card's int8 peak, in %."""
from benchmark.harness.peaks import PEAK_INT8_OPS


def read(run):
    if run.client != "offline" or run.slice is None:
        return None
    ops = run.ops_per_image * run.window.slice_images
    return 100.0 * ops / run.slice.window_s / PEAK_INT8_OPS
