"""Seconds from the process's start to the first timed request: imports,
the CUDA context, the kernels' build (first run of a checkout only),
weights, calibration, freeze, the engine and its CUDA graphs."""


def read(run):
    return run.setup_s
