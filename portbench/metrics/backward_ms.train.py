"""Device ms of the train step's backward stage (with the remat recompute),
from CUDA events between the step's own stages."""

from portbench import readers


def read(ctx):
    return readers.stage_ms(ctx, "backward")
