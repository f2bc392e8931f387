"""Device ms of the train step's update stage (Adam and the accuracy), from
CUDA events between the step's own stages."""

from portbench import readers


def read(ctx):
    return readers.stage_ms(ctx, "optimizer")
