"""Device ms of the train step's forward and loss stage, from CUDA events
between the step's own stages."""

from portbench import readers


def read(ctx):
    return readers.stage_ms(ctx, "forward_loss")
