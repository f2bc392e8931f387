"""The attention forward's share of its roofline: the least time of each
launch (its shapes' operations at the bf16 peak or its bytes at peak
bandwidth) over the device time the profiler links to the
signal_tpu_torch::attention_fwd operator, over the window's launches."""

from portbench import readers


def read(ctx):
    return readers.attention_roofline(ctx, "forward")
