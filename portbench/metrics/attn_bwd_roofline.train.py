"""The attention backward's share of its roofline: the least time of each
launch (the four gradient products at the bf16 peak or its bytes at peak
bandwidth) over the device time the profiler links to the attention
operator's backward, over the window's launches."""

from portbench import readers


def read(ctx):
    return readers.attention_roofline(ctx, "backward")
