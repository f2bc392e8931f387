"""Model FLOPs (forward and backward, no remat replay; the frozen count) of
the units stepped in the host-clock sub-window over its seconds, over
the card's bf16 peak."""

from portbench.readers import mfu as read
