"""Host ms from the call of a step (or eval step) until it returns, over
the host-clock sub-window: the host's dispatch, paced by the host."""

from portbench.readers import host_enqueue_ms as read
