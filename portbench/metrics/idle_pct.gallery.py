"""The share of the profiled sub-window in which no operation ran on the
card: 1 - the union of the device operations' intervals over the window."""

from portbench.readers import idle_pct as read
