"""What the per-layer metrics read, and the arithmetic they share. Each
metric has a file of its own, ``metrics/<name>.py``, whose ``read(ctx)``
returns the metric's value or None where the run gave it nothing to read
(the harness then leaves the metric out of the result line).

``ctx`` (:class:`Readings`) holds what a ``--trace 1`` run observed: the
host-clock sub-window (units stepped, its seconds, each call's enqueue
time), the stage times from CUDA events between the train step's own
stages, a timeline of CUDA activity alone (the idle share), and a trace
with the host's operators (device time by operator and by kind).
"""

from __future__ import annotations

import json
import statistics
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench import yardstick
from portbench.trace import DeviceOp, Trace

WINDOW_MARK = "portbench.window"
ATTENTION_OPS = json.loads((Path(__file__).resolve().parent / "metrics" /
                            "attention_ops.json").read_text())


@dataclass
class Readings:
    unit_flops: float                # model FLOPs of one step or batch
    bw: float                        # the card's peak bytes/s
    flops: float                     # its peak bf16 FLOP/s
    host_units: int = 0              # steps or batches in the host-clock sub-window
    host_seconds: float = 0.0
    enqueue_s: List[float] = field(default_factory=list)
    stage_ms: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None    # the sub-window profiled with the host's operators
    traced_units: int = 0
    timeline: Optional[Trace] = None  # the sub-window profiled with CUDA activity alone

    def window(self):
        """(start, end) µs of the profiled sub-window on the trace's clock."""
        if self.trace is None or WINDOW_MARK not in self.trace.marks:
            return None
        return self.trace.marks[WINDOW_MARK]

    def window_ops(self) -> List[DeviceOp]:
        w = self.window()
        if w is None:
            return []
        return [d for d in self.trace.device_ops if d.ts < w[1] and d.ts + d.dur > w[0]]


def busy_us(ctx: Readings) -> Optional[float]:
    """µs of the timeline in which some operation ran on the device."""
    if ctx.timeline is None or ctx.timeline.span() is None:
        return None
    return yardstick.union_length((d.ts, d.ts + d.dur) for d in ctx.timeline.device_ops)


def idle_pct(ctx: Readings) -> Optional[float]:
    """The timeline's share (from its first CUDA call to its last device
    operation's end) in which no operation ran on the device."""
    busy = busy_us(ctx)
    if busy is None:
        return None
    start, end = ctx.timeline.span()
    return 100.0 * (1.0 - busy / (end - start))


def mfu(ctx: Readings) -> Optional[float]:
    """Model FLOPs of the units stepped over the host-clock sub-window,
    over the card's bf16 peak."""
    if not ctx.host_units or ctx.host_seconds <= 0:
        return None
    return 100.0 * ctx.unit_flops * ctx.host_units / ctx.host_seconds / ctx.flops


def kind_ms(ctx: Readings, kinds) -> Optional[float]:
    """Device ms a unit of the kernels whose names fall into ``kinds``
    (``yardstick.KINDS``); copies between host and device are not kernels."""
    ops = ctx.window_ops()
    if not ops or not ctx.traced_units:
        return None
    total = sum(d.dur for d in ops if d.cat == "kernel" and yardstick.kind_of(d.name) in kinds)
    return total / 1e3 / ctx.traced_units if total > 0 else None


def _qk(dims) -> Optional[tuple]:
    shapes = [d for d in (dims or []) if isinstance(d, list) and len(d) == 3]
    return (shapes[0], shapes[1]) if len(shapes) >= 2 else None


def attention_roofline(ctx: Readings, direction: str) -> Optional[float]:
    """The attention kernels' share of their roofline: the least time of
    each launch (its shapes' operations at peak or bytes at peak
    bandwidth, bf16), summed over the window's launches, over the device
    time of the operations the profiler links to the attention operator
    (``direction`` 'forward') or to its backward. A launch is one
    instance of that host operator; where the backward's operator carries
    no shapes, its launch takes the forward's most common ones (the
    self-attention of one tower: the same q, k, v)."""
    names = ATTENTION_OPS[direction]
    launches: Dict[int, list] = {}
    for d in ctx.window_ops():
        op = d.under(names)
        if op is not None:
            launches.setdefault(id(op), [op, 0.0])[1] += d.dur
    if not launches:
        return None
    fallback = None
    if direction != "forward":
        fwd = Counter(tuple(map(tuple, qk)) for d in ctx.window_ops()
                      if (op := d.under(ATTENTION_OPS["forward"])) and (qk := _qk(op.dims)))
        fallback = fwd.most_common(1)[0][0] if fwd else None
    cost = yardstick.attention_fwd_cost if direction == "forward" else yardstick.attention_bwd_cost
    least = spent = 0.0
    for op, dur in launches.values():
        qk = _qk(op.dims) or fallback
        if qk is None:
            return None
        least += yardstick.least_seconds(*cost(qk[0], qk[1]), ctx.bw, ctx.flops)
        spent += dur / 1e6
    return 100.0 * least / spent


def stage_ms(ctx: Readings, name: str) -> Optional[float]:
    return ctx.stage_ms.get(name)


def host_enqueue_ms(ctx: Readings) -> Optional[float]:
    return 1e3 * statistics.fmean(ctx.enqueue_s) if ctx.enqueue_s else None
