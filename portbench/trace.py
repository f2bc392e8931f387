"""The device's view of a window: ``torch.profiler`` over a few steps, its
Chrome trace read back into device operations, each linked to the host
operators that enclosed its launch.

Two kinds of window: with the host's operators and their shapes (what
attributes device time to the port's operators; the recording slows the
host severalfold, so the device idles more than it would), and with CUDA
activity alone (the runtime calls and the device operations: the
timeline the idle share is read from).

A device operation (kernel, copy or fill) carries the correlation id of
the runtime or driver call that launched it; that call lies inside the
host operators open on its thread at that moment. So each device
operation is attributed to the whole stack of host operators around its
launch, whatever the kernel is called (a kernel renamed or replaced is
still found under the operator that launched it).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class HostOp:
    name: str
    ts: float
    end: float
    tid: int
    dims: Optional[list] = None


@dataclass
class DeviceOp:
    name: str
    ts: float            # µs, the trace's clock
    dur: float           # µs
    cat: str             # kernel | gpu_memcpy | gpu_memset
    stack: List[HostOp] = field(default_factory=list)   # outermost first

    def under(self, names) -> Optional[HostOp]:
        """The innermost enclosing host operator whose name is one of
        ``names``."""
        for op in reversed(self.stack):
            if op.name in names:
                return op
        return None


@dataclass
class Trace:
    device_ops: List[DeviceOp]
    host_ops: List[HostOp]
    main_tid: Optional[int]
    marks: Dict[str, Tuple[float, float]]   # user annotations: name → (start, end) µs
    calls: List[HostOp] = field(default_factory=list)   # CUDA runtime and driver calls

    def span(self) -> Optional[Tuple[float, float]]:
        """From the first CUDA call to the end of the last device operation."""
        if not self.calls or not self.device_ops:
            return None
        return (min(c.ts for c in self.calls),
                max(d.ts + d.dur for d in self.device_ops))

    def host_at(self, times: List[float]) -> List[str]:
        """What the main thread was in at each of ``times``: its innermost
        host operator, else its CUDA call, else plain host work."""
        pts = [(t, self.main_tid, i) for i, t in enumerate(times)]
        ops, calls = _stacks(self.host_ops, pts), _stacks(self.calls, pts)
        return [ops[i][-1].name if ops.get(i) else
                calls[i][-1].name if calls.get(i) else "host work outside CUDA calls"
                for i in range(len(times))]


def _stacks(ops: List[HostOp], points: List[Tuple[float, int, int]]) -> Dict[int, List[HostOp]]:
    """For each (time, tid, key) point, the host operators of that thread
    open at that time, outermost first."""
    by_tid: Dict[int, List[HostOp]] = {}
    for op in ops:
        by_tid.setdefault(op.tid, []).append(op)
    out: Dict[int, List[HostOp]] = {}
    for tid, lst in by_tid.items():
        lst.sort(key=lambda o: (o.ts, -o.end))
        pts = sorted(p for p in points if p[1] == tid)
        stack: List[HostOp] = []
        i = 0
        for t, _, key in pts:
            while i < len(lst) and lst[i].ts <= t:
                while stack and stack[-1].end <= lst[i].ts:
                    stack.pop()
                stack.append(lst[i])
                i += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            out[key] = [op for op in stack if op.ts <= t < op.end]
    return out


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host, launches, device, marks, calls = [], {}, [], {}, []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        if cat == "cpu_op":
            host.append(HostOp(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                               e.get("tid"), args.get("Input Dims")))
        elif cat == "user_annotation":
            marks[e["name"]] = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        elif cat in LAUNCH_CATS:
            calls.append(HostOp(e["name"], float(e["ts"]),
                                float(e["ts"]) + float(e.get("dur", 0)), e.get("tid")))
            if "correlation" in args:
                launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((e, args.get("correlation")))
    points = [(launches[c][0], launches[c][1], c) for _, c in device if c in launches]
    stacks = _stacks(host, points)
    counts: Dict[int, int] = {}
    for t, tid, _ in points:
        counts[tid] = counts.get(tid, 0) + 1
    main_tid = max(counts, key=counts.get) if counts else None
    ops = [DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0)), e["cat"],
                    stacks.get(c, []))
           for e, c in device]
    return Trace(ops, host, main_tid, marks, calls)


class Profiled:
    """``with Profiled(host_ops) as p: ...`` profiles the block; ``p.trace``
    is the parsed trace. ``host_ops``: record the host's operators and
    their shapes too. The Chrome trace goes to a temporary file under
    ``$TMPDIR`` and is removed once read."""

    def __init__(self, host_ops: bool):
        self.host_ops = host_ops

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts, record_shapes=self.host_ops)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = parse(path)
        finally:
            os.remove(path)
        return False
