"""The program's spans set against a timeline of CUDA activity alone.

The port records spans at its layer boundaries (``signal_tpu_torch/utils/
profiler.py``) and writes them as Chrome-trace complete events (``cat``
``program_span``; ``args``: ``id``, ``parent``, ``request``) on the clock
of a ``torch.profiler`` trace. Here they are read back and set against
that trace's timeline:

* self time by span name, a unit (one root span: ``train.step`` or
  ``eval.step``): a span's duration less the part its children cover;
* the device's idle gaps (``yardstick.idle_gaps`` over the timeline), each
  put down to the innermost span the main thread was in when it began;
* device time of the operations whose launching runtime call lies inside
  a span, on that span's thread;
* the prefetch queue: a batch's wait for the consumer, from the end of its
  ``data.prefetch.put`` to the end of the ``data.prefetch.wait`` that took
  it (a request id joins the two, and the step that followed).

A recording holds one prefetch loop: its items are numbered from 0, so
two loops' ids would collide. Nothing here imports the port.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from portbench import yardstick
from portbench.trace import Trace

SPAN_CAT = "program_span"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRAIN, GALLERY = "train.step", "eval.step"
PUT, WAIT = "data.prefetch.put", "data.prefetch.wait"
# the train step's stages, as the idle metrics group them
STAGES = {"train.prepare": "forward", "train.forward": "forward",
          "train.backward": "backward", "train.update": "update"}


@dataclass
class Span:
    name: str
    ts: float            # µs, the trace's clock
    end: float
    tid: int
    id: int
    parent: Optional[int]
    request: Optional[int]


@dataclass
class Launch:
    ts: float            # the launching runtime call's start, µs
    tid: int             # its thread
    dur: float           # the device operation's µs


@dataclass
class Readings:
    """One sub-window: the spans recorded in it, its timeline (CUDA
    activity alone) and each device operation's launch."""
    spans: List[Span]
    timeline: Optional[Trace] = None
    launches: List[Launch] = field(default_factory=list)


def parse_spans(events: Iterable[dict]) -> List[Span]:
    return [Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"],
                 e["args"]["id"], e["args"]["parent"], e["args"]["request"])
            for e in events if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]


def launches(events: Iterable[dict]) -> List[Launch]:
    """Each device operation of a Chrome trace with the start and thread
    of the runtime or driver call that launched it (by correlation id)."""
    events = list(events)
    calls = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
             if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
             and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and c in calls:
            out.append(Launch(calls[c][0], calls[c][1], float(e.get("dur", 0))))
    return out


def roots(spans: List[Span], name: str) -> List[Span]:
    return [s for s in spans if s.name == name and s.parent is None]


def self_us(spans: List[Span]) -> Dict[int, float]:
    """id → the span's duration less the part of it its children cover
    (they run one after another on its thread)."""
    by_id = {s.id: s for s in spans}
    own = {s.id: s.end - s.ts for s in spans}
    for s in spans:
        p = by_id.get(s.parent)
        if p is not None:
            own[p.id] -= max(0.0, min(s.end, p.end) - max(s.ts, p.ts))
    return own


def step_ms(spans: List[Span], root: str) -> Optional[float]:
    """Mean duration of the root spans, ms."""
    units = roots(spans, root)
    return sum(s.end - s.ts for s in units) / 1e3 / len(units) if units else None


def self_ms(spans: List[Span], names, root: str) -> Optional[float]:
    """Self time of the spans named in ``names``, ms a unit."""
    units = roots(spans, root)
    if not units:
        return None
    own = self_us(spans)
    mine = [s for s in spans if s.name in names]
    return sum(own[s.id] for s in mine) / 1e3 / len(units) if mine else None


def _chain(span: Span, by_id: Dict[int, Span]) -> List[Span]:
    out = [span]
    while out[-1].parent is not None and out[-1].parent in by_id:
        out.append(by_id[out[-1].parent])
    return out


def innermost(spans: List[Span], tid, t: float) -> Optional[Span]:
    """The innermost span of thread ``tid`` open at time ``t`` (of two that
    began together, the child: its id, the order of beginning, is later)."""
    inside = [s for s in spans if s.tid == tid and s.ts <= t < s.end]
    return max(inside, key=lambda s: (s.ts, s.id)) if inside else None


def idle_gaps(r: Readings, root: str) -> Optional[List[tuple]]:
    """(µs, the innermost span of the main thread when the gap began, or
    None) for each idle gap of the timeline. The main thread is the one
    that ran the root spans (the backward's kernels are launched from
    autograd's thread while the main thread waits in ``train.backward``)."""
    t, units = r.timeline, roots(r.spans, root)
    if t is None or t.span() is None or not units:
        return None
    gaps = yardstick.idle_gaps([(d.ts, d.ts + d.dur) for d in t.device_ops], *t.span())
    return [(e - s, innermost(r.spans, units[0].tid, s)) for s, e in gaps]


def idle_by_stage(r: Readings) -> Optional[Dict[str, float]]:
    """µs of idle gaps by the train stage (``STAGES``) the main thread was
    in when each began, the span itself or an ancestor; 'none' for a gap
    under no stage (outside any span, or in a step between stages)."""
    gaps = idle_gaps(r, TRAIN)
    if gaps is None:
        return None
    by_id = {s.id: s for s in r.spans}
    out = {"forward": 0.0, "backward": 0.0, "update": 0.0, "none": 0.0}
    for us, s in gaps:
        stage = next((STAGES[a.name] for a in _chain(s, by_id) if a.name in STAGES),
                     "none") if s is not None else "none"
        out[stage] += us
    return out


def idle_ms(r: Readings, stage: str) -> Optional[float]:
    """Idle ms a train step of the gaps that began under ``stage``."""
    split = idle_by_stage(r)
    return None if split is None else split[stage] / 1e3 / len(roots(r.spans, TRAIN))


def device_ms_under(r: Readings, name: str, root: str) -> Optional[float]:
    """Device ms a unit of the operations launched from the main thread (the
    root spans') inside its spans named ``name``. A CUDA-only profile names
    a thread by the profiler's own id until the process has profiled the
    host's activity: where no launch carries the main thread's native id,
    the timeline's main thread (the one that launched most operations)
    stands for it."""
    units = roots(r.spans, root)
    if not units or not r.launches:
        return None
    tid = units[0].tid
    mine = [s for s in r.spans if s.name == name and s.tid == tid]
    if not mine:
        return None
    if r.timeline is not None and not any(d.tid == tid for d in r.launches):
        tid = r.timeline.main_tid
    total = sum(d.dur for d in r.launches
                if d.tid == tid and any(s.ts <= d.ts < s.end for s in mine))
    return total / 1e3 / len(units)


def wait_ms(spans: List[Span], root: str) -> Optional[float]:
    """The consumer's wait for each unit's batch, ms a unit: the
    ``data.prefetch.wait`` of the unit's request on the unit's thread."""
    units = roots(spans, root)
    waits = {(s.tid, s.request): s for s in spans if s.name == WAIT}
    found = [waits[(u.tid, u.request)] for u in units if (u.tid, u.request) in waits]
    return sum(w.end - w.ts for w in found) / 1e3 / len(found) if found else None


def queue_ms(spans: List[Span], root: str) -> Optional[float]:
    """Ms a unit's batch sat in the prefetch queue, the median over the
    units: from the end of its put to the end of the wait that took it (0
    where the consumer was already waiting). The median, as the first
    batches of a window find the queue empty."""
    units = roots(spans, root)
    puts = {s.request: s for s in spans if s.name == PUT}
    waits = {(s.tid, s.request): s for s in spans if s.name == WAIT}
    held = [max(0.0, waits[(u.tid, u.request)].end - puts[u.request].end) for u in units
            if u.request in puts and (u.tid, u.request) in waits]
    return statistics.median(held) / 1e3 if held else None


def summary(r: Readings, root: str) -> dict:
    """What checks the span tree against itself: the units, the mean root
    span against the sum of its tree's self times, each name's self ms a
    unit, and the idle by stage (train) with the share of idle under no
    span at all."""
    units = roots(r.spans, root)
    own = self_us(r.spans)
    by_id = {s.id: s for s in r.spans}
    tree = sum(own[s.id] for s in r.spans if _chain(s, by_id)[-1] in units)
    by_name: Dict[str, float] = {}
    for s in r.spans:
        by_name[s.name] = by_name.get(s.name, 0.0) + own[s.id] / 1e3 / max(1, len(units))
    out = {"units": len(units), "root_ms": step_ms(r.spans, root),
           "root_ms_each": [(s.end - s.ts) / 1e3 for s in units],
           "tree_self_ms": tree / 1e3 / len(units) if units else None,
           "self_ms_by_name": by_name}
    gaps = idle_gaps(r, root)
    if gaps:
        total = sum(us for us, _ in gaps)
        out["idle_ms"] = total / 1e3 / max(1, len(units))
        out["idle_outside_spans_share"] = sum(us for us, s in gaps if s is None) / total
        if root == TRAIN:
            out["idle_by_stage_ms"] = {k: v / 1e3 / max(1, len(units))
                                       for k, v in idle_by_stage(r).items()}
    return out


# metric name → read(Readings); each ms a unit, lower is better
METRICS = {
    "step_host_ms.train": lambda r: step_ms(r.spans, TRAIN),
    "tower_host_ms.train": lambda r: self_ms(r.spans, ("model.tower",), TRAIN),
    "sim_host_ms.train": lambda r: self_ms(r.spans, ("model.sim",), TRAIN),
    "align_host_ms.train": lambda r: self_ms(r.spans, ("model.align",), TRAIN),
    "loss_host_ms.train": lambda r: self_ms(r.spans, ("model.heads", "train.loss"), TRAIN),
    "backward_host_ms.train": lambda r: self_ms(r.spans, ("train.backward",), TRAIN),
    "update_host_ms.train": lambda r: self_ms(r.spans, ("train.update",), TRAIN),
    "prefetch_wait_ms.train": lambda r: wait_ms(r.spans, TRAIN),
    "forward_idle_ms.train": lambda r: idle_ms(r, "forward"),
    "backward_idle_ms.train": lambda r: idle_ms(r, "backward"),
    "update_idle_ms.train": lambda r: idle_ms(r, "update"),
    "step_host_ms.gallery": lambda r: step_ms(r.spans, GALLERY),
    "tower_host_ms.gallery": lambda r: self_ms(r.spans, ("model.tower",), GALLERY),
    "sim_host_ms.gallery": lambda r: self_ms(r.spans, ("model.sim",), GALLERY),
    "sim_ms.gallery": lambda r: device_ms_under(r, "model.sim", GALLERY),
    "prefetch_queue_ms.gallery": lambda r: queue_ms(r.spans, GALLERY),
}
