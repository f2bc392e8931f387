"""Tracing the port: spans at its layer boundaries, and ``trace``.

``span(name)`` marks a block of host code as one layer's work: the train
and eval steps and their stages, the model's tower, SIM, GAM + LAM and
heads, the loss, and the prefetch queue's two ends. Spans are off by
default, and an off span is one check of a module flag that hands back a
shared no-op context: no clock read, no allocation. ``recording()`` turns
them on for a block and yields the list its spans go into; nothing is
written out unless a caller asks.

A span holds its name, its start and end (``time.time_ns()``, the clock
``torch.profiler`` writes its Chrome traces on), the native id of its
thread (the ``tid`` those traces give), the span open on that thread when
it began, and a request id: the step or batch it belongs to. ``prefetch``
numbers the items it hands on; its consumer's wait for item *k* makes *k*
the thread's request, which the next root span on that thread (the step
that takes the batch) and all that span's children carry.

``chrome_events`` places spans on a Chrome trace's clock, given the
trace's ``baseTimeNanoseconds``; ``trace(log_dir)`` profiles a block and
writes one ``trace.json`` with the device timeline and the spans on the
host threads, for Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

_recorder: Optional["_Recorder"] = None   # set while recording() is open
_OFF = contextlib.nullcontext()
_thread = threading.local()               # .tid: the native id, read once a thread


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.open: Dict[int, List[Span]] = {}       # tid → the spans open on it
        self.requests: Dict[int, int] = {}          # tid → its current request


class Span:
    """One block of host code on one thread (see the module's docstring).
    ``end_ns`` is None while the block runs."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "parent", "request", "_rec")

    def __init__(self, rec: _Recorder, name: str, request: Optional[int]):
        self._rec, self.name, self.request = rec, name, request
        self.start_ns = self.end_ns = self.tid = self.parent = None

    def __enter__(self) -> "Span":
        rec = self._rec
        tid = getattr(_thread, "tid", None)
        if tid is None:     # a system call: microseconds on some hosts
            tid = _thread.tid = threading.get_native_id()
        self.tid = tid
        stack = rec.open.setdefault(tid, [])
        self.parent = stack[-1] if stack else None
        if self.request is not None:
            rec.requests[tid] = self.request
        elif self.parent is not None:
            self.request = self.parent.request
        else:
            self.request = rec.requests.get(tid)
        stack.append(self)
        rec.spans.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._rec.open[self.tid].pop()
        return False


def span(name: str, request: Optional[int] = None):
    """``with span('model.sim'): ...`` records the block while spans are
    on; off, it costs one flag check. ``request``: the step or batch the
    block belongs to (default: its parent's, or for a root span the
    thread's current request)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return Span(rec, name, request)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Turn spans on for the block, on every thread; yields the list their
    records go into, in the order they began. Does not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = rec = _Recorder()
    try:
        yield rec.spans
    finally:
        _recorder = None


def self_ns(spans: List[Span]) -> List[Optional[int]]:
    """Each span's self time: its duration less the part of it that its
    children (on its thread, one after another) cover; None while open."""
    covered = {id(s): 0 for s in spans}
    for s in spans:
        p = s.parent
        if p is not None and s.end_ns is not None and id(p) in covered:
            end = s.end_ns if p.end_ns is None else min(s.end_ns, p.end_ns)
            covered[id(p)] += max(0, end - max(s.start_ns, p.start_ns))
    return [None if s.end_ns is None else s.end_ns - s.start_ns - covered[id(s)]
            for s in spans]


def chrome_events(spans: List[Span], base_ns: int, pid: Optional[int] = None) -> List[dict]:
    """The closed spans as Chrome-trace complete events on the clock of a
    ``torch.profiler`` trace whose ``baseTimeNanoseconds`` is ``base_ns``
    (µs since it), on this process (``pid``) and the span's thread.
    ``args`` carry the span's index in ``spans``, its parent's, its
    request and its self time in µs."""
    index = {id(s): i for i, s in enumerate(spans)}
    own = self_ns(spans)
    pid = os.getpid() if pid is None else pid
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": i, "parent": index.get(id(s.parent)), "request": s.request,
                      "self_us": own[i] / 1e3}}
            for i, s in enumerate(spans) if s.end_ns is not None]


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block: ``with trace('out/trace'): step()`` writes
    ``out/trace/trace.json`` (CPU activity, CUDA activity where there is a
    card, and the program's spans on their threads). Yields the profiler,
    whose ``key_averages()`` sums time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, recording() as spans:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(chrome_events(spans, doc["baseTimeNanoseconds"]))
    with open(path, "w") as f:
        json.dump(doc, f)
