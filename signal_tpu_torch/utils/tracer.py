"""Execution tracer — call/line tracing of a training run (the port's
own copy of `signal_tpu/utils/tracer.py`, which uses no JAX).

Mirrors `scripts/trace_execution.py` (maxingan2412/Signal): a
``sys.settrace``-based tracer with 'calls' / 'lines' modes writing
`trace_log.txt`, filtered to project files. Complements (not replaces)
`signal_tpu_torch.utils.profiler.trace`, which captures the DEVICE
timeline.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


class ExecutionTracer:
    def __init__(self, mode: str = "calls", out_path: str = "trace_log.txt",
                 project_root: Optional[str] = None, max_events: int = 100000):
        if mode not in ("calls", "lines"):
            raise ValueError(f"mode {mode!r}: 'calls' or 'lines'")
        self.mode = mode
        self.out_path = out_path
        self.root = os.path.abspath(project_root or os.getcwd())
        self.max_events = max_events
        self._events = []
        self._depth = 0

    def _in_project(self, frame) -> bool:
        fn = frame.f_code.co_filename
        return fn.startswith(self.root) and "site-packages" not in fn

    def _trace(self, frame, event, arg):
        if len(self._events) >= self.max_events:
            return None
        if event == "call":
            if self._in_project(frame):
                code = frame.f_code
                rel = os.path.relpath(code.co_filename, self.root)
                self._events.append(
                    f"{'  ' * self._depth}→ {code.co_name}  ({rel}:{frame.f_lineno})")
                self._depth += 1
                # local tracing must stay on even in 'calls' mode: the
                # 'return' events it delivers drive the depth bookkeeping
                return self._trace
            return None
        if event == "return" and self._in_project(frame):
            self._depth = max(0, self._depth - 1)
        elif event == "line" and self.mode == "lines" and self._in_project(frame):
            rel = os.path.relpath(frame.f_code.co_filename, self.root)
            self._events.append(f"{'  ' * self._depth}| {rel}:{frame.f_lineno}")
        return self._trace

    def __enter__(self):
        sys.settrace(self._trace)
        return self

    def __exit__(self, *exc):
        sys.settrace(None)
        with open(self.out_path, "w") as f:
            f.write("\n".join(self._events) + "\n")
        return False


def trace_callable(fn, *args, mode: str = "calls", out_path: str = "trace_log.txt", **kw):
    with ExecutionTracer(mode=mode, out_path=out_path):
        return fn(*args, **kw)
