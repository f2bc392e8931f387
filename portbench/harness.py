"""What every cell's run shares: the port built from a configuration file
and the benchmark's weights, the loaders that cycle the pool of batches,
the per-layer metrics' readers, the breakdown of a traced window, and
the result line.

From the port the benchmark takes the system under test (its config, its
model, its train and eval steps, its prefetch and evaluator) and nothing
else: weights, inputs, timings, FLOP counts and the reference are its own.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import queue
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

from portbench import readers, spec, yardstick

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "signal_tpu")


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float             # the process's start on the host clock

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


def forbidden_modules() -> List[str]:
    """The JAX side's top-level modules this process holds, compared as
    whole names (``signal_tpu_torch`` is not ``signal_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def build_port(run: Run, weights: Dict[str, torch.Tensor]):
    """(the port's config, its Signal model on the run's device with the
    benchmark's weights)."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models.signal_model import ModelSpec, Signal

    cfg = load_config(None, spec.port_overrides(run.cell.config)
                      + ["MODEL.DEVICE", repr(run.device.type)])
    assumed = run.cell.config["assumed"]
    mspec = ModelSpec.from_config(cfg, num_classes=assumed["num_classes"],
                                  camera_num=assumed["camera_num"])
    # the tower's sizes as the file states them (the published ViT-B/16's
    # are the port's own; a test's toy tower shrinks them)
    a = run.cell.config["architecture"]
    mspec = dataclasses.replace(mspec, width=a["width"], layers=a["layers"],
                                num_heads=a["heads"], feat_dim=a["feat_dim"])
    with torch.device(run.device):
        model = Signal(mspec)
    model.load_state_dict(weights, strict=True)
    return cfg, model


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Pool:
    """Cycles the pool's batches in order, from wherever the last loader
    stopped. A loader stops after ``n`` batches or once the host clock
    passes ``until``; ``issued`` gets the host time each batch is handed
    on (its host→device copy is issued next)."""

    def __init__(self, batches: List[dict]):
        self.batches, self.cursor = batches, 0

    def take(self, n: Optional[int] = None, until: Optional[float] = None,
             issued: Optional[List[float]] = None) -> Iterator[dict]:
        k = 0
        while (n is None or k < n) and (until is None or time.perf_counter() < until):
            batch = self.batches[self.cursor % len(self.batches)]
            self.cursor += 1
            k += 1
            if issued is not None:
                issued.append(time.perf_counter())
            yield batch


class Completion:
    """Host times at which work enqueued on the device completes: ``mark()``
    records an event on the current stream, and a thread waits for each in
    turn and notes the host clock when it has passed (on the CPU the work
    is done when ``mark`` is called)."""

    def __init__(self, cuda: bool):
        self.cuda, self.times = cuda, []
        self._stop = object()
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._wait, name="portbench-completion",
                                        daemon=True)
        self._thread.start()

    def mark(self) -> None:
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(blocking=True)
            ev.record()
        self._q.put(ev)

    def _wait(self) -> None:
        while True:
            ev = self._q.get()
            if ev is self._stop:
                return
            if ev is not None:
                ev.synchronize()
            self.times.append(time.perf_counter())

    def close(self) -> List[float]:
        self._q.put(self._stop)
        self._thread.join(timeout=600)
        if self._thread.is_alive():
            raise RuntimeError("the device never completed the window's work")
        return self.times


def nearest_rank(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank: a value that was measured."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def metric_readers(cell: spec.Cell):
    """(metric entry, its ``read``) for each per-layer metric of the cell."""
    out = []
    for m in cell.per_layer:
        path = HERE / "metrics" / f"{m['name']}.py"
        loader = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(module)
        out.append((m, module.read))
    return out


def per_layer(cell: spec.Cell, ctx: readers.Readings) -> Dict[str, dict]:
    out = {}
    for m, read in metric_readers(cell):
        value = read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(ctx: readers.Readings) -> Optional[dict]:
    """Over the timeline (CUDA activity alone): the device operations that
    took most time, and the idle gaps by what the main thread was in when
    each began (a CUDA call, or host work outside one), in seconds."""
    t = ctx.timeline
    if t is None or t.span() is None:
        return None
    by_name = defaultdict(float)
    for d in t.device_ops:
        by_name[d.name] += d.dur / 1e6
    gaps = yardstick.idle_gaps([(d.ts, d.ts + d.dur) for d in t.device_ops], *t.span())
    by_host = defaultdict(float)
    for (s, e), name in zip(gaps, t.host_at([s for s, _ in gaps])):
        by_host[name] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa
    return {"device_ops": top(by_name), "idle_gaps": top(by_host)}


def traced_device(ctx: readers.Readings) -> dict:
    """``busy_s`` and ``window_s`` of the timeline."""
    start, end = ctx.timeline.span()
    return {"busy_s": readers.busy_us(ctx) / 1e6, "window_s": (end - start) / 1e6}


def device_info(run: Run, peak_bytes: int) -> dict:
    if run.cuda:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def peak_bytes(run: Run) -> int:
    return torch.cuda.max_memory_allocated(run.device) if run.cuda else 0


def result(run: Run, *, ok: bool, attempted: int, failed: int, device: dict,
           checks: Dict[str, dict], values: Optional[dict] = None,
           ctx: Optional[readers.Readings] = None) -> dict:
    """The result line: the end-to-end ``values`` of a ``--trace 0`` run,
    or the per-layer metrics, the traced window's busy time and the
    breakdown read from ``ctx`` of a ``--trace 1`` run; ``checks`` last."""
    if run.trace:
        metrics = per_layer(run.cell, ctx)
        device = {**device, **traced_device(ctx)}
    else:
        units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
    out = {"correct": bool(ok and failed == 0), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    brk = breakdown(ctx) if run.trace else None
    if brk is not None:
        out["breakdown"] = brk
    out["checks"] = checks          # last: each compared number beside its limit
    return out


def emit(res: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def drive(run: Run) -> dict:
    """Run the cell: its traffic kind's driver (``kinds/<kind>.py``)."""
    module = importlib.import_module(f"portbench.kinds.{run.cell.kind}")
    return module.run(run)
