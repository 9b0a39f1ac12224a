"""Profiling and debugging (counterpart of `trafficbotsv15_tpu/utils/profiling.py`).

- `trace(log_dir, device)` captures a `torch.profiler` trace around a block
  (`Tracer` starts and stops one at two places, as `run.py`'s fit does for
  steps 3-5): CPU and CUDA activity on the card, CPU only where the caller
  asks for the CPU. Each rank writes its own Chrome/Perfetto JSON file,
  `<log_dir>/rank<r>.pt.trace.json.gz`, as JAX writes one trace per process.
  It records no shapes and no Python stacks: a training step issues
  thousands of device ops per rollout step, each an event.
- `annotate(name)` is a named range on the timeline (`record_function`).
- `nan_checks(enabled)` turns anomaly mode with NaN checks on for a block and
  restores the previous mode after it; `enable_nan_checks` sets it for the
  process. JAX's `jax_debug_nans` checks the output of every primitive,
  forward included; anomaly mode checks what each backward function returns
  and names the forward op that made a NaN.
- `StepTimer` keeps rolling per-phase wall-clock means (the JAX class as is).
- `read_trace`, `kernel_events`, `device_intervals`, `busy_seconds` and
  `annotation_windows` read a written trace back: kernel events by name, and
  the device's busy time inside a window of the host's clock.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.parallel.mesh import process_index
from trafficbotsv15_tpu_torch.utils.device import resolve_device

# the device-side events of a trace: what occupies the device's queues
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(log_dir: str) -> Path:
    """This rank's trace file in log_dir."""
    return Path(log_dir) / f"rank{process_index()}.pt.trace.json.gz"


class Tracer:
    """A torch.profiler trace written to `trace_path(log_dir)` on `stop()`; the card's work is synchronised before
    the profiler stops. `stop()` is idempotent, so a `finally` may call it again."""

    def __init__(self, log_dir: str, device=None):
        self.device = resolve_device(device)
        self.path = trace_path(log_dir)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.active = False

    def start(self) -> "Tracer":
        self.profiler.start()
        self.active = True
        return self

    def stop(self) -> Optional[Path]:
        """Stop and write the trace; -> its path (None when it was not running)."""
        if not self.active:
            return None
        self.active = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        plain = self.path.with_suffix("")  # exported plain, then gzip level 3 (the profiler's own .gz export is level 9)
        self.profiler.export_chrome_trace(str(plain))
        with open(plain, "rb") as src, gzip.open(self.path, "wb", compresslevel=3) as dst:
            shutil.copyfileobj(src, dst, 1 << 22)
        plain.unlink()
        return self.path


@contextlib.contextmanager
def trace(log_dir: str = "trace", device=None):
    """Capture a profiler trace around a block (view it in Perfetto or chrome://tracing); yields the file's path,
    which holds the trace once the block has left."""
    tracer = Tracer(log_dir, device).start()
    try:
        yield tracer.path
    finally:
        tracer.stop()


def annotate(name: str):
    """Named range that shows up on the timeline."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enabled: bool = True) -> None:
    """Anomaly mode with NaN checks for the whole process (the reference trainer's detect_anomaly)."""
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)


def nan_checks(enabled: bool = True):
    """Anomaly mode with NaN checks inside a block, the previous mode restored after it; a no-op when not enabled."""
    return torch.autograd.set_detect_anomaly(True, check_nan=True) if enabled else contextlib.nullcontext()


class StepTimer:
    """Rolling per-phase wall-clock stats (encode / rollout / metrics ...)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.counts: Dict[str, int] = {}
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            c = self.counts.get(name, 0)
            self.counts[name] = c + 1
            if c >= self.warmup:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def means(self) -> Dict[str, float]:
        return {
            k: self.totals.get(k, 0.0) / max(self.counts[k] - self.warmup, 1)
            for k in self.counts
        }


def read_trace(path) -> List[dict]:
    """The events of a Chrome trace file (.json or .json.gz) that have a time stamp."""
    path = Path(path)
    with (gzip.open(path, "rt") if path.suffix == ".gz" else open(path)) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if "ts" in e]


def kernel_events(events: List[dict]) -> List[dict]:
    """The device's kernel events."""
    return [e for e in events if e.get("cat") == "kernel"]


def annotation_windows(events: List[dict], name: str) -> List[Tuple[float, float]]:
    """(start, end) in µs of every host range named `name` (`annotate`), in time order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def device_intervals(events: List[dict]) -> List[Tuple[float, float]]:
    """The device's busy intervals in µs (kernels, copies, fills), merged where they overlap, in time order."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                   if e.get("cat") in DEVICE_CATEGORIES)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(intervals: List[Tuple[float, float]], t0: float, t1: float) -> float:
    """Seconds of the window [t0, t1] µs in which the device was busy."""
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in intervals) / 1e6
