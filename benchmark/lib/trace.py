"""The traced run's profile: a contiguous slice of the window under
``torch.profiler``, and the reading of its chrome trace.

`group_of`, `union_busy` and the device categories are frozen copies of
``neuspeech1_tpu_torch/perf/trace_step.py``'s (the union of the leaf device
intervals: kernels, copies and sets), kept here so that a change to the
program cannot move the yardstick.

The benchmark's own spans (``torch.profiler.record_function`` in the
kinds' loops) come back as the trace's ``user_annotation`` events; an idle
gap on the device is named by the innermost span open on the host at its
middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import tempfile
import time
from typing import List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench/"


def group_of(name: str) -> str:
    """A kernel's group: its name without a leading ``void``, anonymous
    namespaces, the template arguments and the argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.sub(r"[<(].*$", "", name).strip()


def union_busy(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(hi - lo for lo, hi in merged(intervals))


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


@dataclasses.dataclass
class Trace:
    """One profiled slice. Times in seconds; ``ops`` are the device
    events as (name, start, duration)."""

    window_s: float                    # host clock over the slice
    busy_s: float                      # union of the device intervals
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]   # the benchmark's, on the host
    units: int                         # steps or requests in the slice

    def device_seconds(self, match) -> float:
        """Device seconds of the ops whose name ``match(name)`` accepts."""
        return sum(d for name, _, d in self.ops if match(name))

    def count(self, match) -> int:
        return sum(1 for name, _, _ in self.ops if match(name))

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, _, d in self.ops:
            by[group_of(name)] += d
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device work, each named by the
        innermost benchmark span open on the host at its middle."""
        busy = merged((t, t + d) for _, t, d in self.ops)
        gaps = [(hi0, lo1 - hi0) for (_, hi0), (lo1, _)
                in zip(busy, busy[1:]) if lo1 > hi0]
        gaps.sort(key=lambda g: -g[1])
        out = []
        for start, length in gaps[:n]:
            name, best = "none", None
            mid = start + length / 2
            for span, t0, d in self.spans:
                if t0 <= mid <= t0 + d and (best is None or d < best):
                    name, best = span, d
            out.append([name, length])
        return out


def parse(path: str, window_s: float, units: int) -> Trace:
    """The slice's `Trace` from its chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("dur") is None:
            continue
        t, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if e.get("cat") in DEVICE_CATEGORIES:
            ops.append((e["name"], t, d))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith(SPAN_PREFIX)):
            spans.append((e["name"], t, d))
    ops.sort(key=lambda o: o[1])
    busy = union_busy((t, t + d) for _, t, d in ops)
    return Trace(window_s=window_s, busy_s=busy, ops=ops, spans=spans,
                 units=units)


class Slice:
    """Profiles ``units`` steps or requests of the window once
    ``after`` have run: `tick` after each unit has finished. A slice whose trace holds no device event (the profiler now and then
    returns one) is taken again on the next units. The trace goes to a
    directory under ``TMPDIR`` that `close` removes."""

    def __init__(self, enabled: bool, after: int, units: int,
                 attempts: int = 3):
        self.enabled = enabled
        self.after, self.units, self.attempts = after, units, attempts
        self.prof = None
        self.t0 = 0.0
        self.start_unit: Optional[int] = None
        self.found: Optional[Tuple[str, float]] = None  # (path, seconds)
        self.traced_units: List[int] = []
        # units that waited for the profiler: a failed slice's, and the
        # one after each slice, which waited for its export
        self.stalled: List[int] = []
        self.dir = tempfile.mkdtemp(prefix="bench_trace") if enabled else None

    def touched(self) -> set:
        """The units the profiler ran over or stalled."""
        return set(self.traced_units) | set(self.stalled)

    def tick(self, unit: int) -> None:
        """Called after unit ``unit`` (0-based) has finished."""
        if not self.enabled or self.found is not None:
            return
        if self.prof is not None:
            self.traced_units.append(unit)
            if unit + 1 - self.start_unit >= self.units:
                self._stop(unit)
        elif unit + 1 >= self.after and self.attempts > 0:
            self._start(unit + 1)

    def _start(self, unit: int) -> None:
        import torch

        self.attempts -= 1
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.start_unit = unit
        self.t0 = time.perf_counter()

    def _stop(self, unit: int) -> None:
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.dir, f"trace{self.attempts}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(path) as f:
            has_device = '"cat": "kernel"' in f.read()
        self.stalled.append(unit + 1)
        if has_device:
            self.found = (path, window)  # parsed after the window (`read`)
        else:
            os.remove(path)
            self.stalled += self.traced_units
            self.traced_units = []

    def read(self) -> Optional[Trace]:
        """The slice's trace, parsed once the window has closed (None if
        the window closed before a slice with device events)."""
        if self.found is None:
            return None
        return parse(*self.found, self.units)

    def close(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)


def span(name: str):
    """A benchmark span: ``record_function("bench/<name>")``."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)
