"""Tracing and step timing of the PyTorch port: its one tracing system (the
port of ``neuspeech1_tpu/train/profiling.py``, which has only a profiler
window).

    prof = Profiler("output/profile", start_step=10, num_steps=5)
    timer = StepTimer()
    for step in ...:
        prof.maybe_start(step)
        with timer.measure():
            with annotate("train_step"):
                metrics = train_step(...)
            timer.block(metrics)
        prof.maybe_stop(step)
    prof.close()

**Spans.** The port's layers mark their boundaries with `span` (``with
span("decode/select"): ...``) and, for a whole function, `traced`. Tracing
is on exactly while a ``torch.profiler`` session records on the calling
thread (``torch.autograd._profiler_enabled()``): the benchmark's traced
slice, ``perf/trace_step.py``, `Profiler`, or an operator's own
``torch.profiler.profile()``. Then a span is
``record_function("ns/" + name)``, whose start and end come out in the
chrome trace as ``user_annotation`` events on the clock of the device's
events. With nothing recording a span costs that one check and returns a
shared no-op context: it calls no ``record_function`` (which costs
microseconds even with nothing recording). Spans nest: everything of one
training step lies inside ``ns/train/step``, of one decode call inside
``ns/decode/generate`` (these two are `unit` spans), of one served batch
inside ``ns/serve/batch``.

**Counters.** `count` adds to in-memory counters keyed by name and
`counters` returns a snapshot; a caller takes the change between two
snapshots. A count on the hot path is taken only while tracing is on
(``always=False``); a few counters of paths off the hot path count always.
`count_device` adds a 0-d device tensor without waiting for the device:
the value is read, all pending ones with one copy, when `counters` is next
called. While tracing is on:

- every garbage collection of Python's ``gc`` is a span ``ns/host/gc``
  (a ``gc.callbacks`` hook, installed at import) and counts
  ``host.gc_collections`` and ``host.gc_ms``;
- each unit span on a CUDA device counts the change over the unit in the
  caching allocator's ``num_alloc_retries`` (``cuda.alloc_retries``) and
  in its device mallocs (``cuda.mallocs``).

**Profiler.** `Profiler` records with ``torch.profiler`` (CPU and, where
CUDA is available, the card's kernels) from ``start_step`` until the step
``start_step + num_steps``, and writes a chrome trace
(``trace_<start>_<stop>.json``, chrome://tracing or Perfetto) into
``log_dir`` and beside it ``summary_<start>_<stop>.json``, `summarize`'s
table of the program's spans (count, host ms total and self, the device's
idle ms each names, the device ms of the kernels each launched) with the
counters' changes over the window. The JAX package writes TensorBoard's
xplane; the port writes no TensorBoard file (``torch.utils.tensorboard``
imports tensorflow). `parse_trace`, `union_busy` and `group_of` read a
chrome trace's device events (``perf/trace_step.py`` prints them).

``annotate`` names a region of the trace under the caller's own name,
with a span's cost. ``StepTimer`` keeps wall-clock times; ``block`` waits
for the devices of the tensors it is given, so that a measured step
includes its device work.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import os
import re
import threading
import time
from typing import Dict, Iterable, Tuple

import torch

# the prefix of the program's spans in a trace
PREFIX = "ns/"
# the trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# whether a torch.profiler session records on this thread: the one check a
# span makes
tracing = torch.autograd._profiler_enabled

_NULL = contextlib.nullcontext()
_counters: Dict[str, float] = {}
# (name, 0-d tensor) counts not read yet (`count_device`)
_pending: list = []
# reentrant: a collection that a count's own allocation sets off counts too
_lock = threading.RLock()


def span(name: str):
    """``record_function("ns/" + name)`` while tracing is on, else a shared
    no-op context."""
    if not tracing():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def annotate(name: str):
    """A region of the trace under ``name`` as given (no program prefix):
    a span for an operator's own code."""
    if not tracing():
        return _NULL
    return torch.profiler.record_function(name)


def unit(name: str):
    """The span of a training step or a decode call: `span`, and while
    tracing on a CUDA device, the allocator's retries and device mallocs
    over it counted."""
    if not tracing():
        return _NULL
    return _Unit(PREFIX + name)


def traced(name: str, as_unit: bool = False):
    """A decorator: the function runs inside `span` (`unit` with
    ``as_unit``) ``name``."""
    enter = unit if as_unit else span

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not tracing():
                return fn(*args, **kwargs)
            with enter(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: float = 1, always: bool = False) -> None:
    """Adds ``n`` to the counter ``name``: while tracing is on, or with
    ``always``."""
    if always or tracing():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """Adds the 0-d tensor ``value`` to the counter ``name`` while tracing
    is on, without a sync: it is read when `counters` is next called."""
    if tracing():
        with _lock:
            _pending.append((name, value.detach()))


def counters() -> Dict[str, float]:
    """A snapshot of every counter (reading the pending device counts)."""
    with _lock:
        by_device: Dict[torch.device, list] = {}
        for name, v in _pending:
            by_device.setdefault(v.device, []).append((name, v))
        for counts in by_device.values():
            values = torch.stack([v.double() for _, v in counts]).cpu()
            for (name, _), v in zip(counts, values.tolist()):
                _counters[name] = _counters.get(name, 0) + v
        _pending.clear()
        return dict(_counters)


def counter_changes(before: Dict[str, float]) -> Dict[str, float]:
    """Each counter's change since the snapshot ``before``, the counters
    that moved only."""
    return {k: v - before.get(k, 0) for k, v in sorted(counters().items())
            if v != before.get(k, 0)}


def _allocator() -> Tuple[int, int]:
    stats = torch.cuda.memory_stats()
    return (stats.get("num_alloc_retries", 0),
            stats.get("num_device_alloc", 0))


class _Unit:
    """A unit span with the allocator's counts over it."""

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(name)
        self.start = None

    def __enter__(self):
        if torch.cuda.is_initialized():
            self.start = _allocator()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if self.start is not None:
            retries, mallocs = _allocator()
            count("cuda.alloc_retries", retries - self.start[0], always=True)
            count("cuda.mallocs", mallocs - self.start[1], always=True)
        return False


# ``ns/host/gc`` around each collection while tracing is on; a collection
# holds the GIL from its start to its stop, so one slot serves every thread
_gc_open = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if tracing():
            rf = torch.profiler.record_function(PREFIX + "host/gc")
            rf.__enter__()
            _gc_open.append((rf, time.perf_counter()))
    elif _gc_open:
        rf, t0 = _gc_open.pop()
        rf.__exit__(None, None, None)
        count("host.gc_collections", always=True)
        count("host.gc_ms", 1e3 * (time.perf_counter() - t0), always=True)


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)


# --------------------------------------------------------------------------
# reading a chrome trace
# --------------------------------------------------------------------------

def group_of(name: str) -> str:
    """A kernel's group: its name without a leading ``void``, anonymous
    namespaces, the template arguments and the argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.sub(r"[<(].*$", "", name).strip()


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def union_busy(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(hi - lo for lo, hi in merged(intervals))


def _events(trace) -> list:
    """The chrome trace's events: ``trace`` is a path, a trace object or
    its event list."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace["traceEvents"]
    return trace


def _device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES
            and e.get("dur") is not None]


def parse_trace(path: str):
    """(busy us, span us, us by kernel name, us by group, device events)
    of a chrome trace."""
    leafs = _device_events(_events(path))
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in leafs]
    span_us = (max(hi for _, hi in iv) - min(lo for lo, _ in iv)
               if iv else 0.0)
    by_name = collections.Counter()
    for e in leafs:
        by_name[e["name"]] += float(e["dur"])
    by_group = collections.Counter()
    for name, d in by_name.items():
        by_group[group_of(name)] += d
    return union_busy(iv), span_us, by_name, by_group, len(leafs)


def summarize(trace, prefixes: Iterable[str] = (PREFIX,),
              gaps: int = 10) -> dict:
    """The table of spans of a chrome trace (a path, a trace object or its
    events), in ms, for the spans whose names start with one of
    ``prefixes``:

    - ``count``, ``host_ms`` (the spans' total) and ``self_ms`` (less the
      spans nested directly inside them on the same thread);
    - ``idle_ms``: the device's idle time (the window, from the trace's
      first to its last event, less the union of its kernels, copies and
      sets) in gaps whose middle falls inside the span as the innermost
      (shortest) span open on any thread;
    - ``device_ms``: the device time of the kernels, copies and sets
      launched inside it: a device event is matched to its launch by the
      trace's correlation id, the launch to the innermost span open on the
      launching thread at that moment (else on any thread).

    Besides: the window, busy and idle ms, the idle ms that some span
    names (``idle_named_ms``, ``idle_named_share``), the device ms of
    events no span launched, and the ``gaps`` longest gaps with their
    spans ("none" where no span was open)."""
    prefixes = tuple(prefixes)
    events = [e for e in _events(trace)
              if e.get("ph") == "X" and e.get("dur") is not None]
    device, launches, spans = [], {}, []
    for e in events:
        ts, dur, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, corr))
        elif cat == "user_annotation" and e["name"].startswith(prefixes):
            spans.append((ts, ts + dur, e["name"], e.get("tid")))
        elif corr is not None and cat != "gpu_user_annotation":
            launches[corr] = (ts, e.get("tid"))
    lo = min((float(e["ts"]) for e in events), default=0.0)
    hi = max((float(e["ts"]) + float(e["dur"]) for e in events), default=0.0)
    busy = merged((a, b) for a, b, _ in device)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = ([(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
            if busy else [])

    # one sweep in time over the spans' closes (0) and opens (1), the gaps'
    # middles (2) and the launches (3), each thread's open spans a stack;
    # at one instant a child closes before its parent and opens after it
    ev = []
    for i, (a, b, _, _) in enumerate(spans):
        ev.append((a, 1, -(b - a), i))
        ev.append((b, 0, b - a, i))
    for j, (a, b) in enumerate(idle):
        ev.append(((a + b) / 2, 2, 0.0, j))
    for k, (a, b, corr) in enumerate(device):
        if corr in launches:
            ev.append((launches[corr][0], 3, 0.0, k))
    ev.sort()
    stacks = collections.defaultdict(list)
    child = [0.0] * len(spans)
    gap_of, launch_of = [None] * len(idle), [None] * len(device)

    def innermost(tid=None):
        if tid is not None and stacks.get(tid):
            return stacks[tid][-1]
        tops = [s[-1] for s in stacks.values() if s]
        return min(tops, key=lambda i: spans[i][1] - spans[i][0],
                   default=None)

    for _, kind, _, i in ev:
        if kind == 1:
            stack = stacks[spans[i][3]]
            if stack:
                child[stack[-1]] += spans[i][1] - spans[i][0]
            stack.append(i)
        elif kind == 0:
            stack = stacks[spans[i][3]]
            if i in stack:
                stack.remove(i)
        elif kind == 2:
            gap_of[i] = innermost()
        else:
            launch_of[i] = innermost(launches[device[i][2]][1])

    table = {}
    for i, (a, b, name, _) in enumerate(spans):
        row = table.setdefault(name, {"count": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "idle_ms": 0.0,
                                      "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (b - a) / 1e3
        row["self_ms"] += (b - a - child[i]) / 1e3
    named = 0.0
    for (a, b), i in zip(idle, gap_of):
        if i is not None:
            table[spans[i][2]]["idle_ms"] += (b - a) / 1e3
            named += b - a
    unnamed_device = 0.0
    for (a, b, _), i in zip(device, launch_of):
        if i is None:
            unnamed_device += b - a
        else:
            table[spans[i][2]]["device_ms"] += (b - a) / 1e3
    idle_us = sum(b - a for a, b in idle)
    longest = sorted(zip(idle, gap_of), key=lambda g: g[0][0] - g[0][1])
    return {
        "window_ms": (hi - lo) / 1e3,
        "busy_ms": sum(b - a for a, b in busy) / 1e3,
        "idle_ms": idle_us / 1e3,
        "idle_named_ms": named / 1e3,
        "idle_named_share": named / idle_us if idle_us else None,
        "device_unnamed_ms": unnamed_device / 1e3,
        "spans": dict(sorted(table.items(), key=lambda kv: -kv[1]["host_ms"])),
        "longest_gaps": [["none" if i is None else spans[i][2], (b - a) / 1e3]
                         for (a, b), i in longest[:gaps]],
    }


def span_lines(summary: dict, top: int = 40) -> list:
    """`summarize`'s table as text lines, the spans by host ms."""
    lines = [f"{'host ms':>10} {'self ms':>10} {'idle ms':>10} "
             f"{'device ms':>10} {'count':>6}  span"]
    for name, r in list(summary["spans"].items())[:top]:
        lines.append(f"{r['host_ms']:10.3f} {r['self_ms']:10.3f} "
                     f"{r['idle_ms']:10.3f} {r['device_ms']:10.3f} "
                     f"{r['count']:6d}  {name}")
    share = summary["idle_named_share"]
    lines.append(f"idle {summary['idle_ms']:.3f} ms of a "
                 f"{summary['window_ms']:.3f} ms window, "
                 + ("no device events" if share is None else
                    f"{100 * share:.1f}% named by a span"))
    return lines


class Profiler:
    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._counters = {}
        self.trace_path = None
        self.summary_path = None
        self.summary = None

    def maybe_start(self, step: int) -> None:
        if self._prof is None and step == self.start_step:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._counters = counters()
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self._stop()
            print(f"[profiler] trace written to {self.trace_path}",
                  flush=True)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        self._prof.stop()
        changes = counter_changes(self._counters)
        tag = f"{self.start_step}_{self.stop_step}"
        self.trace_path = os.path.join(self.log_dir, f"trace_{tag}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.summary = {**summarize(self.trace_path), "counters": changes}
        self.summary_path = os.path.join(self.log_dir, f"summary_{tag}.json")
        with open(self.summary_path, "w") as f:
            json.dump(self.summary, f, indent=1)


class StepTimer:
    """Wall-clock step times in seconds (``times``)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def block(self, tree) -> float:
        """Waits for the devices of every tensor in ``tree`` (a tensor, or
        dicts, lists and tuples of them); returns the seconds it waited."""
        t0 = time.perf_counter()
        devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
        for d in devices:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
