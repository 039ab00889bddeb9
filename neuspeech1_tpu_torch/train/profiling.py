"""Tracing and step timing of the PyTorch port: the port of
``neuspeech1_tpu/train/profiling.py`` (the reference has none).

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

``Profiler`` records with ``torch.profiler`` (CPU and, where CUDA is
available, the card's kernels) from ``start_step`` until the step
``start_step + num_steps``, and writes a chrome trace
(``trace_<start>_<stop>.json``, chrome://tracing or Perfetto) into
``log_dir``. The JAX package writes TensorBoard's xplane; the port writes no
TensorBoard file (``torch.utils.tensorboard`` imports tensorflow).
``annotate`` names a region of the trace (``record_function``).
``StepTimer`` keeps wall-clock times; ``block`` waits for the devices of
the tensors it is given, so that a measured step includes its device work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class Profiler:
    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self.trace_path = None

    def maybe_start(self, step: int) -> None:
        if self._prof is None and step == self.start_step:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
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
        self.trace_path = os.path.join(
            self.log_dir, f"trace_{self.start_step}_{self.stop_step}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None


def annotate(name: str):
    """A named region in the trace timeline."""
    return torch.profiler.record_function(name)


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
