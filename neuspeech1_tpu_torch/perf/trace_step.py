"""Where the training step's device time goes: the counterpart of the JAX
package's root ``perf/trace_step.py``.

    python -m neuspeech1_tpu_torch.perf.trace_step [--steps 8]
        [--remat false] [--top 40] [--tracedir DIR]

Runs ``bench.py``'s configuration (whisper-base EEG, batch 64, bf16 compute
on f32 masters, LoRA r=32 and the stem, the 'fc' fold, remat per
``--remat``): 3 warm-up steps, ``--steps`` steps timed by CUDA events (the
host clock off the card), then ``--steps`` more under ``torch.profiler``
through ``train/profiling.py``'s `Profiler`, whose chrome trace its
`parse_trace` reads:

- the device's busy time over the traced span, as the union of the leaf
  device intervals (kernels, copies and sets), and the idle rest;
- the top kernel groups (a kernel's name up to its template or argument
  list) and the top kernel names, in ms per step;
- the table of the program's spans (``ns/train/step`` and the stages
  inside it), from the Profiler's summary: per span its count and, in ms
  per step, host time total and self, the device's idle time it names and
  the device time of the kernels it launched.

Prints the JAX script's report and the span table, then one JSON line:
``wall_ms_per_step``, ``steps``, ``span_ms``, ``busy_ms``, ``idle_ms``,
``busy_share``, ``kernels`` (device events in the span), ``top_groups`` and
``top_ops`` ([name, ms per step] pairs), ``spans`` ({span: {count,
host_ms, self_ms, idle_ms, device_ms}}, ms per step), ``idle_named_share``
(the share of the window's idle time some span names), ``counters`` (their
changes over the traced steps), ``trace`` and ``summary`` (the files).
There are no container events to leave out: the profiler's device rows
hold kernels only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import List, Optional

import torch

from neuspeech1_tpu_torch.perf import serve_bench
from neuspeech1_tpu_torch.train.profiling import (Profiler, parse_trace,
                                                  span_lines)


def _timed_steps(step, state, frozen, batch, n: int, device) -> float:
    """ms a step over ``n`` chained steps: CUDA events on the card, the
    host clock elsewhere."""
    import time

    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            step(state, frozen, batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        m = step(state, frozen, batch)
    float(m["loss"])
    return (time.perf_counter() - t0) * 1e3 / n


def run(config, stem, steps: int = 8, top: int = 40, tracedir: str = "",
        batch_size: int = 64, device="cuda", emit=print) -> dict:
    """The report's lines, each passed to ``emit``; returns the JSON
    result."""
    from neuspeech1_tpu_torch.bench import train_setup

    device = torch.device(device)
    step, state, frozen, batch = train_setup(config, stem, batch_size, device)
    for _ in range(3):  # the allocator, library handles, the lr-0 step
        float(step(state, frozen, batch)["loss"])
    wall = _timed_steps(step, state, frozen, batch, steps, device)

    prof = Profiler(tracedir or tempfile.mkdtemp(prefix="trace_step"),
                    start_step=0, num_steps=steps)
    prof.maybe_start(0)
    for _ in range(steps):
        m = step(state, frozen, batch)
    float(m["loss"])
    prof.maybe_stop(steps)
    busy, span, by_name, by_group, n = parse_trace(prof.trace_path)

    emit(f"wall {wall:.3f} ms/step; traced span {span / 1e3:.3f} ms "
         f"({span / 1e3 / steps:.3f}/step), busy {busy / 1e3:.3f} ms "
         f"({100 * busy / max(span, 1e-9):.1f}%), {n} device events")
    result = {
        "wall_ms_per_step": wall, "steps": steps, "span_ms": span / 1e3,
        "busy_ms": busy / 1e3, "idle_ms": (span - busy) / 1e3,
        "busy_share": busy / span if span else None, "kernels": n,
        "top_groups": [[k, d / 1e3 / steps]
                       for k, d in by_group.most_common(top)],
        "top_ops": [[k, d / 1e3 / steps]
                    for k, d in by_name.most_common(top)],
        "spans": {name: {k: v if k == "count" else v / steps
                         for k, v in row.items()}
                  for name, row in prof.summary["spans"].items()},
        "idle_named_share": prof.summary["idle_named_share"],
        "counters": prof.summary["counters"],
        "trace": prof.trace_path,
        "summary": prof.summary_path,
    }
    for title, rows in (("top groups", result["top_groups"]),
                        ("top ops", result["top_ops"])):
        emit(f"\n-- {title} (ms/step over {steps} steps) --")
        for name, ms in rows:
            emit(f"{ms:8.3f}  {name[:160]}")
    emit(f"\n-- spans (ms over {steps} steps) --")
    for line in span_lines(prof.summary, top):
        emit(line)
    emit(json.dumps(result))
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--remat", default="false")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--tracedir", default="")
    ap.add_argument("--model", default="base",
                    help="a Whisper size, or 'test' for the tiny config")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config, stem = serve_bench.model_config(args.model)
    config = dataclasses.replace(
        config, remat=args.remat.lower() in ("1", "true", "yes"))
    if args.tracedir:
        os.makedirs(args.tracedir, exist_ok=True)
    run(config, stem, args.steps, args.top, args.tracedir, args.batch,
        args.device, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
