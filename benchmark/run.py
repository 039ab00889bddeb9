"""Runs one cell of the benchmark once and prints its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell, its configuration, its traffic mix, its limits and its metrics
are found by name (``benchmark/lib/spec.py``). The run needs the cards the
cell asks for and fails without them; it builds or loads the program's
kernels, draws weights and inputs from ``--seed``, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints the numbers compared, each beside its limit, as its
last lines on standard error. Its last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from a
profiled slice of the window), ``device`` and, traced, ``breakdown``; the
numbers compared come last under ``check``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# module names whose presence means the JAX package or JAX was loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "neuspeech1_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names of loaded modules (``modules``: default
    ``sys.modules``) that are JAX's or the JAX package's, compared whole:
    ``neuspeech1_tpu_torch`` is the port."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def arguments(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int, peak: int, profile) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
    if profile is not None:
        info["busy_s"] = profile.busy_s
        info["window_s"] = profile.window_s
    return info


def execute(run, root=None) -> dict:
    """Runs ``run`` (a `harness.Run`) and returns the result object (on
    the CPU, which only the tests run on, without ``device``)."""
    from benchmark.lib import harness, spec

    outcome = spec.kind_module(run.cell.kind).run(run)
    correct, check = harness.checked(outcome.numbers, run.cell.limits)
    if run.trace:
        metrics = spec.read_metrics(run.cell, run, root)
    else:
        units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
        missing = set(units) - set(outcome.metrics)
        if missing:
            raise RuntimeError(f"the kind measured no {sorted(missing)}")
        metrics = {n: {"value": outcome.metrics[n], "unit": u}
                   for n, u in units.items()}
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics}
    if run.device != "cpu":
        result["device"] = device_info(run.cell.chips,
                                       outcome.memory_peak_bytes, run.profile)
    if run.trace and run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile.top_ops(),
                               "idle_gaps": run.profile.idle_gaps()}
    result["check"] = check
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = arguments(argv)
    import torch

    from benchmark.lib import harness, spec

    cell = spec.cell_spec(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace))
    result = execute(run)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
