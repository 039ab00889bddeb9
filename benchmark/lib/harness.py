"""What every kind shares: the run's settings, the clock since the
process started, the comparison with the limits, and the device's
readings."""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

from benchmark.lib.spec import Cell


def process_seconds() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against the machine's uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # filled by the kind for the metric readers: counts and host times
    stats: Dict = dataclasses.field(default_factory=dict)
    profile: Optional[object] = None        # lib.trace.Trace of the slice

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


@dataclasses.dataclass
class Outcome:
    """What a kind returns: its end-to-end metrics, its counts and the
    numbers that decide ``correct``."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int = 0


def checked(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name: each finite and at or under its limit. A limit whose number the
    kind did not give fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok &= good
        out[name] = {"value": value if value is None or math.isfinite(value)
                     else str(value), "limit": limit}
    return ok, out


def relative_gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| over the larger of |ref| and ``floor``."""
    return abs(prog - ref) / max(abs(ref), floor)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> Dict[str, float]:
    """Each `relative_gap` of a leaf's norm over the leaves ``keep`` names,
    against the larger of its reference norm and the median of theirs."""
    names = sorted(keep)
    if not names:
        return {}
    norms = sorted(ref[k] for k in names)
    median = norms[len(norms) // 2]
    return {k: relative_gap(prog.get(k, 0.0), ref[k], median) for k in names}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep) -> float:
    """The largest of `leaf_gaps`."""
    return max(leaf_gaps(prog, ref, keep).values(), default=float("nan"))


def mean_leaf(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> float:
    """The mean of `leaf_gaps`: steadier from seed to seed than the worst,
    which one small leaf's noise can set."""
    gaps = list(leaf_gaps(prog, ref, keep).values())
    return sum(gaps) / len(gaps) if gaps else float("nan")


def free() -> None:
    """Returns what the program's freed tensors held to the card."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
