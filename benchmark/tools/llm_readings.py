"""The readings that a language-model training cell's limits are set from
(``kinds/llm_train_step.py``): its numbers for the program as the
configuration states it over many seeds, for the control, and for the
faults such a cell can have. Not run by the benchmark's own runs.

    python3 -m benchmark.tools.llm_readings --workload moe-llm-train-b32 \\
        --seeds 100:106 [--mode sound] [--mode fp8_reference] \\
        [--mode half_batch] [--mode unbiased_route] [--mode top5] \\
        [--mode one_rank_off]

- ``sound``: the program as its configuration states;
- ``fp8_reference``: the control, the plain reference in the program's
  place computed in fp8, the precision below the configuration's bf16
  (every product's operands rounded to e4m3 with a scale per row), on the
  rows the program's first steps take, choosing its own experts, which
  the f32 reference then follows;
- ``half_batch``: each step fed half of its batch's rows;
- ``unbiased_route``: the program choosing its experts on the unbiased
  scores (no correction bias);
- ``top5``: the program routing each token to one expert fewer than the
  configuration's (top-5 of Kimi-VL's top-6), its weights normalized over
  those;
- ``one_rank_off``: in one routed layer alone (the first), the program
  routing each token to its 7th-best expert by score + bias in place of
  its 6th.

A reading needs no window: the set-up's checked steps, then the
reference. One JSON line per reading, then the largest and smallest of
each number per mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark.lib import harness, spec

MODES = ("sound", "fp8_reference", "half_batch", "unbiased_route", "top5",
         "one_rank_off")


def rank_off(x, gate_w, bias, top_k, norm_topk, scale):
    """``moe_lm.select`` with the k-th best expert by score + bias traded
    for the (k+1)-th."""
    import torch
    import torch.nn.functional as F

    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    ranked = torch.topk(scores.detach() + bias.float(), top_k + 1,
                        dim=-1).indices
    idx = torch.cat([ranked[:, :top_k - 1], ranked[:, top_k:]], dim=-1)
    weight = scores.gather(1, idx)
    if norm_topk and top_k > 1:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * scale


@contextlib.contextmanager
def fault(mode: str):
    """The program's router altered as ``mode`` says (``unbiased_route``,
    ``top5``, ``one_rank_off``), or left as it is."""
    if mode not in ("unbiased_route", "top5", "one_rank_off"):
        yield
        return
    from neuspeech1_tpu_torch.models import moe_lm

    real = moe_lm.select
    first = []                 # the first routed layer's router weight

    def select(x, gate_w, bias, top_k, norm_topk, scale):
        if mode == "unbiased_route":
            return real(x, gate_w, bias * 0, top_k, norm_topk, scale)
        if mode == "top5":
            return real(x, gate_w, bias, top_k - 1, norm_topk, scale)
        if not first:
            first.append(gate_w)
        if gate_w is first[0]:
            return rank_off(x, gate_w, bias, top_k, norm_topk, scale)
        return real(x, gate_w, bias, top_k, norm_topk, scale)

    moe_lm.select = select
    try:
        yield
    finally:
        moe_lm.select = real


def halved(step):
    """``step`` fed half of each batch's rows."""
    def run(state, frozen, batch):
        return step(state, frozen,
                    {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return run


def reading(r, mode: str) -> dict:
    import torch

    from benchmark.kinds import llm_train_step as kind
    from benchmark.lib import data
    from benchmark.reference import meg_llm

    if mode == "fp8_reference":
        b = r.traffic["batch"]
        order = data.train_order(r.traffic, r.seed, 0, r.device).cpu()
        rows = [order[i * b:(i + 1) * b]
                for i in range(r.traffic["checked_steps"])]
        checked = meg_llm.replay(r.config, r.traffic, r.seed, rows,
                                 torch.device(r.device), precision="fp8")
        checked["rows"] = rows
    else:
        with fault(mode):
            step, state, frozen, feed = kind.build(r)
            if mode == "half_batch":
                step = halved(step)
            checked = kind.checked_steps(r, step, state, frozen, feed)
            r.sync()
        del step, state, frozen, feed
        harness.free()
    detail = {}
    out = kind.numbers(r, checked, detail)
    for name in ("grad", "change"):
        gaps = detail[name]
        worst = sorted(gaps, key=lambda k: -abs(gaps[k]))[:4]
        out[f"{name}_worst_leaves"] = [[k, gaps[k]] for k in worst]
        mags = sorted(abs(v) for v in gaps.values())
        out[f"{name}_median_leaf_gap"] = mags[len(mags) // 2]
    out["losses"] = detail["losses"]
    out["left_out"] = detail["left_out"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first:last+1")
    ap.add_argument("--mode", action="append", choices=MODES)
    args = ap.parse_args(argv)
    cell = spec.cell_spec(args.workload)
    if cell.kind != "llm_train_step":
        raise SystemExit(f"{cell.name} is a {cell.kind} cell: "
                         "benchmark.tools.readings reads it")
    from benchmark.lib import program
    from neuspeech1_tpu_torch.ops import moe_gemm

    program.build_kernels()
    moe_gemm._library()
    lo, hi = (int(x) for x in args.seeds.split(":"))
    summary = {}
    for mode in args.mode or ["sound"]:
        for seed in range(lo, hi):
            t0 = time.perf_counter()
            r = harness.Run(cell=cell, seed=seed, seconds=0, trace=False)
            numbers = reading(r, mode)
            print(json.dumps({"cell": cell.name, "mode": mode, "seed": seed,
                              "seconds": time.perf_counter() - t0,
                              **numbers}), flush=True)
            for k, v in numbers.items():
                if isinstance(v, (int, float)):
                    summary.setdefault(mode, {}).setdefault(k, []).append(v)
    for mode, nums in summary.items():
        print(json.dumps({"cell": cell.name, "mode": mode, "summary": {
            k: {"max": max(v), "min": min(v), "n": len(v)}
            for k, v in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
