"""The readings that a cell's limits are set from: the numbers that decide
``correct``, for the program as the configuration states it over many
seeds, for the controls, and for the faults a training cell can have. Not
run by the benchmark's own runs.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 100:112
        [--mode sound] [--mode fp8_reference] [--mode int8_program]
        [--mode half_batch]

- ``sound``: the program as its configuration states;
- ``fp8_reference``: the control, the plain reference in the program's
  place computed in fp8, the precision below the configuration's bf16
  (every product's operands rounded to e4m3 with a scale per row): for a
  training cell its first steps, for a decode cell its first choice at
  each position of the program's served prompts and tokens;
- ``int8_program``: the program's own int8 path, the training step under
  ``int8_matmul="full"``, the served model with int8 weights and the int8
  cross cache (PERF.md gives why it is not the control);
- ``half_batch`` (training): each step fed half of its batch's rows, the
  mean taken over them;
- ``greedy``, ``two_beams`` (decode): the program serving one or two
  beams in place of the mix's.

A decode reading also gives the served hypotheses' scores against the
reference's own beam search (``score_gap``, widest and mean over
``SCORE_CLIPS`` clips), which no cell compares (PERF.md).

A training reading needs no window: the set-up's checked steps, then the
reference. A decode reading serves ``checked_requests`` requests, as many
as a run compares. One JSON line per reading, then the largest and
smallest of each number per mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark.lib import harness, program, spec

# clips of a decode reading's sample that the reference's beam search reads
SCORE_CLIPS = 64


def train_reading(r, mode: str) -> dict:
    import torch

    from benchmark.kinds import train_step as kind
    from benchmark.lib import data
    from benchmark.reference import train as ref_train

    if mode == "fp8_reference":
        b = r.traffic["batch"]
        order = data.train_order(r.traffic, r.seed, 0, r.device).cpu()
        rows = [order[i * b:(i + 1) * b]
                for i in range(r.traffic["checked_steps"])]
        checked = ref_train.replay(r.config, r.traffic, r.seed, rows,
                                   torch.device(r.device), precision="fp8")
        checked["rows"] = rows
    else:
        options = {"int8_matmul": "full"} if mode == "int8_program" else {}
        step, state, frozen, feed = kind.build(r, **options)
        if mode == "half_batch":
            full = step

            def step(state, frozen, batch):
                half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                return full(state, frozen, half)
        checked = kind.checked_steps(r, step, state, frozen, feed)
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


def decode_reading(r, mode: str) -> dict:
    import torch

    from benchmark.kinds import decode as kind
    from benchmark.lib import data, weights
    from benchmark.reference import decode as ref_decode

    beams = {"greedy": 1, "two_beams": 2}.get(mode)
    request, pool = kind.build(r, int8=mode == "int8_program",
                               num_beams=beams)
    served = [request(i)[0] for i in range(r.traffic["checked_requests"])]
    del request
    harness.free()
    detail = {}
    control = mode == "fp8_reference"
    out = kind.numbers(r, served, pool, detail, control=control)
    gaps, below_best = detail["gaps"], detail["below_best"]
    # how far each hypothesis leaves its rows' best before the last token
    detour = np.nanmax(below_best[:, :-1], axis=1)
    for tau in (0.01, 0.03, 0.05, 0.1):
        out[f"greedy_share_{tau}"] = float(np.mean(detour < tau))
    out.update(detour_median=float(np.median(detour)),
               last_widest=float(np.nanmax(gaps[:, -1])),
               inner_widest=float(np.nanmax(gaps[:, :-1])),
               mean_gap=float(np.nanmean(gaps)),
               nonzero=int(np.sum(gaps > 0)), positions=int(gaps.size),
               distinct=len({tuple(t) for t in detail["tokens"].tolist()}))
    # the served scores against the reference's own beam search over a
    # seeded share of the sample (the control: the fp8 search's hypotheses)
    tr, device = r.traffic, torch.device(r.device)
    scored = np.sort(data.rng(r.seed, 22).choice(
        len(detail["clips"]), min(SCORE_CLIPS, len(detail["clips"])),
        replace=False))
    signals = pool[detail["clips"][scored]]
    tree = weights.param_tree(r.config, r.seed, device)
    prompt = data.prompt_ids(r.config)
    best, _ = ref_decode.searched(tree, r.config, tr, signals, prompt, device)
    scores = detail["scores"][scored]
    if control:
        _, low = ref_decode.searched(tree, r.config, tr, signals, prompt,
                                     device, precision="fp8")
        scores = ref_decode.token_gaps(tree, r.config, tr, signals, low,
                                       device)[2]
    below = best - scores
    out.update(score_gap=float(np.max(below)),
               score_gap_mean=float(np.mean(below)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first:last+1")
    ap.add_argument("--mode", action="append")
    args = ap.parse_args(argv)
    cell = spec.cell_spec(args.workload)
    lo, hi = (int(x) for x in args.seeds.split(":"))
    reading = train_reading if cell.kind == "train_step" else decode_reading
    program.build_kernels()
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
                if not isinstance(v, (int, float)):
                    continue
                summary.setdefault(mode, {}).setdefault(k, []).append(v)
    for mode, nums in summary.items():
        print(json.dumps({"cell": cell.name, "mode": mode, "summary": {
            k: {"max": max(v), "min": min(v), "n": len(v)}
            for k, v in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
