"""Traffic kind ``llm_train_step``: the training step of the EEG tower
before a frozen language model (``models/meg_lm.py``), fed from a seeded
pool of clips and labels on the card.

Set-up builds the step as ``kinds/train_step.py`` builds the Whisper
recipe's (``train/trainstep.py``'s ``make_train_step`` and
``init_train_state``: f32 masters of the stem, the encoder's AdaLoRA and
the projector; the 'fc' fold; clip and AdamW on the warmup schedule;
importance tracking), on a ``MegLMConfig`` built from the configuration
file, with the language model drawn in its dtype and held frozen
(``lib/llm_inputs.py``), and a ``DeviceCache`` over the pool, drawn in
seeded epochs without replacement. It runs the first ``checked_steps``
steps on that same object and keeps what the check reads (as
``kinds/train_step.py::checked_steps``) and each routed layer's expert
choices (``models/moe_lm.py::recording_routes``). The window then runs the
same step, a step queued ahead of each wait, until ``--seconds`` have
passed. Once it has closed and the program is freed, the reference
replays the checked steps along the program's expert choices
(``reference/meg_llm.py``): the four numbers of a Whisper training cell
``route_gap``, how far a chosen expert's biased score lies below the
reference's k-th best at most, and ``route_miss_share``, the share of
(token, routed layer) pairs whose choices are not the reference's own
top k.

``run.stats["counters"]`` holds the change of the program's counters
(``train/profiling.py``: ``moe.rows``, ``moe.max_expert_rows``,
``moe.empty_experts``, ...) over the window, which count only while the
traced slice records.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.kinds import train_step
from benchmark.lib import (data, llm_inputs, moe_counts, program, trace,
                           weights)
from benchmark.lib.harness import (Outcome, Run, free, mean_leaf,
                                   process_seconds, worst_leaf)
from benchmark.reference import meg_llm

MOVED_SHARE = train_step.MOVED_SHARE


def meg_lm_config(c: dict):
    """The program's ``MegLMConfig`` for a configuration file."""
    import dataclasses

    from neuspeech1_tpu_torch.config import (MegLMConfig, MoELMConfig,
                                             StemConfig, WhisperConfig)

    t = llm_inputs.tower(c)
    lm_keys = {f.name for f in dataclasses.fields(MoELMConfig)} - {"dtype"}
    return MegLMConfig(
        tower=WhisperConfig(**t["model"], dtype=t["dtype"],
                            param_dtype=t["param_dtype"], remat=t["remat"],
                            remat_policy=t["remat_policy"]),
        stem=StemConfig(**t["stem"]),
        lm=MoELMConfig(**{k: v for k, v in c.items() if k in lm_keys},
                       dtype=c["lm_dtype"]),
        merge_frames=c["projector"]["merge_frames"],
        start_id=c["start_id"], pad_id=c["pad_id"])


def build(r: Run):
    """(step, state, frozen, feed) as ``kinds/train_step.py::build`` gives
    them, for the tower and language model of the configuration."""
    import torch
    from neuspeech1_tpu_torch.data.device_cache import DeviceCache
    from neuspeech1_tpu_torch.models import meg_lm
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    cfg, tr = r.config, r.traffic
    device = torch.device(r.device)
    config = meg_lm_config(cfg)
    tcfg = llm_inputs.tower(cfg)
    model = meg_lm.module_from_weights(
        weights.param_tree(tcfg, r.seed, device)["encoder"],
        llm_inputs.projector_tree(cfg, r.seed, device),
        llm_inputs.lm_state(cfg, r.seed, device,
                            getattr(torch, cfg["lm_dtype"])),
        config, device=device, dtype=getattr(torch, tcfg["param_dtype"]))
    lora = weights.adapter_tree(tcfg, r.seed, device)
    o, a = tr["optimizer"], tcfg["adapters"]
    tx = optimizer.make_optimizer(
        peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
        total_steps=o["total_steps"], weight_decay=o["weight_decay"],
        b1=o["b1"], b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"])
    state, frozen = trainstep.init_train_state(
        model, lora, tx, meg_lm.trainable_pred(),
        seed=r.seed % (2 ** 62) + 3)
    step = trainstep.make_train_step(
        config, config.stem, tx, orth_reg_weight=a["orth_reg_weight"],
        track_adalora_importance=True, fold_lora=a["fold"] == "fc",
        adalora_ipt_stop_step=o["total_steps"] - a["tfinal"])
    feats, labels, inputs = llm_inputs.pool(cfg, tr, r.seed, device)
    cache = DeviceCache(feats, labels, inputs)

    def feed():
        epoch = 0
        while True:
            order = data.train_order(tr, r.seed, epoch, device)
            for i in range(cache.n // tr["batch"]):
                idx = order[i * tr["batch"]:(i + 1) * tr["batch"]]
                batch = cache.gather(idx)
                del batch["_indices"]
                yield idx, batch
            epoch += 1

    return step, state, frozen, feed()


def checked_steps(r: Run, step, state, frozen, feed) -> dict:
    """``kinds/train_step.py::checked_steps``, and ``routes``: per step,
    each routed layer's expert choices in its forward, on the host."""
    from neuspeech1_tpu_torch.models import moe_lm

    n = moe_counts.routed_layers(r.config)
    routes = []

    def recorded(state, frozen, batch):
        with moe_lm.recording_routes() as seen:
            out = step(state, frozen, batch)
        routes.append([t.cpu() for t in seen[:n]])
        return out

    checked = train_step.checked_steps(r, recorded, state, frozen, feed)
    checked["routes"] = routes
    return checked


def numbers(r: Run, checked: dict, detail: dict = None) -> dict:
    """The numbers that decide ``correct``, once the program is freed: the
    reference replays the checked steps along ``checked``'s expert
    choices. ``detail``, where given, takes each leaf's gaps."""
    import torch

    ref = meg_llm.replay(r.config, r.traffic, r.seed, checked["rows"],
                         torch.device(r.device), routes=checked["routes"])
    raw = sorted(ref["grad_raw"].values())
    floor = MOVED_SHARE * raw[len(raw) // 2]
    moved = [k for k, v in ref["grad_raw"].items() if v >= floor]
    if detail is not None:
        for name in ("grad", "change"):
            norms = sorted(ref[name][k] for k in moved)
            med = norms[len(norms) // 2]
            detail[name] = {k: (checked[name].get(k, 0.0) - ref[name][k])
                            / max(ref[name][k], med) for k in moved}
        detail["losses"] = (checked["losses"], ref["losses"])
        detail["left_out"] = sorted(set(ref["grad_raw"]) - set(moved))
    return {
        "loss_gap": max(abs(p - q) / abs(q) for p, q in
                        zip(checked["losses"], ref["losses"])),
        "grad_gap": worst_leaf(checked["grad"], ref["grad"], moved),
        "change_gap": worst_leaf(checked["change"], ref["change"], moved),
        "change_mean_gap": mean_leaf(checked["change"], ref["change"],
                                     moved),
        "route_gap": ref["route_gap"],
        "route_miss_share": ref["route_miss_share"],
    }


def run(r: Run) -> Outcome:
    import torch
    # the program's language-model modules first: a checkout without them
    # fails here, before any kernel build or draw
    from neuspeech1_tpu_torch.models import meg_lm  # noqa: F401
    from neuspeech1_tpu_torch.ops import moe_gemm
    from neuspeech1_tpu_torch.train import profiling

    tr = r.traffic
    if r.device != "cpu":
        program.build_kernels()
        moe_gemm._library()
    step, state, frozen, feed = build(r)
    checked = checked_steps(r, step, state, frozen, feed)
    r.sync()
    if r.device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    slice_ = trace.Slice(r.trace, tr["trace_after_steps"], tr["trace_steps"])
    setup_s = process_seconds()
    before = profiling.counters()
    window_losses, ends = [], []
    pending = None
    t0 = time.perf_counter()
    try:
        while True:
            _, batch = next(feed)
            with trace.span("step"):
                window_losses.append(step(state, frozen, batch)["loss"])
            done = train_step._marker(r)
            if pending is not None:
                pending.synchronize()
                ends.append(time.perf_counter())
                slice_.tick(len(ends) - 1)
            pending = done
            if ends and ends[-1] - t0 >= r.seconds:
                break
        pending.synchronize()
        ends.append(time.perf_counter())
        window_s = ends[-1] - t0
        r.profile = slice_.read()
    finally:
        slice_.close()
    finite = torch.isfinite(torch.stack(window_losses).float()).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() if r.device != "cpu" else 0

    durations = np.diff([t0] + ends)
    touched = slice_.touched()
    outside = [i for i in range(len(ends)) if i not in touched]
    r.stats.update(batch=tr["batch"], label_len=tr["label_len"],
                   steps=len(ends), steps_outside=len(outside),
                   seconds_outside=float(durations[outside].sum()),
                   counters=profiling.counter_changes(before))
    del step, state, frozen, feed, batch, window_losses
    free()
    return Outcome(
        metrics={"train_samples_per_s": len(ends) * tr["batch"] / window_s,
                 "setup_s": setup_s},
        attempted=len(ends), failed=int((~finite).sum()),
        numbers=numbers(r, checked),
        memory_peak_bytes=int(peak))
