"""Traffic kind ``train_step``: the fine-tune recipe's training step, fed
from a seeded pool of clips on the card.

Set-up builds the step as the fine-tune CLI does (``cli/finetune.py``: f32
masters, AdaLoRA adapters with the orthogonality loss, the 'fc' fold, clip
and AdamW on the warmup schedule, importance tracking), with weights and
adapters drawn from the seed, and a ``DeviceCache`` over the pool, drawn
in seeded epochs without replacement. It runs the first ``checked_steps``
steps on that same object (the rows of each differ) and keeps what the
check reads: each step's loss, the first gradient per leaf as AdamW holds
it after one step (its first moment over 1 - beta1), and each leaf's
change over the steps. The window then runs the same step, waiting for
each, until ``--seconds`` have passed. Once it has closed and the program
is freed, the reference replays the checked steps (``reference/train.py``).

The checked steps are the process's first, at the schedule's first
learning rates; the window's own steps are held only to finite losses. So
a program whose path depends on the step count (a graph captured after
warm steps, a tuning pass, a switch past some count) has to take in the
checked steps the path the window then times: a path that only later
steps take is timed and never compared.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import data, program, trace, weights
from benchmark.lib.harness import (Outcome, Run, free, mean_leaf,
                                   process_seconds, worst_leaf)
from benchmark.reference import train as ref_train

# leaves whose reference gradient is under this share of the median leaf's
# are nought to rounding: AdamW moves them by round-off alone
MOVED_SHARE = 1e-3


def build(r: Run, **step_options):
    """(step, state, frozen, feed): the program's step and state, and an
    iterator of (pool indices, batch) over seeded epochs. ``step_options``
    reach ``make_train_step`` (the control's ``int8_matmul``)."""
    import torch
    from neuspeech1_tpu_torch.data.device_cache import DeviceCache
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.train import optimizer, trainstep

    cfg, tr = r.config, r.traffic
    device = torch.device(r.device)
    config, stem = program.whisper_config(cfg)
    model = module_from_params(weights.param_tree(cfg, r.seed, device),
                               config, stem, device=device,
                               dtype=getattr(torch, cfg["param_dtype"]))
    lora = weights.adapter_tree(cfg, r.seed, device)
    o, a = tr["optimizer"], cfg["adapters"]
    tx = optimizer.make_optimizer(
        peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
        total_steps=o["total_steps"], weight_decay=o["weight_decay"],
        b1=o["b1"], b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"])
    state, frozen = trainstep.init_train_state(
        model, lora, tx, optimizer.default_trainable_pred(ft_full=False),
        seed=r.seed % (2 ** 62) + 3)
    step = trainstep.make_train_step(
        config, stem, tx, orth_reg_weight=a["orth_reg_weight"],
        track_adalora_importance=True, fold_lora=a["fold"] == "fc",
        adalora_ipt_stop_step=o["total_steps"] - a["tfinal"],
        **step_options)
    cache = DeviceCache(*data.train_pool(cfg, tr, r.seed, device))

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


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    """Each tensor's norm, read with one copy to the host."""
    import torch

    keys = list(tensors)
    values = torch.stack([tensors[k].detach().float().norm()
                          for k in keys]).cpu().numpy()
    return {k: float(v) * scale for k, v in zip(keys, values)}


class _Done:
    """A completion marker on the CPU, where every op has finished."""

    def synchronize(self):
        pass


def _marker(r: Run):
    """An event recorded after the work enqueued so far."""
    if r.device == "cpu":
        return _Done()
    import torch

    event = torch.cuda.Event()
    event.record()
    return event


def checked_steps(r: Run, step, state, frozen, feed) -> dict:
    """The first steps, through the window's own call and feed on the same
    object: the rows they read, each step's loss, the first gradient per
    leaf as AdamW holds it after one step, each leaf's change over them."""
    b1 = r.traffic["optimizer"]["b1"]
    start = {k: v.detach().clone() for k, v in state.trainable.items()}
    rows, losses, grad = [], [], {}
    for s in range(r.traffic["checked_steps"]):
        idx, batch = next(feed)
        rows.append(idx.cpu())
        losses.append(step(state, frozen, batch)["loss"])
        if s == 0:
            grad = _norms(state.opt_state.mu, 1.0 / (1.0 - b1))
    return {"rows": rows, "losses": [float(x) for x in losses],
            "grad": grad,
            "change": _norms({k: v - start[k]
                              for k, v in state.trainable.items()})}


def numbers(r: Run, checked: dict, detail: dict = None) -> dict:
    """The numbers that decide ``correct``, once the program is freed:
    the reference replays the checked steps. ``detail``, where given,
    takes each leaf's gaps."""
    import torch

    ref = ref_train.replay(r.config, r.traffic, r.seed, checked["rows"],
                           torch.device(r.device))
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
    }


def run(r: Run) -> Outcome:
    import torch

    tr = r.traffic
    if r.device != "cpu":
        program.build_kernels()
    step, state, frozen, feed = build(r)
    checked = checked_steps(r, step, state, frozen, feed)
    r.sync()
    if r.device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    # the window: each step is enqueued before the host waits for the one
    # before it, as the fine-tune CLI's loop leaves the card a step ahead
    slice_ = trace.Slice(r.trace, tr["trace_after_steps"], tr["trace_steps"])
    setup_s = process_seconds()
    window_losses, ends = [], []
    pending = None
    t0 = time.perf_counter()
    try:
        while True:
            _, batch = next(feed)
            with trace.span("step"):
                window_losses.append(step(state, frozen, batch)["loss"])
            done = _marker(r)
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
                   steps=len(ends),
                   steps_outside=len(outside),
                   seconds_outside=float(durations[outside].sum()))
    del step, state, frozen, feed, batch, window_losses
    free()
    return Outcome(
        metrics={"train_samples_per_s": len(ends) * tr["batch"] / window_s,
                 "setup_s": setup_s},
        attempted=len(ends), failed=int((~finite).sum()),
        numbers=numbers(r, checked),
        memory_peak_bytes=int(peak))
