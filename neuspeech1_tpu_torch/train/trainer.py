"""The training loop of the PyTorch port: the port of
``neuspeech1_tpu/train/trainer.py`` (step scheduling, eval, gated
checkpoints, logging; the reference's HF ``Seq2SeqTrainer`` use,
`finetune.py:269-282`).

The loop calls the train step (``train/trainstep.py``, with the on-device
augmentation of ``augment_config`` and the int8 mode ``int8_matmul``) on
batches from any
iterable of collated batches (host numpy from ``data/loader.py``, or device
tensors from the device caches). Evaluation every ``eval_steps``: the
token-weighted eval loss and, with a tokenizer, greedy decoding with the
unmerged adapters scored by the metric battery (WER, BLEU-1). Checkpoints
every ``save_steps``, gated on the best eval loss, and a final forced one
(``train/checkpoint.py``). AdaLoRA's rank allocation follows PEFT's
``update_and_allocate``. Each record goes to ``metrics.jsonl`` and stdout
with the JAX trainer's keys, order and formatting. The JAX trainer also
writes TensorBoard scalars when tensorflow imports; the port does not (the
card's machine has neither tensorflow nor tensorboard, and
``torch.utils.tensorboard`` would import tensorflow, and with it JAX,
wherever both are installed).

The loop reads the device only where the JAX trainer does: the loss and
gradient norm at logging steps, the eval metrics, and a checkpoint's copy.
The loop's stages are spans of ``train/profiling.py`` (``trainer/batch``,
``trainer/step``, ``trainer/allocate``, ``trainer/log``, the loss's wait,
and ``trainer/eval``), recorded while a profiler records.

Under data parallelism (the ambient mesh's ``data`` axis larger than 1,
``parallel/mesh.py``) each rank's loader yields its rows of every global
batch and the step averages over the data ring. Under FSDP and tensor
parallelism (its ``fsdp`` and ``tensor`` axes, the model split by
``parallel/sharding.py::shard_params``) the rows are split over ``data`` x
``fsdp`` (the loader's process index is the rank's batch coordinate,
``parallel/mesh.py::batch_coordinate``) and shared by the ranks of a
tensor group. The eval loss is token weighted over the ranks holding
different rows, so it equals one process's on the same rows; for the eval
WER each rank decodes its rows on its shards and the predictions are
gathered and put back in the global batches' row order (the loader's
strided per-process rows) before scoring. Logs, ``metrics.jsonl`` and
checkpoints are written by the mesh's first rank alone (checkpoints hold
whole tensors, ``train/checkpoint.py``), and the final save ends at a
barrier of every rank; every rank reads a checkpoint on resume.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from neuspeech1_tpu_torch.models.lora import (
    adalora_apply_pattern, adalora_budget_schedule, adalora_mask_to_budget,
    adalora_matrix_count, adalora_pattern_of, adalora_total_ranks,
    adalora_triplet_scores, has_entries)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.train import trainstep as ts
from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager
from neuspeech1_tpu_torch.train.profiling import span


class Trainer:
    def __init__(
        self,
        config,
        stem,
        tx,
        state: ts.TrainState,
        frozen: ts.Frozen,
        train_loader,
        eval_loader=None,
        output_dir: str = "output",
        max_steps: Optional[int] = None,
        num_epochs: Optional[int] = None,
        eval_steps: int = 1000,
        save_steps: int = 1000,
        logging_steps: int = 100,
        max_to_keep: int = 5,
        augment_config: Optional[dict] = None,
        orth_reg_weight: float = 0.0,
        adalora: Optional[dict] = None,
        fold_lora: bool = False,
        int8_matmul: str = "off",
        generate_eval_tokenizer=None,
        generate_eval_max_new: int = 48,
        generate_eval_language: Optional[str] = "english",
        generate_eval_task: str = "transcribe",
    ):
        self.config = config
        self.stem = stem
        self.tx = tx
        self.state = state
        self.frozen = frozen
        self.device = next(frozen.model.parameters()).device
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.output_dir = output_dir
        self.max_steps = max_steps
        self.num_epochs = num_epochs
        self.eval_steps = eval_steps
        self.save_steps = save_steps
        self.logging_steps = logging_steps
        self.adalora = adalora
        # the rings of the ranks holding other rows of a global batch
        # (data, then fsdp; [] for one process's batch)
        self.row_rings = pmesh.batch_rings()
        self.row_blocks = pmesh.batch_coordinate()[1]
        self.writer = pmesh.is_first()
        os.makedirs(output_dir, exist_ok=True)
        self.ckpt = CheckpointManager(
            os.path.join(output_dir, "checkpoints"),
            max_to_keep=max_to_keep, writer=self.writer,
            specs=sharding.leaf_specs(frozen.model))
        adalora_total = (adalora or {}).get("total_steps", max_steps or 10_000)
        self.train_step = ts.make_train_step(
            config, stem, tx, orth_reg_weight=orth_reg_weight,
            augment_config=augment_config,
            track_adalora_importance=bool(adalora), fold_lora=fold_lora,
            int8_matmul=int8_matmul,
            adalora_ipt_stop_step=(
                adalora_total - (adalora or {}).get("tfinal", 1000)
                if adalora else None))
        self.eval_step = ts.make_eval_step(config, stem)
        self._log_file = (open(os.path.join(output_dir, "metrics.jsonl"),
                               "a", encoding="utf-8") if self.writer
                          else None)
        self._last_eval_loss: Optional[float] = None
        self._eval_batch_size: Optional[int] = None
        self._adalora_pattern = None  # the frozen rank pattern (final phase)
        self._gen_tok = generate_eval_tokenizer
        self._gen_max_new = generate_eval_max_new
        self._gen_lang = generate_eval_language
        self._gen_task = generate_eval_task

    # ------------------------------------------------------------------
    def log(self, record: Dict[str, Any]):
        if not self.writer:
            return
        record = {
            k: (float(v) if isinstance(v, (int, float, np.floating))
                or hasattr(v, "item") else v)
            for k, v in record.items()
        }
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        msg = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
        )
        print(f"[train] {msg}", flush=True)

    # ------------------------------------------------------------------
    def _pad_batch(self, batch):
        """Pad a partial final batch up to the first batch's size (the JAX
        trainer's one static shape; the eval loss and decode see the same
        rows here). Padded label rows are all -100, so they add no tokens.
        Returns (batch, true_rows)."""
        bsz = next(iter(batch.values())).shape[0]
        if self._eval_batch_size is None:
            self._eval_batch_size = bsz
        want = self._eval_batch_size
        if bsz >= want:
            return batch, bsz
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                pad = v[-1:].expand(want - bsz, *v.shape[1:])
                if k == "labels":
                    pad = torch.full_like(pad, -100)
                out[k] = torch.cat([v, pad])
                continue
            v = np.asarray(v)
            pad = np.repeat(v[-1:], want - bsz, axis=0)
            if k == "labels":
                pad = np.full_like(pad, -100)
            out[k] = np.concatenate([v, pad], axis=0)
        return out, bsz

    def evaluate(self) -> float:
        if self.eval_loader is None:
            return float("nan")
        total, n = 0.0, 0
        for batch, _ in _eval_shares(self.eval_loader):
            if batch is None:
                continue  # this rank's share of a short last batch
            batch, _ = self._pad_batch(batch)
            batch = self._prep(batch)
            out = self.eval_step(self.state, self.frozen, batch)
            toks = int(out["n_tokens"])
            total += float(out["loss"]) * toks
            n += toks
        if self.row_rings:
            # on the model's device: an NCCL group refuses a CPU tensor
            sums = torch.tensor([total, float(n)], dtype=torch.float64,
                                device=self.device)
            for ring in self.row_rings:
                sums = ring.all_reduce_sum(sums)
            total, n = sums.tolist()
        if n == 0:
            return float("nan")  # an empty eval set must not look like 0
        return total / n

    def evaluate_generate(self) -> Dict[str, float]:
        """Greedy-decode the eval set with the unmerged adapters and score
        WER / BLEU-1."""
        if self.eval_loader is None or self._gen_tok is None:
            return {}
        from neuspeech1_tpu_torch.decode.generate import (
            GenerationConfig, greedy_decode)
        from neuspeech1_tpu_torch.metrics.battery import compute_battery

        tok = self._gen_tok
        model, lora = self.frozen
        if lora is not None and not has_entries(lora):
            lora = None
        prompt = np.asarray(
            [tok.prefix_tokens(self._gen_lang, self._gen_task)], np.int32)
        gen = GenerationConfig.for_model(
            self.config, max_length=prompt.shape[1] + self._gen_max_new)
        pairs = []  # per batch: (predictions, references) of this rank's rows
        for batch, rows in _eval_shares(self.eval_loader):
            if batch is None:
                pairs.append(([], []))
                continue
            batch, true_rows = self._pad_batch(batch)
            true_rows = min(true_rows, rows)
            labels = batch["labels"]
            labels = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
                      else np.asarray(labels))[:true_rows]
            feats = self._prep({"input_features": batch["input_features"]}
                               )["input_features"].to(model.dtype)
            bp = torch.from_numpy(np.repeat(prompt, feats.shape[0], axis=0)
                                  ).to(self.device)
            out = greedy_decode(model, feats, bp, gen,
                                lora=lora).cpu().numpy()[:true_rows]
            pairs.append((tok.batch_decode(out),
                          [tok.decode(l) for l in labels]))
        # every rank's pairs in the batch coordinate's order (data major):
        # gathered over fsdp, then over data
        per_rank = [pairs]
        for ring in reversed(self.row_rings):
            per_rank = [p for part in ring.gather_objects(per_rank)
                        for p in part]
        if self.row_rings:
            pairs = _interleave(per_rank)
        preds = [p for ps, _ in pairs for p in ps]
        refs = [r for _, rs in pairs for r in rs]
        m = compute_battery(preds, refs, include_cer=False)
        return {"eval_wer": m["wer"], "eval_bleu1": m["bleu-1"]}

    def _prep(self, batch):
        """A batch on the model's device without the ``_``-keys; token ids
        as int64 (host arrays pinned, copies asynchronous)."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                continue
            t = torch.as_tensor(v)
            if k != "input_features":
                t = t.long()
            if t.device != self.device:
                if self.device.type == "cuda":
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------------
    def train(self, resume_from_checkpoint=False):
        """``resume_from_checkpoint``: False/None = fresh, True = the latest
        saved step, an int (or digit string) = that step. An identity test,
        not truthiness, so that step 0 resumes."""
        if resume_from_checkpoint is not False and \
                resume_from_checkpoint is not None:
            step = None
            if not isinstance(resume_from_checkpoint, bool):
                step = int(resume_from_checkpoint)
            if self.ckpt.restore_latest(self.state, step=step) is not None:
                print(f"[train] resumed from step {self.state.step}",
                      flush=True)

        step_num = int(self.state.step)
        t_last = time.perf_counter()
        samples_since = 0
        epoch = 0
        done = False
        while not done:
            if self.num_epochs is not None and epoch >= self.num_epochs:
                break
            batches = iter(self.train_loader)
            while True:
                with span("trainer/batch"):
                    batch = next(batches, _END)
                    if batch is not _END:
                        bsz = _rows(batch) * self.row_blocks
                        batch = self._prep(batch)
                if batch is _END:
                    break
                with span("trainer/step"):
                    metrics = self.train_step(self.state, self.frozen, batch)
                step_num += 1
                samples_since += bsz

                if self.adalora:
                    with span("trainer/allocate"):
                        self._adalora_update(step_num)

                if step_num % self.logging_steps == 0:
                    # the loss first: its copy to the host waits for every
                    # queued step, so the clock measures work done
                    with span("trainer/log"):
                        loss_val = float(metrics["loss"])
                        grad_val = float(metrics["grad_norm"])
                    dt = time.perf_counter() - t_last
                    self.log({
                        "step": step_num,
                        "loss": loss_val,
                        "grad_norm": grad_val,
                        "samples_per_sec": samples_since / max(dt, 1e-9),
                        "epoch": epoch,
                    })
                    t_last = time.perf_counter()
                    samples_since = 0

                if self.eval_loader is not None and \
                        step_num % self.eval_steps == 0:
                    with span("trainer/eval"):
                        self._last_eval_loss = self.evaluate()
                        rec = {"step": step_num,
                               "eval_loss": self._last_eval_loss}
                        rec.update(self.evaluate_generate())
                    self.log(rec)

                # saving is independent of the eval schedule; gating reads
                # the latest eval loss
                if step_num % self.save_steps == 0:
                    if self.eval_loader is not None:
                        if self._last_eval_loss is None:
                            # no eval has run this session: measure one, so
                            # that gating has a number
                            self._last_eval_loss = self.evaluate()
                        if self.ckpt.save(self.state,
                                          eval_loss=self._last_eval_loss):
                            self.log({"step": step_num, "saved": 1,
                                      "best_eval": self.ckpt.best_eval})
                    else:
                        self.ckpt.save(self.state, force=True)

                if self.max_steps is not None and step_num >= self.max_steps:
                    done = True
                    break
            epoch += 1

        # the final save (reference `finetune.py:282` checkpoint-final)
        self.ckpt.save(self.state, force=True)
        self.ckpt.wait()
        pmesh.barrier()
        return self.state

    # ------------------------------------------------------------------
    def _adalora_update(self, step_num: int):
        """PEFT ``update_and_allocate``: ``budget_schedule`` decides when to
        mask; masking zeroes E below the global importance threshold. At
        the boundary step total - tfinal the mask is forced and its pattern
        frozen; after it the pattern is re-applied every step (pruned E
        entries keep their gradients). The budget comes from the host's
        step count; scores, threshold and masks stay on the device."""
        lora = self.frozen.lora
        if not lora or not self.state.ipt:
            return
        cfg = self.adalora
        init_bgt = adalora_total_ranks(lora)
        n_matrices = max(adalora_matrix_count(lora), 1)
        total = cfg.get("total_steps", self.max_steps or 10_000)
        tfinal = cfg.get("tfinal", 1000)
        budget, mask_ind = adalora_budget_schedule(
            step_num, init_bgt, cfg.get("target_r", 4) * n_matrices,
            cfg.get("tinit", 200), tfinal, total, cfg.get("deltaT", 10))
        if step_num > total - tfinal and self._adalora_pattern is not None:
            adalora_apply_pattern(lora, self._adalora_pattern)
        elif mask_ind or step_num == total - tfinal:
            adalora_mask_to_budget(lora, adalora_triplet_scores(
                self.state.ipt), budget, init_bgt)
            if step_num >= total - tfinal:
                self._adalora_pattern = adalora_pattern_of(lora)


# the end of the train loader's batches in an epoch
_END = object()


def _eval_shares(loader):
    """The eval loader's batches of this rank, each with its true row
    count; None for an empty share of a short last batch. Under a mesh
    ``fsdp`` axis its ranks gather every weight together, so a rank with
    an empty share takes its previous batch again with every label masked
    (0 rows, no tokens) instead, to run the forward beside its peers."""
    last = None
    fsdp = pmesh.fsdp_ring() is not None
    for batch in loader:
        if _rows(batch) > 0:
            last = batch
            yield batch, _rows(batch)
        elif fsdp and last is not None:
            labels = last["labels"]
            masked = (torch.full_like(labels, -100)
                      if isinstance(labels, torch.Tensor)
                      else np.full_like(np.asarray(labels), -100))
            yield {**last, "labels": masked}, 0
        else:
            yield None, 0


def _rows(batch) -> int:
    return next(iter(batch.values())).shape[0]


def _interleave(per_rank: list) -> list:
    """Per batch, the ranks' (predictions, references) put back in the
    global batch's row order: rank r holds rows r, r + n, r + 2n, ... (the
    loader's per-process stride)."""
    n = len(per_rank)
    out = []
    for parts in zip(*per_rank):
        total = sum(len(p) for p, _ in parts)
        out.append(tuple([parts[j % n][k][j // n] for j in range(total)]
                         for k in (0, 1)))
    return out
