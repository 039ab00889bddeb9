"""Checkpoints with best-eval gating and resume: the port of
``neuspeech1_tpu/train/checkpoint.py`` in the port's own format (the JAX
package writes orbax).

One directory per step, ``<directory>/<step>/state.pt``: a ``torch.save`` of
the step count, the trainable tensors by path, the optimizer state (AdamW's
count and moments, and the accumulation's micro-step and running mean) and
the state of the state's ``torch.Generator`` (a CPU byte tensor, also for
a generator on the card: its seed and offset), all on the CPU, so that a
resume continues the step's augmentation and dropout draws exactly. As in
the JAX package:
  * ``max_to_keep`` newest steps are kept (`finetune.py:244-246`);
  * saving is gated on the latest eval loss being the best so far
    (`utils/callback.py:12-32`), recorded in ``gating.json``; ``force`` saves
    regardless; a step already saved counts as saved;
  * the frozen weights are not saved, and neither are AdaLoRA's importance
    EMAs (PEFT keeps its allocator state in memory only);
  * resume copies the saved values into the state's own tensors, so the
    model, the adapter tree and the optimizer keep referring to them, and
    it is exact: the same bits as before the save.

Under data parallelism every rank keeps a manager and takes the same
gating decisions (the eval loss is the same on every rank), but only the
``writer`` (the mesh's first rank) writes; every rank reads on resume.
Under FSDP and tensor parallelism (``specs``: the split leaves, by path,
``parallel/sharding.py::leaf_specs``) a save gathers each split leaf and
its moments whole on every rank, so that the file holds a one-rank run's
shapes, and a resume takes this rank's block of each: a checkpoint
resumes on any mesh. Every rank decides alike whether a step is saved
already, from the steps on disk when its manager opened and those saved
since, because every rank takes part in the gathers.

The copy to the host happens in ``save`` and the file is written by a
thread; ``wait`` joins it and re-raises the writer's error. A step's directory appears under its
final name only once its file is complete.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional

import torch

from neuspeech1_tpu_torch.parallel import sharding


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 writer: bool = True, specs: Optional[dict] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.writer = writer
        self.specs = specs or {}
        # steps saved as every rank knows them (see the module docstring)
        self._known = set(self.all_steps())
        self.best_eval = float("inf")
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._meta_path = os.path.join(self.directory, "gating.json")
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    self.best_eval = json.load(f)["best_eval"]
            except (OSError, ValueError, KeyError):
                pass

    def all_steps(self) -> List[int]:
        """The steps written to disk, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def save(self, state, eval_loss: Optional[float] = None,
             force: bool = False) -> bool:
        """Save if gating allows. Returns True when a save happened (on a
        rank that does not write: would have happened) or the step is
        already saved."""
        if eval_loss is not None and eval_loss < self.best_eval:
            self.best_eval = eval_loss
            if self.writer:
                with open(self._meta_path, "w") as f:
                    json.dump({"best_eval": self.best_eval}, f)
        if not force:
            if eval_loss is None or eval_loss > self.best_eval:
                return False
        step = int(state.step)
        if step in self._known:
            return True  # already saved at this step (final after gated)
        self._known.add(step)
        if not (self.writer or self.specs):
            return True
        payload = _payload(state, self.specs)  # every rank gathers splits
        if not self.writer:
            return True
        self.wait()
        final = os.path.join(self.directory, str(step))
        os.makedirs(final + ".tmp", exist_ok=True)
        self._writer = threading.Thread(
            target=self._write, args=(payload, final), daemon=True)
        self._writer.start()
        return True

    def _write(self, payload, final: str) -> None:
        try:
            torch.save(payload, os.path.join(final + ".tmp", "state.pt"))
            os.replace(final + ".tmp", final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def restore_latest(self, state, step: Optional[int] = None):
        """Restore into ``state`` in place and return it, or None when no
        checkpoint exists. ``step`` targets a specific saved step and raises
        FileNotFoundError, naming the saved steps, when there is none."""
        self.wait()
        steps = self.all_steps()
        if step is None:
            if not steps:
                return None
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(
                f"no checkpoint at step {step}; saved steps: {steps}")
        saved = torch.load(os.path.join(self.directory, str(step),
                                        "state.pt"),
                           map_location="cpu", weights_only=True)
        if set(saved["trainable"]) != set(state.trainable):
            raise KeyError("checkpoint leaves differ from the state's: "
                           f"{sorted(set(saved['trainable']) ^ set(state.trainable))}")
        opt = state.opt_state

        def block(k, t):
            return sharding.shard_leaf(t, self.specs[k]) if k in self.specs \
                else t

        with torch.no_grad():
            for k, t in state.trainable.items():
                t.copy_(block(k, saved["trainable"][k]))
            for name in ("mu", "nu", "acc"):
                dst = getattr(opt, name)
                for k, t in (saved["opt_state"][name] or {}).items():
                    dst[k].copy_(block(k, t))
        opt.count = saved["opt_state"]["count"]
        opt.mini_step = saved["opt_state"]["mini_step"]
        state.generator.set_state(saved["generator"])
        state.step = saved["step"]
        return state

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk; re-raise its
        error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def _host(tensors, specs: Optional[dict] = None):
    """``tensors`` on the host, each split one (``specs``) gathered whole."""
    if tensors is None:
        return None
    specs = specs or {}
    return {k: (sharding.gather_leaf(t.detach(), specs[k]) if k in specs
                else t.detach()).to("cpu", copy=True)
            for k, t in tensors.items()}


def _payload(state, specs: Optional[dict] = None) -> dict:
    opt = state.opt_state
    return {
        "step": int(state.step),
        "trainable": _host(state.trainable, specs),
        "opt_state": {"count": opt.count, "mini_step": opt.mini_step,
                      "mu": _host(opt.mu, specs), "nu": _host(opt.nu, specs),
                      "acc": _host(opt.acc, specs)},
        "generator": state.generator.get_state(),
    }
