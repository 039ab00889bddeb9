"""The port's fine-tune CLI under data parallelism (``--mesh_data=2``, two
gloo processes on the CPU as torchrun or ``--coordinator`` starts them;
tests/torch_spawn.py) against one process and against the JAX CLI at
``--mesh_data=2`` on the 8-device CPU mesh, in f32, full fine-tuning of the
eval CLI tests' model (no adapter draws, so all three runs start from the
same weights), the threaded loader's batch order in all three: per-step
losses and the eval loss within rtol 1e-4 / atol 2e-4; one metrics.jsonl
and one adapter_final.npz, written by rank 0 alone, with the one-process
run's records; a resume from the last checkpoint on both ranks; the eval
WER with the validation row on rank 0 and none on rank 1."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli.finetune import main as jax_finetune
from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from neuspeech1_tpu_torch.train.trainer import Trainer, _interleave
from tests.test_torch_eval_cli import make_eval_setup
from tests.test_torch_finetune_cli import _log, _train_argv
from tests.torch_spawn import finetune_rank, free_port

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
WORLD = 2
# full fine-tuning from the same npz, every step logged, the loader's order
FLAGS = ("--ft_full=True", "--device_cache=off", "--native_loader=off",
         "--per_device_train_batch_size=4", "--logging_steps=1",
         "--export_full_model=False", "--num_workers=1")


def _argv(s, out, *extra, val="all"):
    """The fine-tune CLI test's argv with FLAGS; ``val``: the manifest
    validated on, 'all' (8 rows, two batches of 4, as the JAX CLI's data
    mesh needs) or 'val' (1 row: rank 1's share is empty)."""
    argv = [a for a in _train_argv(s, out, *FLAGS, *extra)
            if not a.startswith("--mesh_data=1")]
    return [f"--val_data={s['corpus']}/{val}.jsonl"
            if a.startswith("--val_data=") else a for a in argv] + [
        "--per_device_eval_batch_size=4"]


def _spawn(argv, coordinator=False):
    torch.multiprocessing.spawn(
        finetune_rank, args=(WORLD, free_port(), argv, coordinator),
        nprocs=WORLD)


def _losses(run_dir, key="loss"):
    return {r["step"]: r[key] for r in _log(run_dir) if key in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    s = make_eval_setup(str(tmp_path_factory.mktemp("finetune_dp")))
    out = {k: os.path.join(s["root"], k) for k in ("one", "two", "jax")}
    port_finetune(_argv(s, out["one"], "--device=cpu"))
    _spawn(_argv(s, out["two"], "--device=cpu", "--mesh_data=2"))
    jax_finetune(_argv(s, out["jax"], "--mesh_data=2"))
    return s, out


def _close(got, ref):
    assert sorted(got) == sorted(ref) and got
    for step in ref:
        np.testing.assert_allclose(got[step], ref[step], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")


@pytest.mark.parametrize("ref", ["one", "jax"])
@pytest.mark.parametrize("key", ["loss", "eval_loss"])
def test_two_processes_match(runs, ref, key):
    _, out = runs
    _close(_losses(out["two"], key), _losses(out[ref], key))


def test_files_written_once_by_rank_zero(runs):
    """The same records as one process, once each; the same output files;
    one adapter, within the loss bound of the one-process adapter."""
    _, out = runs
    two, one = _log(out["two"]), _log(out["one"])
    assert [tuple(r) for r in two] == [tuple(r) for r in one]
    assert [r["step"] for r in two] == [r["step"] for r in one]
    assert sorted(os.listdir(out["two"])) == sorted(os.listdir(out["one"]))
    assert sorted(os.listdir(os.path.join(out["two"], "checkpoints"))) == \
        sorted(os.listdir(os.path.join(out["one"], "checkpoints")))
    a = np.load(os.path.join(out["two"], "adapter_final.npz"))
    b = np.load(os.path.join(out["one"], "adapter_final.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    wer = {k: [r["eval_wer"] for r in _log(out[k]) if "eval_wer" in r]
           for k in ("one", "two")}
    assert wer["two"] == wer["one"] and wer["one"]


def test_resume_on_both_ranks(runs, tmp_path):
    """Two more steps after --resume_from_checkpoint=latest, with the
    --coordinator rendezvous: every rank reads step 6's checkpoint, and
    the losses match one process resumed from its own. The validation set
    is one row, so rank 1 holds none of it: the eval loss and WER are
    rank 0's row alone, as in one process."""
    s, out = runs
    dirs = {}
    for k in ("one", "two"):
        dirs[k] = str(tmp_path / k)
        shutil.copytree(out[k], dirs[k])
    extra = ("--max_steps=8", "--resume_from_checkpoint=latest",
             "--eval_steps=1")
    port_finetune(_argv(s, dirs["one"], "--device=cpu", *extra, val="val"))
    _spawn(_argv(s, dirs["two"], "--device=cpu", "--mesh_data=2", *extra,
                 val="val"), coordinator=True)
    for key in ("loss", "eval_loss", "eval_wer"):
        got, ref = _losses(dirs["two"], key), _losses(dirs["one"], key)
        if key == "loss":
            assert sorted(got) == list(range(1, 9))
        _close({k: v for k, v in got.items() if k > 6},
               {k: v for k, v in ref.items() if k > 6})


def test_mesh_larger_than_the_world_raises(runs, tmp_path):
    s, _ = runs
    with pytest.raises(ValueError, match="ranks"):
        port_finetune(_argv(s, str(tmp_path / "o"), "--device=cpu",
                            "--mesh_data=2"))


def test_interleave_restores_the_strided_row_order():
    """Rank r holds rows r, r + n, ...: a batch of five over two ranks
    (rows 0, 2, 4 and 1, 3), and one of one row (rank 1 holds none)."""
    per_rank = [[(["a0", "a2", "a4"], [0, 2, 4]), (["b0"], [5])],
                [(["a1", "a3"], [1, 3]), ([], [])]]
    assert _interleave(per_rank) == [
        (["a0", "a1", "a2", "a3", "a4"], [0, 1, 2, 3, 4]), (["b0"], [5])]


class _DeviceCheckingRing:
    """A data ring of two ranks that holds every tensor it reduces to one
    device, as an NCCL group does, and answers for both ranks."""

    rank, size = 0, 2

    def __init__(self, device):
        self.device = device

    def all_reduce_sum(self, x):
        assert x.device == self.device, (x.device, self.device)
        return torch.tensor([2 * 6.0, 2 * 3.0], dtype=torch.float64)


def test_eval_reduction_runs_on_the_model_device():
    """The eval loss's token-weighted sum crosses the data ring on the
    model's device (a 'meta' device stands for the card here), and the
    global mean comes back to the host."""
    device = torch.device("meta")
    batch = {"labels": np.zeros((2, 4), np.int32)}
    trainer = SimpleNamespace(
        eval_loader=[batch], state=None, frozen=None, device=device,
        row_rings=[_DeviceCheckingRing(device)],
        _pad_batch=lambda b: (b, _rows_of(b)), _prep=lambda b: b,
        eval_step=lambda state, frozen, b: {"loss": torch.tensor(2.0),
                                            "n_tokens": torch.tensor(3)})
    assert Trainer.evaluate(trainer) == 2.0


def _rows_of(batch):
    return next(iter(batch.values())).shape[0]
