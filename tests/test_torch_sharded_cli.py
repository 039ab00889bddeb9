"""The port's fine-tune CLI (neuspeech1_tpu_torch/cli/finetune.py) under
FSDP and tensor parallelism, as gloo processes on the CPU started as
torchrun starts them (tests/torch_spawn.py), against one process on the
same argv, in f32, full fine-tuning of the eval CLI tests' model:

- two processes at --mesh_tensor=2: per-step and eval losses within rtol
  1e-4 / atol 2e-4, one metrics.jsonl, checkpoints and adapter of whole
  tensors;
- four processes at --mesh_fsdp=2 --mesh_tensor=2: two steps, a
  checkpoint, a resume to a third, every loss within the same bound."""

import os

import numpy as np
import pytest
import torch

from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from tests.test_torch_eval_cli import make_eval_setup
from tests.test_torch_finetune_cli import _log
from tests.test_torch_finetune_dp import _argv, _close, _losses
from tests.torch_spawn import finetune_rank, free_port

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    s = make_eval_setup(str(tmp_path_factory.mktemp("finetune_tp")))
    out = {k: os.path.join(s["root"], k) for k in ("one", "two")}
    port_finetune(_argv(s, out["one"], "--device=cpu"))
    torch.multiprocessing.spawn(
        finetune_rank, args=(2, free_port(), _argv(
            s, out["two"], "--device=cpu", "--mesh_data=1",
            "--mesh_tensor=2"), False), nprocs=2)
    return out


@pytest.mark.parametrize("key", ["loss", "eval_loss"])
def test_cli_under_tensor_parallelism_matches_one_process(cli_runs, key):
    _close(_losses(cli_runs["two"], key), _losses(cli_runs["one"], key))


def test_cli_writes_whole_tensors_once(cli_runs):
    """One writer: the one-process run's records; the checkpoint and the
    adapter (every leaf under --ft_full) hold whole tensors within the
    loss bound of one process's."""
    two, one = _log(cli_runs["two"]), _log(cli_runs["one"])
    assert [r["step"] for r in two] == [r["step"] for r in one]
    a = np.load(os.path.join(cli_runs["two"], "adapter_final.npz"))
    b = np.load(os.path.join(cli_runs["one"], "adapter_final.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    steps = sorted(os.listdir(os.path.join(cli_runs["one"], "checkpoints")))
    assert sorted(os.listdir(os.path.join(cli_runs["two"], "checkpoints"))
                  ) == steps
    last = [d for d in steps if d.isdigit()][-1]
    ck = {k: torch.load(os.path.join(cli_runs[k], "checkpoints", last,
                                     "state.pt"), weights_only=True)
          for k in ("one", "two")}
    for k, t in ck["one"]["trainable"].items():
        assert ck["two"]["trainable"][k].shape == t.shape, k
        assert ck["two"]["opt_state"]["nu"][k].shape == t.shape, k


def test_cli_on_fsdp_by_tensor_resumes_as_one_process(tmp_path):
    """The fine-tune CLI in four gloo processes at --mesh_fsdp=2
    --mesh_tensor=2 (--ft_full, every leaf split or replicated): two steps
    with a checkpoint of whole tensors at the second, then a resume to a
    third, every loss within rtol 1e-4 / atol 2e-4 of one process doing
    the same."""
    s = make_eval_setup(str(tmp_path / "setup"))
    runs = {k: str(tmp_path / k) for k in ("one", "four")}
    mesh = ("--mesh_data=1", "--mesh_fsdp=2", "--mesh_tensor=2")
    for extra in (("--max_steps=2",),
                  ("--max_steps=3", "--resume_from_checkpoint=latest")):
        argv = ("--device=cpu", "--save_steps=2", "--eval_steps=100",
                *extra)
        port_finetune(_argv(s, runs["one"], *argv))
        torch.multiprocessing.spawn(finetune_rank, args=(
            4, free_port(), _argv(s, runs["four"], *argv, *mesh), False),
            nprocs=4)
    got, ref = _losses(runs["four"]), _losses(runs["one"])
    assert sorted(ref) == [1, 2, 3]
    _close(got, ref)
