"""The eval CLI's other decode modes in the port (neuspeech1_tpu_torch/cli/
evaluation.py) against the JAX CLI, in f32 on the CPU: contrastive search,
the timestamp grammar and noise-free sampling write the JAX CLI's files
byte for byte; sampling and beam-sample with their warpers give the same
files twice under one seed, under the JAX CLI's tags. Then the
Transcriber's sampling arguments: each one is read."""

import filecmp
import os

import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli.evaluation import main as jax_main
from neuspeech1_tpu_torch.cli.evaluation import main as port_main
from neuspeech1_tpu_torch.serve import Transcriber
from tests.test_torch_eval_cli import make_eval_setup, preds, run_both
from tests.test_torch_sampling import setup  # noqa: F401
from tests.test_torch_timestamps import model_dir  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    return make_eval_setup(str(tmp_path_factory.mktemp("eval_modes")))


CASES = {
    # the reference's contrastiveSearch strategy; num_beams goes to 1
    "contrastive": (["--penalty_alpha=1", "--top_k=5"], "contrastive5"),
    "contrastive_alpha0.6": (["--penalty_alpha=0.6", "--top_k=3",
                              "--repetition_penalty=1.0"], "contrastive3"),
    "timestamps": (["--timestamps=True"], "beam5"),
    "timestamps_greedy": (["--timestamps=True", "--num_beams=1"], "beam1"),
    # top-k 1 at one beam leaves one token per step: no noise decides
    "sample_top_k_1": (["--do_sample=True", "--top_k=1", "--num_beams=1"],
                       "sample"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_modes_files_equal_jax(eval_setup, case):
    flags, tag = CASES[case]
    argv = eval_setup["common"] + [
        f"--model_path={eval_setup['model_dir']}"] + flags
    out, metrics = run_both(eval_setup, argv, case)
    assert os.path.exists(os.path.join(out, f"all_{tag}.jsonl"))
    assert len(preds(out)) == 8


SAMPLED = {
    "sample": (["--num_beams=1"], "sample"),
    "beam_sample": (["--num_beams=2"], "beam_sample2"),
}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampling_is_deterministic_under_one_seed(eval_setup, case):
    """Sampling with the warpers at temperature 1.3: one seed writes the
    same files twice, another seed other predictions, under the JAX CLI's
    tag and file names."""
    flags, tag = SAMPLED[case]
    argv = eval_setup["common"] + [
        f"--model_path={eval_setup['model_dir']}", "--do_sample=True",
        "--top_k=20", "--top_p=0.9", "--temperature=1.3",
        "--device=cpu"] + flags
    outs = {}
    for name, seed in (("a", 3), ("b", 3), ("c", 4)):
        outs[name] = os.path.join(eval_setup["root"], f"{case}_{name}")
        port_main(argv + [f"--sample_seed={seed}",
                          f"--output_dir={outs[name]}"])
    files = sorted(os.listdir(outs["a"]))
    assert files == sorted(os.listdir(outs["b"]))
    assert f"all_{tag}.jsonl" in files
    for name in files:
        assert filecmp.cmp(os.path.join(outs["a"], name),
                           os.path.join(outs["b"], name), shallow=False)
    assert preds(outs["a"]) != preds(outs["c"])
    jax_out = os.path.join(eval_setup["root"], f"{case}_jax")
    jax_main([a for a in argv if a != "--device=cpu"]
             + ["--sample_seed=3", f"--output_dir={jax_out}"])
    assert sorted(os.listdir(jax_out)) == files


def _texts(model_dir, **kw):
    signals = np.random.default_rng(0).standard_normal(
        (4, 8, 400)).astype(np.float32)
    tr = Transcriber(model_dir, device="cpu", batch_size=2, max_new_tokens=10,
                     suppress_tokens="none", do_sample=True, **kw)
    return [tr.transcribe(signals) for _ in range(2)], tr.gen


BASE = dict(temperature=1.0, top_k=0, top_p=1.0, sample_seed=0)
CHANGED = {"temperature": 3.0, "top_k": 2, "top_p": 0.3, "sample_seed": 9,
           "num_beams": 2}


@pytest.mark.parametrize("arg", list(CHANGED))
def test_transcriber_sampling_arguments_are_read(model_dir, arg):  # noqa: F811
    """Each sampling argument reaches the decode: at a fixed seed a call is
    repeated exactly, and changing the argument alone changes the texts."""
    (a, a2), gen_a = _texts(model_dir, **BASE)
    (b, b2), gen_b = _texts(model_dir, **dict(BASE, **{arg: CHANGED[arg]}))
    assert a == a2 and b == b2
    assert a != b
    if arg not in ("sample_seed",):
        assert getattr(gen_b, arg) == CHANGED[arg] != getattr(gen_a, arg)
