"""Convergence regression of the port: the counterpart of
tests/test_convergence.py, through the port's fine-tune CLI on the CPU.

The same separable synthetic corpus (a word is a sinusoid's frequency over
its span, so held-out clips of the same vocabulary are decodable), the same
argv (``perf/flagship_drive.py::convergence_argv``), 400 steps, and the
same gate on the held-out greedy-decode WER: at most 0.15 at step 400,
where the JAX package's calibration reached 0.00. Broken learning dynamics
(the optimizer, the fold, the label contract, the decode) trip it. The card
runs the same gate in chip_smoke.py's ``family`` phase."""

import json

import pytest


@pytest.mark.slow
def test_heldout_wer_regression(tmp_path):
    from neuspeech1_tpu_torch.cli.finetune import main as finetune
    from neuspeech1_tpu_torch.data.synthetic import make_separable_corpus
    from neuspeech1_tpu_torch.perf.flagship_drive import (CONVERGENCE_WER,
                                                          convergence_argv)

    corpus = str(tmp_path / "sep")
    make_separable_corpus(corpus, n_clips=300, n_channels=8, seed=3)
    out = str(tmp_path / "run")
    finetune(convergence_argv(corpus, out) + ["--device=cpu"])
    records = [json.loads(line) for line in open(f"{out}/metrics.jsonl")]
    wers = [r["eval_wer"] for r in records if "eval_wer" in r]
    assert wers, "no eval_wer logged"
    assert wers[-1] <= CONVERGENCE_WER, (
        f"held-out WER regression: {wers[-1]:.3f} at step 400 "
        f"(JAX package calibrated 0.00; trajectory {wers})")
