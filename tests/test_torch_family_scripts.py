"""The port's perf/model_panel.py and perf/flagship_drive.py on the CPU at
the tiny config, and the training step's refusal of a config its model's
forward does not run.

- ``model_panel.main``: each of the JAX script's four rows prints the JAX
  keys with finite values (no ``mfu`` off the card), and ``large_train``
  prints an out-of-memory row before it falls back to the smaller batch.
- ``flagship_drive``: phases A, B, C and the Schoffelen transfer S, each at
  2 steps on 20-clip corpora through the port's fine-tune CLI, end in the
  JAX script's ``_summarize`` keys; S re-initializes the stem for 273
  channels and its eval CLI writes its result files.
- The step's config against the model's (ROADMAP queue 3): on the input
  that showed the fault (tests/test_torch_remat_sp.py's setup on a
  LocalRing(2) under {seq: ring}, the step built on a config with
  ``seq_parallel_axis='seq'`` and the model on one without) the step used
  to sum a whole-sequence gradient over the ring, a pre-clip norm of
  1.8233 against 0.9129; it now raises, and with the model built from the
  step's config the norm is one rank's. ``make_loss_fn`` and
  ``make_train_step`` refuse a config that differs from the model's in any
  field the forward reads.

Times here are CPU times: the card's come from chip_smoke.py."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.perf import flagship_drive, model_panel
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_train import TSTEM, _batch, _setup, _torch_batch
from tests.test_torch_whisper import port, tiny

torch.set_num_threads(1)

PANEL_KEYS = {
    "small_train": {"config", "batch", "remat", "step_ms", "samples_per_sec",
                    "mfu"},
    "large_train": {"config", "batch", "remat", "step_ms", "samples_per_sec",
                    "mfu", "fwd_gflops_per_sample"},
    "large_decode": {"config", "batch", "ms8", "ms32", "ms_per_token",
                     "tok_per_sec"},
    "large_decode_int8_bs32": {"config", "batch", "ms8", "ms32",
                               "ms_per_token", "tok_per_sec"},
}
PANEL_NAMES = {"small_train": "small_train", "large_train": "large_v3_train",
               "large_decode": "large_v3_decode",
               "large_decode_int8_bs32": "large_v3_decode_int8kv"}
SUMMARY_KEYS = {"phase", "sustained_samples_per_sec",
                "heldout_wer_trajectory", "bleu1_trajectory",
                "eval_loss_trajectory", "best_eval_kept"}
TINY_FLAGS = [
    "--max_steps=2", "--d_model=64", "--encoder_layers=1",
    "--decoder_layers=1", "--encoder_heads=2", "--decoder_heads=2",
    "--encoder_ffn=128", "--decoder_ffn=128", "--max_source_positions=80",
    "--max_target_positions=48", "--max_audio_len=1.6", "--eval_steps=2",
    "--save_steps=2", "--logging_steps=1", "--per_device_train_batch_size=4",
    "--per_device_eval_batch_size=4", "--bf16=False", "--adalora_tinit=0",
    "--adalora_tfinal=1", "--adalora_deltaT=1", "--num_workers=1",
    "--mesh_data=1"]
RTOL, ATOL = 1e-4, 2e-4


def _finite(x) -> bool:
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return isinstance(x, (bool, str)) or math.isfinite(x)


@pytest.mark.parametrize("row", sorted(PANEL_KEYS))
def test_model_panel_prints_the_jax_keys(row):
    lines = []
    assert model_panel.main([row, "--device", "cpu", "--model", "test"],
                            emit=lines.append) == 0
    (r,) = [json.loads(s) for s in lines]
    assert set(r) == PANEL_KEYS[row]
    assert r["config"] == PANEL_NAMES[row]
    assert r["batch"] == {"small_train": 2, "large_train": 2,
                          "large_decode": 2,
                          "large_decode_int8_bs32": 4}[row]
    for k, v in r.items():
        if k == "mfu":
            assert v is None  # no card: no MFU
        elif k not in ("config", "remat"):
            assert _finite(v) and v > 0, (k, v)
    if row == "large_train":
        assert r["remat"] is True


def test_large_train_prints_the_oom_before_the_smaller_batch(monkeypatch):
    calls = []
    row = model_panel.train_row

    def train_row(name, config, stem, batch_size, k, device, setup=None):
        calls.append(batch_size)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (a test)")
        return row(name, config, stem, batch_size, k, device, setup)

    monkeypatch.setattr(model_panel, "train_row", train_row)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    lines = []
    model_panel.main(["large_train", "--device", "cpu", "--model", "test"],
                     emit=lines.append)
    err, ok = (json.loads(s) for s in lines)
    assert calls == [2, 1]
    assert err == {"config": "large_v3_train", "batch": 2,
                   "error": "OutOfMemoryError: CUDA out of memory (a test)"}
    assert ok["batch"] == 1 and set(ok) == PANEL_KEYS["large_train"]


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flagship"))
    lines = []
    out = flagship_drive.main(["ABCS", "--root", root, "--device", "cpu",
                               "--clips", "20", *TINY_FLAGS],
                              emit=lines.append)
    return root, out, [json.loads(s) for s in lines]


@pytest.mark.parametrize("phase,tag", [
    ("A", "A_ft_full"), ("B", "B_adalora_published"),
    ("C", "C_lora_published"), ("S", "S_transfer_273")])
def test_flagship_phase_summaries(drive, phase, tag):
    root, out, lines = drive
    r = out[phase]
    assert set(r) == SUMMARY_KEYS and r["phase"] == tag
    assert json.loads(json.dumps(r)) in lines  # printed
    assert _finite(r["sustained_samples_per_sec"])
    assert [s for s, _ in r["eval_loss_trajectory"]] == [2]
    assert _finite(r["eval_loss_trajectory"]) and _finite(r["best_eval_kept"])
    assert [s for s, _ in r["heldout_wer_trajectory"]] == [2]
    assert _finite(r["heldout_wer_trajectory"] + r["bleu1_trajectory"])


def test_flagship_phases_start_from_their_base(drive):
    """B and C train on phase A's exported model; S's adapter and transfer
    on its own base run's, in the word tokenizer's layout."""
    root, _, lines = drive
    for run in ("runA", "runS"):
        assert os.path.exists(os.path.join(root, run, "full_model",
                                           "params.npz"))
    for run in ("runB", "runC", "runS208", "runS273"):
        with open(os.path.join(root, run, "metrics.jsonl")) as f:
            assert f.readline()
    assert [r["phase"] for r in lines if r["phase"].startswith("S_")] == [
        "S_base_208", "S_adapter_208", "S_eval", "S_transfer_273"]


def test_schoffelen_transfer_reinitializes_the_stem(drive):
    root, _, lines = drive
    adapter = np.load(os.path.join(root, "runS273", "adapter_final.npz"))
    assert adapter["model/encoder/stem/conv_a/w"].shape == (64, 273, 3)
    a208 = np.load(os.path.join(root, "runS208", "adapter_final.npz"))
    assert a208["model/encoder/stem/conv_a/w"].shape == (64, 208, 3)
    ev = next(r for r in lines if r["phase"] == "S_eval")
    assert ev["result_files"] == ["test_beam5.json", "test_beam5.jsonl",
                                  "test_beam5.txt"]
    assert _finite(list(ev["metrics"].values()))
    with open(os.path.join(root, "runS273", "full_model",
                           "config.json")) as f:
        assert json.load(f)["stem"]["in_channels"] == 273


# ---- the step's config against the model's ------------------------------

def _ring_norms(step_config, model_config):
    """Pre-clip gradient norms of one fold_lora step on each rank of a
    LocalRing(2) under {seq: ring}: the step on ``step_config``, the model
    on ``model_config`` (each a JAX config, handed over as the port's)."""
    def rank(ring):
        params, _, _, t_lora = _setup(tiny())
        model = module_from_params(params, port(model_config), TSTEM,
                                   device="cpu", dtype=torch.float32)
        tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                 total_steps=10)
        state, frozen = tts.init_train_state(model, t_lora, tx)
        step = tts.make_train_step(port(step_config), TSTEM, tx,
                                   fold_lora=True)
        with pmesh.set_mesh({"seq": ring}):
            return float(step(state, frozen,
                              _torch_batch(_batch(tiny())))["grad_norm"])
    return LocalRing.run(rank, 2)


def _one_rank_norm():
    _, _, model, t_lora = _setup(tiny())
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, frozen = tts.init_train_state(model, t_lora, tx)
    step = tts.make_train_step(port(tiny()), TSTEM, tx, fold_lora=True)
    return float(step(state, frozen, _torch_batch(_batch(tiny())))[
        "grad_norm"])


def test_sp_step_on_a_model_without_the_axis_raises():
    """The ROADMAP's input: the step's config has the ring, the model's
    does not. The step used to run, each rank the whole sequence, and sum
    the gradients over the ring (2x); it now raises before any draw."""
    with pytest.raises(ValueError, match="seq_parallel_axis='seq' vs None"):
        _ring_norms(tiny(seq_parallel_axis="seq"), tiny())


def test_sp_step_on_the_steps_config_gives_one_ranks_norm():
    """Model and step built from the same config: the SP step's norm is
    the one-rank step's on every rank."""
    norms = _ring_norms(tiny(seq_parallel_axis="seq"),
                        tiny(seq_parallel_axis="seq"))
    one = _one_rank_norm()
    assert norms[0] == norms[1]
    np.testing.assert_allclose(norms, [one, one], rtol=RTOL, atol=ATOL)


FIELD_CHANGES = {
    "seq_parallel_axis": "seq", "pipeline_axis": "pipe", "remat": True,
    "dtype": "bfloat16", "flash_attention": "off", "d_model": 64,
    "encoder_heads": 4, "remat_policy": "dots",
}


@pytest.mark.parametrize("field", sorted(FIELD_CHANGES))
@pytest.mark.parametrize("factory", ["make_train_step", "make_loss_fn"])
def test_step_refuses_a_config_the_forward_does_not_run(field, factory):
    _, _, model, t_lora = _setup(tiny())
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, frozen = tts.init_train_state(model, t_lora, tx)
    config = dataclasses.replace(port(tiny()),
                                 **{field: FIELD_CHANGES[field]})
    batch = _torch_batch(_batch(tiny()))
    with pytest.raises(ValueError, match=f"{field}="):
        if factory == "make_train_step":
            tts.make_train_step(config, TSTEM, tx, fold_lora=True)(
                state, frozen, batch)
        else:
            tts.make_loss_fn(config, TSTEM, fold_lora=True)(frozen, batch)
    # nothing moved: the refusal comes before the draws and the update
    assert state.step == 0
    assert all(t.grad is None for t in state.trainable.values())


def test_step_takes_a_config_differing_only_outside_the_forward():
    """Fields the forward does not read (the token layout's names kept,
    ``scan_unroll``, ``param_dtype``) do not stop the step."""
    _, _, model, t_lora = _setup(tiny())
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, frozen = tts.init_train_state(model, t_lora, tx)
    config = dataclasses.replace(port(tiny()), scan_unroll=2,
                                 param_dtype="bfloat16")
    m = tts.make_train_step(config, TSTEM, tx, fold_lora=True)(
        state, frozen, _torch_batch(_batch(tiny())))
    assert math.isfinite(float(m["loss"])) and state.step == 1

