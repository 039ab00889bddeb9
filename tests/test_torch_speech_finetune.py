"""The port's fine-tune CLI with ``--modal=speech`` against the JAX
package's, in f32 on the CPU, on tests/test_torch_speech.py's corpus (with
16 kHz wavs) and speech-stem model: from one base npz and the same adapters
(the port's ``init_lora`` handed the JAX package's draws), the same files
and ``metrics.jsonl`` keys, losses, gradient norms and eval losses within
rtol 1e-4 / atol 2e-4, the same adapter keys and shapes; with
``--augment_config_path`` the step's noise, mask and taylor on JAX's own
draws (its ``jax.random.split`` sequence replayed), and the host's shift not
applied (``SpeechDataset`` takes none)."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli.finetune import main as jax_finetune
from neuspeech1_tpu.config import WhisperConfig
from neuspeech1_tpu.models.lora import init_lora as jax_init_lora
from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from neuspeech1_tpu_torch.models import lora as tlora
from neuspeech1_tpu_torch.models.convert import lora_from_params
from neuspeech1_tpu_torch.ops import augment as ta
from tests.test_torch_augment import FULL, jax_augment_draws
from tests.test_torch_speech import GEO_FLAGS, make_speech_setup

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_speech_setup(str(tmp_path_factory.mktemp("speech_ft")))


def _jax_adapters(monkeypatch):
    """The port's ``init_lora`` hands back the JAX package's draws for the
    same seed, so that both CLIs train the same adapters."""
    def init(config, rank=32, alpha=64.0, adalora=False, seed=1,
             device="cpu", layer_range=None, **kw):
        jconfig = WhisperConfig(**dataclasses.asdict(config))
        tree = jax.device_get(jax_init_lora(
            jax.random.key(seed), jconfig, rank=rank, alpha=alpha,
            adalora=adalora, layer_range=layer_range, **kw))
        return lora_from_params(tree, device=device)

    monkeypatch.setattr(tlora, "init_lora", init)


def _replay_augment(monkeypatch, seed, config):
    """The port's step draws its augmentation as the JAX step does: from
    the state's key (``seed``), split into (next key, augmentation key,
    dropout key) at every step."""
    key = [jax.random.key(seed)]

    def draw(gen, shape, cfg):
        key[0], aug_rng, _ = jax.random.split(key[0], 3)
        return jax_augment_draws(aug_rng, tuple(shape), config)

    monkeypatch.setattr(ta, "draw_augment", draw)


def _train_argv(s, out, *extra):
    return [f"--train_data={s['corpus']}/train.jsonl",
            f"--val_data={s['corpus']}/val.jsonl",
            f"--base_model={s['model_dir']}/params.npz",
            f"--tokenizer={s['tokenizer']}", "--modal=speech",
            "--max_steps=2", "--per_device_train_batch_size=2",
            "--learning_rate=0.01", "--warmup_steps=1", "--eval_steps=2",
            "--save_steps=2", "--logging_steps=1", "--label_max_length=24",
            "--bf16=False", "--remat=False", "--mesh_data=1",
            "--adalora_tinit=0", "--adalora_tfinal=1", "--adalora_deltaT=1",
            f"--output_dir={out}", *GEO_FLAGS, *extra]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out_dir = next(a.split("=", 1)[1] for a in argv
                   if a.startswith("--output_dir="))
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[finetune]")]
    return records, lines


def _both(s, monkeypatch, tmp_path, *extra):
    """Both CLIs on the same argv, the port on the JAX package's adapter
    draws: (JAX records, port records, output dirs, port's [finetune]
    lines)."""
    _jax_adapters(monkeypatch)
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    jr, _ = _run(jax_finetune, _train_argv(s, out["jax"], *extra))
    tr, lines = _run(port_finetune, _train_argv(s, out["port"],
                                                "--device=cpu", *extra))
    return jr, tr, out, lines


def _check_losses(jr, tr):
    steps = [r for r in jr if "loss" in r]
    got = [r for r in tr if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in steps] == [1, 2]
    for a, b in zip(got, steps):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {a['step']} {k}")
    evals = [(r, q) for r, q in zip(tr, jr) if "eval_loss" in r]
    assert evals
    for a, b in evals:
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"],
                                   rtol=RTOL, atol=ATOL)
    return got


def test_speech_finetune_matches_jax(setup, monkeypatch, tmp_path):
    """The CLI's defaults (AdaLoRA, orthogonality 0.5, the fold) with
    --modal=speech, 2 steps with an eval and its WER decode: the same
    files, records and adapter layout, losses within the model bound, the
    speech stem trained (its conv1 in the adapter's model tree)."""
    jr, tr, out, lines = _both(setup, monkeypatch, tmp_path,
                               "--eval_wer=True")
    names = {k: sorted(set(os.listdir(v)) - {"tb"}) for k, v in out.items()}
    assert names["port"] == names["jax"]
    assert [tuple(r) for r in tr] == [tuple(r) for r in jr]
    assert {tuple(r) for r in tr} >= {
        ("step", "loss", "grad_norm", "samples_per_sec", "epoch"),
        ("step", "eval_loss", "eval_wer", "eval_bleu1")}
    got = _check_losses(jr, tr)
    assert got[0]["loss"] != got[1]["loss"]
    # neither CLI stages speech features on the device
    assert not any("staging" in ln or "rotating" in ln for ln in lines)
    files = {k: np.load(os.path.join(v, "adapter_final.npz"))
             for k, v in out.items()}
    assert sorted(files["port"].files) == sorted(files["jax"].files)
    for name in files["jax"].files:
        assert files["port"][name].shape == files["jax"][name].shape, name
        assert files["port"][name].dtype == files["jax"][name].dtype, name
    assert "model/encoder/stem/conv1/w" in files["port"].files
    assert "lora/encoder/layers/fc1/E" in files["port"].files
    np.testing.assert_allclose(files["port"]["model/encoder/stem/conv1/w"],
                               files["jax"]["model/encoder/stem/conv1/w"],
                               rtol=RTOL, atol=ATOL)


def test_speech_finetune_with_augmentation_matches_jax(setup, monkeypatch,
                                                       tmp_path):
    """--augment_config_path with every tier on: noise, mask and taylor
    run in the step on the log-mel features (on JAX's replayed draws in
    the port), shift is dropped for speech in both CLIs; the losses
    match, and differ from the run without augmentation."""
    path = str(tmp_path / "augment.json")
    with open(path, "w") as f:
        json.dump(FULL, f)
    device_tier = {k: v for k, v in FULL.items() if k != "shift"}
    _replay_augment(monkeypatch, seed=3, config=device_tier)  # seed + 3
    jr, tr, _, lines = _both(setup, monkeypatch, tmp_path,
                             f"--augment_config_path={path}",
                             "--use_adalora=False", "--lora_rank=4")
    got = _check_losses(jr, tr)
    assert not any("staging" in ln or "rotating" in ln for ln in lines)
    plain, _ = _run(port_finetune, _train_argv(
        setup, str(tmp_path / "plain"), "--device=cpu",
        "--use_adalora=False", "--lora_rank=4"))
    assert [r["loss"] for r in got] != \
        [r["loss"] for r in plain if "loss" in r]
