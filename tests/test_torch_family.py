"""The port against the JAX package at the Whisper family's widths beyond
whisper-base, in f32 on the CPU: the ``small``, ``medium`` and ``large``
(large-v3) presets' widths, heads, FFN, mel bins and vocabulary at 1+1
layers, weights from the JAX package's ``init_params`` through
``models/convert.py``.

Stems: whisper-small with the 'base' EEG stem over 208 channels (the
panel's ``small_train``), whisper-medium over 273 channels (the Schoffelen
recordings), large-v3 with the 'speech' stem over its 128 mel bins (the
panel's ``large_decode``).

Checks per preset: the encoder's output and the teacher-forced logits
within the bound the JAX package holds against HF torch (rtol 1e-4 / atol
2e-4), greedy tokens exactly equal, and one LoRA step's loss and
gradients (the 'fc' fold, r=8, every B drawn at N(0, 0.02^2) so that A's
gradients carry signal) within the same bound.

Cut to size: ``max_source_positions`` is 200 (1500 in the presets; the
stems' inputs are 800 samples or 400 mel frames), which keeps the file
near a minute alone; the layers' widths are the presets'."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig, preset_config
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params)
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_whisper import port

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
SOURCE = 200
BATCH = 2
LABELS = 8
NEW_TOKENS = 8
LORA_RANK = 8
STEMS = {"small": StemConfig("base", in_channels=208),
         "medium": StemConfig("base", in_channels=273),
         "large": StemConfig("speech")}


def _params(config, stem):
    """init_params weights with every weight matrix and embedding scaled
    to std 0.08, so that greedy tokens depend on the input."""
    params = jax.device_get(init_params(jax.random.key(0), config, stem))

    def f(path, x):
        return x * 4.0 if path[-1].key in ("w", "token_embed") else x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module", params=sorted(STEMS))
def family(request):
    name = request.param
    config = preset_config(name, encoder_layers=1, decoder_layers=1,
                           max_source_positions=SOURCE, dtype="float32")
    stem = STEMS[name]
    params = _params(config, stem)
    rng = np.random.default_rng(0)
    shape = ((BATCH, config.num_mel_bins, 2 * SOURCE) if stem.kind == "speech"
             else (BATCH, stem.in_channels, 4 * SOURCE))
    feats = rng.standard_normal(shape).astype(np.float32)
    model = module_from_params(params, port(config), port(stem),
                               device="cpu")
    return name, config, stem, params, model, feats


def test_preset_widths(family):
    name, config, _, _, model, _ = family
    want = {"small": (768, 12, 3072, 80, 51865),
            "medium": (1024, 16, 4096, 80, 51865),
            "large": (1280, 20, 5120, 128, 51866)}[name]
    got = (config.d_model, config.encoder_heads, config.encoder_ffn,
           config.num_mel_bins, config.vocab_size)
    assert got == want and config.d_model // config.encoder_heads == 64
    assert model.config == port(config)


def test_encoder_matches_jax(family):
    _, config, stem, params, model, feats = family
    ref = np.asarray(jax.jit(
        lambda p, f: jw.encoder_apply(p, f, config, stem))(params, feats))
    with torch.no_grad():
        ours = tw.encoder_apply(model, torch.from_numpy(feats)).numpy()
    assert ours.shape == (BATCH, SOURCE, config.d_model)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_forward_logits_match_jax(family):
    _, config, stem, params, model, feats = family
    dec = np.random.default_rng(1).integers(0, config.vocab_size,
                                            (BATCH, LABELS))
    ref = np.asarray(jax.jit(
        lambda p, f, d: jw.forward(p, f, d, config, stem))(
        params, feats, dec.astype(np.int32)))
    with torch.no_grad():
        ours = tw.forward(model, torch.from_numpy(feats),
                          torch.from_numpy(dec)).numpy()
    assert ours.shape == (BATCH, LABELS, config.vocab_size)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_greedy_tokens_equal_jax(family):
    _, config, stem, params, model, feats = family
    prompt = np.asarray([[config.sot_id, config.first_language_id,
                          config.transcribe_id, config.notimestamps_id]]
                        * BATCH, np.int32)
    length = prompt.shape[1] + NEW_TOKENS
    ref = np.asarray(jg.greedy_decode(
        params, feats, prompt, config, stem,
        jg.GenerationConfig.for_model(config, max_length=length)))
    ours = tg.generate(model, torch.from_numpy(feats),
                       torch.from_numpy(prompt.astype(np.int64)),
                       tg.GenerationConfig.for_model(port(config),
                                                     max_length=length))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the tokens depend on the input: not one token for every row
    assert len({tuple(r) for r in ref[:, prompt.shape[1]:].tolist()}) > 1 \
        or len(set(ref[0, prompt.shape[1]:].tolist())) > 1


def _lora(config):
    """JAX ``init_lora`` at r=8 with every B drawn at N(0, 0.02^2)."""
    lora = jax.device_get(init_lora(jax.random.key(1), config,
                                    rank=LORA_RANK, alpha=2 * LORA_RANK))
    rng = np.random.default_rng(2)

    def f(path, x):
        if path[-1].key == "B":
            return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, lora)


def test_lora_step_grads_match_jax(family):
    _, config, stem, params, _, feats = family
    lora = _lora(config)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, config.vocab_size, (BATCH, LABELS)).astype(
        np.int32)
    labels[:, -2:] = -100
    batch = {"input_features": feats, "labels": labels,
             "decoder_input_ids": rng.integers(
                 0, config.vocab_size, (BATCH, LABELS)).astype(np.int32)}
    jtx = jopt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstate, jfrozen = jts.init_train_state(jax.random.key(2), params, lora,
                                           jtx, jopt.default_trainable_pred())
    jloss = jts.make_loss_fn(config, stem, fold_lora=True)
    (ref_loss, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate.trainable, jfrozen,
        {k: jnp.asarray(v) for k, v in batch.items()}, None)

    tconfig = port(config)
    model = module_from_params(params, tconfig, port(stem), device="cpu",
                               dtype=torch.float32)
    t_lora = lora_from_params(lora, device="cpu")
    ttx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state, frozen = tts.init_train_state(model, t_lora, ttx)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tts.make_loss_fn(tconfig, port(stem), fold_lora=True)(
        frozen, tbatch)
    leaves = {k: t for k, t in state.trainable.items() if t.requires_grad}
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True)))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL,
                               atol=ATOL)

    jl = jax.device_get(jgrads["lora"])["encoder"]["layers"]
    checked = 0
    for name in ("fc1", "fc2"):
        for m in ("A", "B"):
            np.testing.assert_allclose(
                grads[f"lora/encoder/layers/0/{name}/{m}"].numpy(),
                jl[name][m][0], rtol=RTOL, atol=ATOL, err_msg=f"{name}/{m}")
            checked += 1
    for name in ("q", "k", "v", "out"):
        for m in ("A", "B"):
            if name not in jl["self_attn"]:
                continue
            np.testing.assert_allclose(
                grads[f"lora/encoder/layers/0/self_attn/{name}/{m}"].numpy(),
                jl["self_attn"][name][m][0], rtol=RTOL, atol=ATOL,
                err_msg=f"self_attn/{name}/{m}")
            checked += 1
    jstem = jax.device_get(jgrads["model"])["encoder"]["stem"]
    for conv, leaf in jstem.items():
        for k, g in leaf.items():
            np.testing.assert_allclose(
                grads[f"model/encoder/stem/{conv}/{k}"].numpy(), g,
                rtol=RTOL, atol=ATOL, err_msg=f"stem/{conv}/{k}")
            checked += 1
    assert checked >= 8
    assert dataclasses.asdict(tconfig) == dataclasses.asdict(config)
