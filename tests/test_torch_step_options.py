"""The training step's options in the port (neuspeech1_tpu_torch/train/
trainstep.py, models/whisper.py) against the JAX package's, in f32 on the
CPU, on the same weights, adapters and batch:

- every remat policy: one step's loss and gradients against the JAX step
  under the same policy and against the port without remat (rtol 1e-4 /
  atol 2e-4), and the flash forward's calls in the backward: one more per
  encoder layer under None, 'dots' and 'attn', none under the others;
- dropout for the 'base' and 'premel' stems, and augmentation (noise,
  mask, taylor, SpecAugment), each on JAX's own draws (its
  ``jax.random.split`` sequence replayed): the step's metrics and updated
  leaves against ``make_train_step(use_dropout=True, augment_config=)``;
- a resume with augmentation and dropout on is bit-exact;
- the fine-tune CLI's ``--int8_matmul`` and ``--augment_config_path``
  against the JAX CLI's."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli.finetune import main as jax_finetune
from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params,
                                                 params_from_lora)
from neuspeech1_tpu_torch.ops import augment as ta
from neuspeech1_tpu_torch.ops import flash_attention as fa
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_eval_cli import GEO, make_eval_setup
from tests.test_torch_trainer import _configs
from tests.test_torch_whisper import port
from tests.test_train import make_batch

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
STEM = StemConfig("base", in_channels=4)


def _weights(jconfig, stem, adalora=True):
    """Init weights, and adapters with B and E drawn at a trained
    magnitude (the attention and fc adapters both carry gradients)."""
    params = jax.device_get(init_params(jax.random.key(0), jconfig, stem))
    lora = jax.device_get(init_lora(jax.random.key(1), jconfig, rank=4,
                                    alpha=8.0, adalora=adalora))
    rng = np.random.default_rng(6)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key in ("E", "B") else np.asarray(x), lora)
    return params, lora


def _port(params, lora, tconfig, stem, tx):
    model = module_from_params(params, tconfig, port(stem), device="cpu",
                               dtype=torch.float32)
    return tts.init_train_state(model, lora_from_params(lora, device="cpu"),
                                tx)


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out["labels"] = out["labels"].long()
    out["decoder_input_ids"] = out["decoder_input_ids"].long()
    return out


def _optimizers():
    kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10)
    return jopt.make_optimizer(**kw), topt.make_optimizer(**kw)


# --------------------------------------------------------------------------
# remat policies
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def remat_setup():
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, STEM)
    batch = jax.device_get(make_batch(jconfig, STEM))
    state, frozen = _port(params, lora, dataclasses.replace(
        tconfig, flash_attention="on"), STEM, topt.make_optimizer())
    ref = _port_grads(frozen, state, tconfig, batch, "none")
    return jconfig, tconfig, params, lora, batch, state, frozen, ref


def _port_grads(frozen, state, tconfig, batch, policy):
    """Loss, gradients by leaf and flash forward calls of one port step's
    loss (AdaLoRA, orthogonality 0.5, the fold) under remat with
    ``policy``, or without remat for "none"."""
    config = dataclasses.replace(tconfig, flash_attention="on",
                                 remat=policy != "none",
                                 remat_policy=None if policy == "none"
                                 else policy)
    frozen.model.config = config
    calls = [0]
    orig = fa._forward

    def counted(*a):
        calls[0] += 1
        return orig(*a)

    fa._forward = counted
    try:
        loss, _ = tts.make_loss_fn(config, port(STEM), orth_reg_weight=0.5,
                                   fold_lora=True)(frozen, _torch_batch(batch))
        leaves = {k: t for k, t in state.trainable.items()
                  if t.requires_grad}
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
    finally:
        fa._forward = orig
    return loss.item(), grads, calls[0]


@pytest.mark.parametrize("policy", [p for p in tw.REMAT_POLICIES] + ["full"])
def test_remat_policy_matches_jax_and_no_remat(remat_setup, policy):
    """'full', a name outside REMAT_POLICIES, is full recompute in both
    packages: the same numbers as policy None."""
    jconfig, tconfig, params, lora, batch, state, frozen, ref = remat_setup
    loss, grads, calls = _port_grads(frozen, state, tconfig, batch, policy)
    # against the port without remat: the same numbers
    assert loss == ref[0]
    for k, g in grads.items():
        assert (g is None) == (ref[1][k] is None), k
        if g is not None:
            assert torch.equal(g, ref[1][k]), k
    extra = calls - ref[2]
    layers = tconfig.encoder_layers
    assert extra == (layers if policy in (None, "dots", "attn", "full")
                     else 0)
    # against the JAX step under the same policy
    jc = dataclasses.replace(jconfig, remat=True, remat_policy=policy)
    jtx, _ = _optimizers()
    jstate, jfrozen = jts.init_train_state(jax.random.key(2), params, lora,
                                           jtx, jopt.default_trainable_pred())
    jloss = jts.make_loss_fn(jc, STEM, orth_reg_weight=0.5, fold_lora=True)
    (ref_loss, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate.trainable, jfrozen, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, None)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=RTOL, atol=ATOL)
    jl = jax.device_get(jg["lora"])["encoder"]["layers"]
    for n in ("fc1", "fc2"):
        for m in ("A", "B", "E"):
            np.testing.assert_allclose(
                np.stack([grads[f"lora/encoder/layers/{i}/{n}/{m}"].numpy()
                          for i in range(layers)]), jl[n][m], rtol=RTOL,
                atol=ATOL, err_msg=f"{n}/{m}")
    for i in range(layers):
        for n in ("q", "v", "out"):
            for m in ("A", "B"):
                np.testing.assert_allclose(
                    grads[f"lora/encoder/layers/{i}/self_attn/{n}/{m}"]
                    .numpy(), jl["self_attn"][n][m][i], rtol=RTOL, atol=ATOL,
                    err_msg=f"{i}/{n}/{m}")


def test_unknown_remat_policy_raises():
    """The JAX package runs full recompute for a policy name it does not
    know (perf/ablate.py's 'full'), and so does the port: such a name
    builds the loss and resolves to policy None. What still raises is remat
    under sequence parallelism, whatever the policy's name."""
    _, tconfig = _configs(remat=True, remat_policy="full")
    tts.make_loss_fn(tconfig, port(STEM))
    for name in ("full", "dot", None, "flash"):
        config = dataclasses.replace(tconfig, remat_policy=name)
        tw.check_remat(config)
        assert tw.remat_policy(config) == (
            "flash" if name == "flash" else None)
        with pytest.raises(NotImplementedError, match="sequence parallel"):
            tw.check_remat(dataclasses.replace(config,
                                               seq_parallel_axis="seq"))
    tw.check_remat(dataclasses.replace(tconfig, remat=False,
                                       seq_parallel_axis="seq"))


def test_remat_restores_the_int8_mode_in_the_backward(remat_setup):
    """The backward runs a checkpointed layer's forward after the step's
    int8 context has closed: the recompute must see the mode again, or its
    outputs would not be the saved forward's (full recompute, 'dots' and
    'flash' each recompute some int8 products)."""
    _, tconfig, _, _, batch, state, frozen, _ = remat_setup
    for policy in (None, "dots", "flash"):
        got = []
        for remat in (False, True):
            config = dataclasses.replace(tconfig, flash_attention="on",
                                         remat=remat, remat_policy=policy)
            frozen.model.config = config
            loss, _ = tts.make_loss_fn(config, port(STEM), fold_lora=True,
                                       int8_matmul="full")(
                frozen, _torch_batch(batch))
            leaves = [t for t in state.trainable.values() if t.requires_grad]
            got.append((loss.item(), torch.autograd.grad(
                loss, leaves, allow_unused=True)))
        (l0, g0), (l1, g1) = got
        assert l0 == l1
        for a, b in zip(g0, g1):
            assert (a is None and b is None) or torch.equal(a, b), policy


# --------------------------------------------------------------------------
# dropout and augmentation on JAX's draws
# --------------------------------------------------------------------------

AUG = {"noise": {"prob": 0.5, "min_snr_dB": 5, "max_snr_dB": 20},
       "mask": {"prob": 0.5, "kwargs": {"unit": [1, 16], "mask_prob": 0.25}},
       "taylor": {"prob": 0.7},
       "spec_augment": {"mask_time_prob": 0.1, "mask_time_length": 5,
                        "mask_feature_prob": 0.3, "mask_feature_length": 1}}


def _jax_dropout(drop_rng, config, stem, b):
    """The masks ``encoder_apply`` draws from the step's dropout key."""
    dropout_rng, stem_rng = jax.random.split(drop_rng)
    keep = 1.0 - stem.dropout
    out = {"rate": stem.dropout}
    if stem.kind == "premel":
        out["stem"] = torch.from_numpy(np.array(jax.random.bernoulli(
            stem_rng, keep, (b, 1, config.num_mel_bins))))
    out["frames"] = torch.from_numpy(np.array(jax.random.bernoulli(
        dropout_rng, keep, (b, config.max_source_positions, 1))))
    return out


def _step_both(monkeypatch, stem, augment=None, use_dropout=False,
               n_steps=2):
    """``n_steps`` of each package's step, the port's on JAX's replayed
    draws: per step (port metrics, JAX metrics), and the updated adapter
    trees."""
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, stem)
    batch = jax.device_get(make_batch(jconfig, stem))
    jtx, ttx = _optimizers()
    jstate, jfrozen = jts.init_train_state(jax.random.key(2), params, lora,
                                           jtx, jopt.default_trainable_pred())
    jstep = jts.make_train_step(jconfig, stem, jtx, orth_reg_weight=0.5,
                                augment_config=augment,
                                use_dropout=use_dropout, fold_lora=True,
                                donate=False)
    state, frozen = _port(params, lora, tconfig, stem, ttx)
    tstep = tts.make_train_step(tconfig, port(stem), ttx,
                                orth_reg_weight=0.5, augment_config=augment,
                                use_dropout=use_dropout, fold_lora=True)
    replay = {}
    monkeypatch.setattr(ta, "draw_augment",
                        lambda gen, shape, cfg: replay["aug"])
    monkeypatch.setattr(tw, "draw_dropout",
                        lambda gen, config, st, b: replay["drop"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    out = []
    for _ in range(n_steps):
        _, aug_rng, drop_rng = jax.random.split(jstate.rng, 3)
        replay["aug"] = jax_augment_draws(aug_rng, batch["input_features"]
                                          .shape, augment)
        replay["drop"] = _jax_dropout(drop_rng, jconfig, stem,
                                      batch["input_features"].shape[0])
        jstate, jm = jstep(jstate, jfrozen, jb)
        tm = tstep(state, frozen, tb)
        out.append(({k: float(tm[k]) for k in ("loss", "grad_norm")},
                    {k: float(jm[k]) for k in ("loss", "grad_norm")}))
    return out, params_from_lora(frozen.lora), jax.device_get(
        jstate.trainable["lora"])


def _check(out, tree, jtree):
    for got, ref in out:
        for k in got:
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["base", "premel"])
def test_dropout_on_jax_draws_matches_jax(monkeypatch, kind):
    stem = StemConfig(kind, in_channels=4, dropout=0.3)
    out, tree, jtree = _step_both(monkeypatch, stem, use_dropout=True)
    _check(out, tree, jtree)
    det, _, _ = _step_both(monkeypatch, StemConfig(kind, in_channels=4),
                           n_steps=1)
    assert det[0][0]["loss"] != out[0][0]["loss"]


def test_augmentation_and_dropout_on_jax_draws_match_jax(monkeypatch):
    stem = StemConfig("base", in_channels=4, dropout=0.1)
    out, tree, jtree = _step_both(monkeypatch, stem, augment=AUG,
                                  use_dropout=True)
    _check(out, tree, jtree)


@pytest.mark.parametrize("kind", ["base", "premel"])
def test_dropout_at_rate_zero_is_the_deterministic_step(kind):
    jconfig, tconfig = _configs()
    stem = StemConfig(kind, in_channels=4)
    params, lora = _weights(jconfig, stem)
    batch = _torch_batch(jax.device_get(make_batch(jconfig, stem)))
    runs = []
    for use_dropout in (False, True):
        _, ttx = _optimizers()
        state, frozen = _port(params, lora, tconfig, stem, ttx)
        before = state.generator.get_state()
        m = tts.make_train_step(tconfig, port(stem), ttx, fold_lora=True,
                                use_dropout=use_dropout)(state, frozen, batch)
        assert torch.equal(state.generator.get_state(), before)
        runs.append((m["loss"].item(), {k: t.detach().clone() for k, t in
                                         state.trainable.items()}))
    assert runs[0][0] == runs[1][0]
    for k, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][k]), k


def test_port_draws_drop_at_the_rate():
    _, tconfig = _configs(max_source_positions=400)
    gen = torch.Generator().manual_seed(0)
    d = tw.draw_dropout(gen, tconfig, port(StemConfig("premel", dropout=0.2)),
                        256)
    for name, shape in (("stem", (256, 1, tconfig.num_mel_bins)),
                        ("frames", (256, 400, 1))):
        mask = d[name]
        assert mask.shape == shape and mask.dtype == torch.bool
        n = mask.numel()
        assert abs(mask.sum().item() - 0.8 * n) <= 5 * (n * 0.16) ** 0.5
    assert tw.draw_dropout(gen, tconfig, port(StemConfig("base")), 4) is None
    assert "stem" not in tw.draw_dropout(
        gen, tconfig, port(StemConfig("base", dropout=0.1)), 4)


def test_resume_is_bit_exact_with_augmentation_and_dropout(tmp_path):
    """8 steps straight equal 4 steps, a save, a fresh state restored from
    it and 4 more: the generator's state rides in the checkpoint, so the
    resumed draws continue the sequence."""
    jconfig, tconfig = _configs()
    stem = StemConfig("premel", in_channels=4, dropout=0.2)
    params, lora = _weights(jconfig, stem)
    batch = _torch_batch(jax.device_get(make_batch(jconfig, stem)))

    def fresh():
        _, ttx = _optimizers()
        state, frozen = _port(params, lora, tconfig, stem, ttx)
        step = tts.make_train_step(tconfig, port(stem), ttx, fold_lora=True,
                                   augment_config=AUG, use_dropout=True)
        return state, frozen, step

    state, frozen, step = fresh()
    whole = [step(state, frozen, batch)["loss"].item() for _ in range(8)]
    split_state, split_frozen, split_step = fresh()
    first = [split_step(split_state, split_frozen, batch)["loss"].item()
             for _ in range(4)]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(split_state, force=True)
    ckpt.wait()
    resumed, r_frozen, r_step = fresh()
    assert ckpt.restore_latest(resumed) is resumed and resumed.step == 4
    rest = [r_step(resumed, r_frozen, batch)["loss"].item()
            for _ in range(4)]
    assert first + rest == whole
    assert len(set(whole)) == 8
    for k, t in state.trainable.items():
        assert torch.equal(resumed.trainable[k], t), k
    assert torch.equal(resumed.generator.get_state(),
                       state.generator.get_state())


# --------------------------------------------------------------------------
# the fine-tune CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    return make_eval_setup(str(tmp_path_factory.mktemp("options_cli")))


def _cli_argv(s, out, *extra):
    """ft_full, so that both packages start from the same npz weights (the
    adapters' init draws differ between them), and the threaded loader,
    whose numpy batch order both packages share (the device cache draws
    its order with each package's own generator)."""
    return [f"--train_data={s['corpus']}/train.jsonl",
            f"--base_model={s['model_dir']}/params.npz",
            f"--tokenizer={s['common'][1].split('=', 1)[1]}", "--eeg_ch=4",
            "--max_audio_len=0.64", "--min_audio_len=0.5", "--max_steps=3",
            "--per_device_train_batch_size=2", "--learning_rate=0.001",
            "--warmup_steps=1", "--eval_steps=100", "--save_steps=100",
            "--logging_steps=1", "--label_max_length=24", "--bf16=False",
            "--remat=False", "--mesh_data=1", "--ft_full=True",
            "--eval_wer=False", "--device_cache=off", f"--output_dir={out}",
            *[f"--{k}={v}" for k, v in GEO.items()], *extra]


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
    return [r for r in records if "loss" in r], lines


# Under 'full' every weight gradient is itself an int8 product, which
# rounds differently when its inputs differ in their last bits (see
# tests/test_torch_int8_matmul.py: a few percent of a gradient's norm): the
# loss after the first update that moves the weights (step 3: warmup's
# first update has lr 0) and the gradient norms take these bounds
# (measured: 2.4e-4 and 1.3e-2).
FULL_LOSS_RTOL, FULL_NORM_RTOL = 1e-3, 5e-2


@pytest.mark.parametrize("mode", ["fwd", "full"])
def test_cli_int8_losses_match_jax(cli_setup, tmp_path, mode):
    s = cli_setup
    jr, _ = _run(jax_finetune, _cli_argv(s, str(tmp_path / "j"),
                                         f"--int8_matmul={mode}"))
    tr, _ = _run(port_finetune, _cli_argv(s, str(tmp_path / "t"),
                                          f"--int8_matmul={mode}",
                                          "--device=cpu"))
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [1, 2, 3]
    for a, b in zip(tr, jr):
        moved = mode == "full" and a["step"] > 2
        np.testing.assert_allclose(
            a["loss"], b["loss"], rtol=FULL_LOSS_RTOL if moved else RTOL,
            atol=ATOL)
        np.testing.assert_allclose(
            a["grad_norm"], b["grad_norm"],
            rtol=FULL_NORM_RTOL if mode == "full" else RTOL, atol=ATOL)
    off, _ = _run(port_finetune, _cli_argv(s, str(tmp_path / "o"),
                                           "--device=cpu"))
    assert off[0]["loss"] != tr[0]["loss"]


def test_cli_all_zero_augmentation(cli_setup, tmp_path):
    """configs/augmentation1.json (every probability 0): the port's run
    equals its run without the config bit for bit (the loss records and
    the final weights; the Python clip reader runs in place of the native
    one, with the same bytes), its losses equal the JAX CLI's within the
    model bound, and both CLIs keep the device cache (shift's probability
    is 0)."""
    s = cli_setup
    aug = "--augment_config_path=configs/augmentation1.json"
    jr, _ = _run(jax_finetune, _cli_argv(s, str(tmp_path / "j"), aug))
    tr, _ = _run(port_finetune, _cli_argv(s, str(tmp_path / "t"), aug,
                                          "--device=cpu"))
    plain, _ = _run(port_finetune, _cli_argv(s, str(tmp_path / "p"),
                                             "--device=cpu"))
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=RTOL,
                                   atol=ATOL)
    assert [(r["loss"], r["grad_norm"]) for r in tr] == \
        [(r["loss"], r["grad_norm"]) for r in plain]
    got = np.load(str(tmp_path / "t" / "adapter_final.npz"))
    ref = np.load(str(tmp_path / "p" / "adapter_final.npz"))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for main, tag, extra in ((jax_finetune, "jc", ()),
                             (port_finetune, "tc", ("--device=cpu",))):
        _, lines = _run(main, _cli_argv(s, str(tmp_path / tag), aug,
                                        "--max_steps=1",
                                        "--device_cache=auto", *extra))
        assert any("staging" in ln for ln in lines), lines


def _shift_config(tmp_path):
    path = str(tmp_path / "shift.json")
    with open(path, "w") as f:
        json.dump({"shift": {"prob": 1.0},
                   "noise": {"prob": 0.5, "min_snr_dB": 5,
                             "max_snr_dB": 20},
                   "taylor": {"prob": 0.5}}, f)
    return f"--augment_config_path={path}"


def test_cli_shift_turns_the_caches_and_native_loader_off(cli_setup,
                                                          tmp_path):
    """With shift on, neither CLI stages the corpus on the device, and
    --native_loader=on raises in both; the port's run trains."""
    s = cli_setup
    aug = _shift_config(tmp_path)
    for main, tag, extra in ((jax_finetune, "j", ()),
                             (port_finetune, "t", ("--device=cpu",))):
        records, lines = _run(main, _cli_argv(
            s, str(tmp_path / tag), aug, "--max_steps=2",
            "--device_cache=auto", *extra))
        assert not any("staging" in ln or "rotating" in ln for ln in lines)
        assert len(records) == 2 and all(np.isfinite(r["loss"])
                                         for r in records)
        with pytest.raises(ValueError, match="native_loader=on"):
            main(_cli_argv(s, str(tmp_path / f"{tag}_native"), aug,
                           "--native_loader=on", *extra))
        with pytest.raises(ValueError, match="device_cache=on"):
            main(_cli_argv(s, str(tmp_path / f"{tag}_cache"), aug,
                           "--device_cache=on", *extra))
