"""The port's training step (neuspeech1_tpu_torch/train) against the JAX
package's on the same weights, adapters and batch, in f32 on the CPU, with
the JAX model's attention through its Pallas flash kernels (interpret
mode): loss, gradient norm and updated leaves over three steps, the
cross-entropy's custom backward, and the optimizer against optax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (
    lora_from_params, module_from_params, params_from_lora)
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_whisper import port, tiny

torch.set_num_threads(1)

# the bound the JAX package holds against HF torch (test_model_parity.py)
RTOL, ATOL = 1e-4, 2e-4
N_STEPS = 3
STEM = StemConfig("base", in_channels=8)
TSTEM = port(STEM)


def _batch(config, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 8, 400)).astype(np.float32)
    labels = rng.integers(0, config.vocab_size, (2, 8)).astype(np.int32)
    labels[:, -2:] = -100
    dec = rng.integers(0, config.vocab_size, (2, 8)).astype(np.int32)
    return {"input_features": feats, "labels": labels,
            "decoder_input_ids": dec}


def _torch_batch(batch):
    return {"input_features": torch.from_numpy(batch["input_features"]),
            "labels": torch.from_numpy(batch["labels"]).long(),
            "decoder_input_ids": torch.from_numpy(batch["decoder_input_ids"])
            .long()}


def _setup(config):
    params = jax.device_get(init_params(jax.random.key(0), config, STEM))
    lora = jax.device_get(init_lora(jax.random.key(1), config, rank=8,
                                    alpha=16))
    model = module_from_params(params, port(config), TSTEM, device="cpu",
                               dtype=torch.float32)
    return params, lora, model, lora_from_params(lora, device="cpu")


def _optimizers():
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    return jopt.make_optimizer(**kw), topt.make_optimizer(**kw)


def _leaves(trainable_lora, model):
    """The stacked adapter tree plus the stem / conv2 leaves, as numpy."""
    return {"lora": trainable_lora, "stem": {
        "conv_a": model.encoder.stem.conv_a.weight.detach().numpy().copy(),
        "conv_b_b": model.encoder.stem.conv_b.bias.detach().numpy().copy(),
        "conv2": model.encoder.conv2.weight.detach().numpy().copy()}}


def _jax_leaves(trainable):
    enc = trainable["model"]["encoder"]
    return {"lora": jax.device_get(trainable["lora"]), "stem": {
        "conv_a": np.asarray(enc["stem"]["conv_a"]["w"]),
        "conv_b_b": np.asarray(enc["stem"]["conv_b"]["b"]),
        "conv2": np.asarray(enc["conv2"]["w"])}}


@pytest.fixture(scope="module")
def runs():
    """N_STEPS of the fold_lora train step in both packages: per step the
    metrics and the trainable leaves after the update."""
    config = tiny()
    params, lora, model, t_lora = _setup(config)
    batch = _batch(config)
    jtx, ttx = _optimizers()
    state, frozen = jts.init_train_state(jax.random.key(2), params, lora, jtx,
                                         jopt.default_trainable_pred())
    jstep = jts.make_train_step(config, STEM, jtx, fold_lora=True,
                                donate=False)
    tstate, tfrozen = tts.init_train_state(model, t_lora, ttx)
    tstep = tts.make_train_step(port(config), TSTEM, ttx, fold_lora=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    out = []
    for _ in range(N_STEPS):
        state, jm = jstep(state, frozen, jb)
        tm = tstep(tstate, tfrozen, tb)
        out.append({
            "jax": {k: float(jm[k]) for k in ("loss", "ce_loss", "grad_norm")},
            "torch": {k: float(tm[k]) for k in ("loss", "ce_loss",
                                                 "grad_norm")},
            "jax_leaves": _jax_leaves(state.trainable),
            "torch_leaves": _leaves(params_from_lora(t_lora), model)})
    return out


@pytest.mark.parametrize("step", range(N_STEPS))
def test_train_step_metrics_match_jax(runs, step):
    got, ref = runs[step]["torch"], runs[step]["jax"]
    for k in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert got["grad_norm"] > 0


@pytest.mark.parametrize("step", range(N_STEPS))
def test_train_step_updated_leaves_match_jax(runs, step):
    """Every adapter leaf (attention and fc, A and B) and the stem leaves
    after the optimizer update."""
    got, ref = runs[step]["torch_leaves"], runs[step]["jax_leaves"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_first_update_uses_lr_zero(runs):
    """optax reads the schedule before counting the step: under warmup the
    first update has lr 0, so B is still exactly zero after step 1 and
    moves at step 2."""
    fc1 = [r["torch_leaves"]["lora"]["encoder"]["layers"]["fc1"]["B"]
           for r in runs]
    assert not fc1[0].any()
    assert fc1[1].any()


def test_ce_loss_grads_match_jax_custom_vjp():
    """CrossEntropy's forward and its custom backward against the JAX
    ce_loss VJP, with an ignored token and a row whose nll is clamped at
    exactly 0 (its label leads by 40, so the exp-sum rounds to 1): the
    custom backward still gives that row softmax - onehot."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (2, 5)).astype(np.int32)
    labels[1, 4] = -100
    logits[0, 2, labels[0, 2]] = 40.0
    loss_ref, vjp = jax.vjp(lambda x: jw.ce_loss(x, jnp.asarray(labels)),
                            jnp.asarray(logits))
    (g_ref,) = vjp(jnp.float32(1.5))
    x = torch.from_numpy(logits).requires_grad_()
    loss = tw.ce_loss(x, torch.from_numpy(labels).long())
    (loss * 1.5).backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=RTOL,
                               atol=1e-7)
    others = np.arange(64) != labels[0, 2]
    assert (x.grad[0, 2][others] > 0).all()  # exp(-40) * w, not zeroed
    assert not x.grad[1, 4].any()


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 110), (1e-3, 1, 10),
                                               (5e-4, 500, 100_000),
                                               (1.0, 0, 5)])
def test_warmup_linear_schedule_matches_optax(peak, warmup, total):
    ours = topt.warmup_linear_schedule(peak, warmup, total)
    ref = jopt.warmup_linear_schedule(peak, warmup, total)
    counts = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 3} - {-1})
    # optax evaluates in f32, where peak * (1 - c / steps) cancels near the
    # ends of both ramps: its error is a few f32 ulps of the peak
    for c in counts:
        np.testing.assert_allclose(ours(c), float(ref(c)), rtol=1e-6,
                                   atol=peak * 1e-6, err_msg=str(c))
    assert ours(0) == (0.0 if warmup else peak)


@pytest.mark.parametrize("grad_scale", [0.1, 10.0])
def test_optimizer_matches_optax(grad_scale):
    """Clip then AdamW with weight decay on a no-decay mask, three updates,
    against optax: gradients below the clip threshold (untouched) and
    above it (scaled by 1 / norm)."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jtx, ttx = jopt.make_optimizer(**kw), topt.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = {k: (rng.standard_normal(v.shape) * grad_scale).astype(np.float32)
             for k, v in params.items()}
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after update {i + 1}")


def test_init_train_state_trains_exactly_the_default_set():
    config = tiny()
    _, _, model, t_lora = _setup(config)
    state, _ = tts.init_train_state(model, t_lora, topt.make_optimizer())
    leaves = topt.named_leaves(model, t_lora)
    trained = {p for p, t in leaves.items() if t.requires_grad}
    assert trained == set(state.trainable)
    assert trained == {p for p in leaves if p.startswith(
        ("lora/", "model/encoder/stem/", "model/encoder/conv2/"))}
    assert "model/encoder/stem/conv_a/w" in trained
    assert "lora/encoder/layers/1/self_attn/q/A" in trained
    assert not model.encoder.layers[0].fc1.weight.requires_grad


def test_fold_lora_grads_equal_the_delta_path():
    """fold_lora=True (merged attention adapters, folded fc adapters) gives
    the loss and gradients of the per-token delta path."""
    config = tiny()
    _, _, model, t_lora = _setup(config)
    for layer in t_lora["encoder"]["layers"]:  # B starts at zero
        for entry in (layer["fc1"], layer["fc2"], layer["self_attn"]["v"]):
            entry["B"] += 0.01
    state, frozen = tts.init_train_state(model, t_lora, topt.make_optimizer())
    batch = _torch_batch(_batch(config, seed=5))
    grads = []
    for fold in (False, True):
        loss, _ = tts.make_loss_fn(port(config), TSTEM, fold_lora=fold)(
            frozen, batch)
        grads.append((loss.item(), dict(zip(state.trainable, torch.autograd.grad(
            loss, list(state.trainable.values()), allow_unused=True)))))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, rel=1e-6)
    for k, a in g0.items():
        b = g1[k]
        if a is None or b is None:
            assert a is None and b is None and k.rsplit("/", 1)[-1] in (
                "alpha", "mask"), k
            continue
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, msg=k)


def test_eval_step_matches_jax():
    config = tiny()
    params, lora, model, t_lora = _setup(config)
    batch = _batch(config, seed=6)
    jtx, ttx = _optimizers()
    jstate, jfrozen = jts.init_train_state(jax.random.key(2), params, lora,
                                           jtx, jopt.default_trainable_pred())
    ref = jts.make_eval_step(config, STEM)(
        jstate.trainable, jfrozen, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
    state, frozen = tts.init_train_state(model, t_lora, ttx)
    got = tts.make_eval_step(port(config), TSTEM)(state, frozen,
                                             _torch_batch(batch))
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]),
                               rtol=RTOL, atol=ATOL)
    assert int(got["n_tokens"]) == int(ref["n_tokens"]) == 12


def _fold_merge_raises(runs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tts.make_loss_fn(port(tiny()), TSTEM, fold_lora=True,
                         fold_impl="merge")


def _composed_steps_match_jax(runs, sizes, **axes):
    """N_STEPS of the port's step with the config's ``axes`` under LocalRing
    threads of a mesh of ``sizes``, on a model split over its fsdp and
    tensor axes: every rank's metrics and leaves within the bounds of the
    JAX package's one-device steps (``runs``)."""
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import sharding
    from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing

    config = port(tiny(**axes))

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            _, _, model, t_lora = _setup(tiny())
            model.config = config  # the forward reads the model's axes
            sharding.shard_params(model)
            ttx = _optimizers()[1]
            state, frozen = tts.init_train_state(model, t_lora, ttx)
            step = tts.make_train_step(config, TSTEM, ttx, fold_lora=True)
            rows = pmesh.batch_sharding()
            tb = {k: rows.shard(v)
                  for k, v in _torch_batch(_batch(tiny())).items()}
            out = []
            for _ in range(N_STEPS):
                m = step(state, frozen, tb)
                out.append(({k: float(m[k]) for k in ("loss", "ce_loss",
                                                      "grad_norm")},
                            _leaves(params_from_lora(t_lora), model)))
        return out

    for run in LocalRing.run_mesh(rank, **sizes):
        for (got, leaves), ref in zip(run, runs):
            for k, v in got.items():
                np.testing.assert_allclose(v, ref["jax"][k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
            for (path, a), b in zip(
                    jax.tree_util.tree_leaves_with_path(leaves),
                    jax.tree_util.tree_leaves(ref["jax_leaves"])):
                np.testing.assert_allclose(
                    a, b, rtol=RTOL, atol=ATOL,
                    err_msg=jax.tree_util.keystr(path))


UNPORTED = {
    "fold_merge": _fold_merge_raises,
    # FSDP and tensor parallelism beside sequence or pipeline parallelism
    # raised until the mesh's axes composed (ROADMAP queue 1 item 10);
    # they now run and match the JAX package's steps
    "fsdp_axis": lambda runs: _composed_steps_match_jax(
        runs, {"fsdp": 2, "seq": 2}, seq_parallel_axis="seq"),
    "tensor_axis": lambda runs: _composed_steps_match_jax(
        runs, {"tensor": 2, "pipe": 2}, pipeline_axis="pipe"),
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_options_raise(option, runs):
    """The 'merge' fold regime raises; FSDP beside sequence parallelism and
    tensor parallelism beside GPipe, which raised here too, run."""
    UNPORTED[option](runs)


def test_loss_fn_refuses_another_stem_kind():
    """make_loss_fn's ``stem`` was read nowhere: the port ran the model's
    own stem whatever kind it named, where the JAX forward, which reads
    the stem's weights by kind, fails. A stem of another kind now raises in
    both; one that differs only in fields the deterministic forward does
    not read (dropout) gives the model's loss, in both."""
    config = tiny()
    params, _, model, _ = _setup(config)
    batch = _batch(config)
    other = StemConfig("replace", in_channels=8)
    with pytest.raises(KeyError):
        jw.forward(params, jnp.asarray(batch["input_features"]),
                   jnp.asarray(batch["decoder_input_ids"]), config, other)
    frozen = tts.Frozen(model, None)
    with pytest.raises(ValueError, match="stem kind 'replace'"):
        tts.make_loss_fn(port(config), port(other))(frozen,
                                                    _torch_batch(batch))
    drop = StemConfig("base", in_channels=8, dropout=0.5)
    loss, _ = tts.make_loss_fn(port(config), port(drop))(
        frozen, _torch_batch(batch))
    ref, _ = tts.make_loss_fn(port(config), TSTEM)(frozen,
                                                   _torch_batch(batch))
    assert loss.item() == ref.item()
    jref = jw.ce_loss(jw.forward(
        params, jnp.asarray(batch["input_features"]),
        jnp.asarray(batch["decoder_input_ids"]), config, drop),
        jnp.asarray(batch["labels"]))
    np.testing.assert_allclose(loss.item(), float(jref), rtol=RTOL,
                               atol=ATOL)
