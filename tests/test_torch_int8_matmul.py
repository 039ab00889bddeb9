"""The port's int8 training matmuls (neuspeech1_tpu_torch/ops/int8_matmul.py,
`linear` and `FoldedLinear` under its modes) against the JAX package's
``ops/int8_matmul.py`` and ``models/lora.py::folded_linear`` on the CPU, in
f32: values and straight-through gradients under 'fwd' and 'full' within
the 1e-6 the JAX package's own tests hold (tests/test_int8_matmul.py),
exact zero rows, ``torch._int_mm``'s padded shapes, and one training
step's loss and gradients against ``make_train_step(int8_matmul=)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuspeech1_tpu.models import lora as jlora
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.ops import int8_matmul as ji8
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models import lora as tlora
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.ops import int8_matmul as ti8
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_int8_matmul import np_qdot
from tests.test_torch_train import (ATOL, RTOL, STEM, TSTEM, _batch,
                                    _optimizers, _setup, _torch_batch)
from tests.test_torch_whisper import port, tiny

torch.set_num_threads(1)

OP_RTOL = OP_ATOL = 1e-6  # tests/test_int8_matmul.py's bound
MODES = ("fwd", "full")


def _arrays(seed, x_shape, din, dout, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*x_shape, din)) * scale).astype(np.float32)
    w = rng.standard_normal((dout, din)).astype(np.float32)  # port [out, in]
    dy = rng.standard_normal((*x_shape, dout)).astype(np.float32)
    return x, w, dy


def _port_vjp(fn, x, w, dy):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("x_shape,din,dout", [((6,), 32, 16), ((2, 5), 8, 12),
                                              ((3, 7), 13, 10)])
def test_quantized_dot_matches_jax(mode, x_shape, din, dout):
    """Values, dx and dW (the port's [out, in], JAX's [in, out]
    transposed) against the JAX custom VJP; odd K and N go through the
    padded ``_int_mm``."""
    x, w, dy = _arrays(0, x_shape, din, dout)
    y_ref, vjp = jax.vjp(lambda a, b: ji8.quantized_dot(a, b, m=mode),
                         jnp.asarray(x), jnp.asarray(w.T))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    y, dx, dw = _port_vjp(lambda a, b: ti8.quantized_dot(a, b, mode),
                          x, w, dy)
    for got, ref, name in ((y, y_ref, "y"), (dx, dx_ref, "dx"),
                           (dw, np.asarray(dw_ref).T, "dw")):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=name)
    exact = x.reshape(-1, din) @ w.T
    assert not np.array_equal(y.reshape(exact.shape), exact)


def test_qdot_matches_the_numpy_gold():
    x, w, _ = _arrays(1, (6,), 32, 16)
    got = ti8.qdot(torch.from_numpy(x), torch.from_numpy(w), torch.float32)
    np.testing.assert_allclose(got.numpy(), np_qdot(x, w.T), rtol=1e-6,
                               atol=1e-6)


def test_token_contraction_matches_jax():
    """'full''s dW over the N tokens: both operands quantized along N, the
    scales in the JAX package's order."""
    x, _, dy = _arrays(2, (40,), 12, 9)
    ref = np.asarray(ji8._qdot2(jnp.asarray(x).T, jnp.asarray(dy),
                                jnp.float32)).T
    got = ti8.qdot_tokens(torch.from_numpy(x), torch.from_numpy(dy),
                          torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("m,k,n", [(3, 5, 7), (16, 8, 8), (17, 24, 40),
                                   (40, 9, 1)])
def test_int_mm_pads_to_the_cards_shapes(m, k, n):
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = ti8._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("mode", MODES)
def test_zero_rows_are_exact(mode):
    x = torch.zeros(3, 8, requires_grad=True)
    w = torch.ones(4, 8, requires_grad=True)
    y = ti8.quantized_dot(x, w, mode)
    assert torch.equal(y, torch.zeros(3, 4))
    y.backward(torch.zeros(3, 4))
    assert torch.equal(x.grad, torch.zeros(3, 8))
    assert torch.equal(w.grad, torch.zeros(4, 8))
    q, s = ti8._quant(torch.zeros(2, 5), 1)
    assert torch.equal(q, torch.zeros(2, 5, dtype=torch.int8))
    assert torch.equal(s, torch.ones(2, 1))


def test_mode_context():
    assert ti8.mode() == "off"
    with ti8.int8_mode("full"):
        assert ti8.mode() == "full"
        with ti8.int8_mode("fwd"):
            assert ti8.mode() == "fwd"
        assert ti8.mode() == "full"
    assert ti8.mode() == "off"
    with pytest.raises(ValueError, match="int8 matmul mode"):
        with ti8.int8_mode("int4"):
            pass


def _linear(w, b):
    p = nn.Linear(w.shape[1], w.shape[0], bias=b is not None)
    with torch.no_grad():
        p.weight.copy_(torch.from_numpy(w))
        if b is not None:
            p.bias.copy_(torch.from_numpy(b))
    return p


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bias,with_lora", [(True, False), (False, False),
                                            (True, True)])
def test_linear_routes_through_int8_mode(mode, bias, with_lora):
    """`linear` under the mode against the JAX ``linear``: the product
    quantized, the bias and the per-token LoRA delta exact; values and the
    gradients of x, W and the adapter."""
    x, w, dy = _arrays(4, (2, 5), 8, 12)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(12).astype(np.float32) if bias else None
    lora = ({"A": (rng.standard_normal((8, 4)) * 0.3).astype(np.float32),
             "B": (rng.standard_normal((4, 12)) * 0.3).astype(np.float32),
             "alpha": np.full((1, 1), 8.0, np.float32)} if with_lora
            else None)

    def jfn(xx, ww, lo):
        p = {"w": ww, "b": None if b is None else jnp.asarray(b)}
        with ji8.int8_mode(mode):
            return jw.linear(xx, p, lo)

    jl = None if lora is None else {k: jnp.asarray(v) for k, v in
                                    lora.items()}
    y_ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w.T), jl)
    dx_ref, dw_ref, dl_ref = vjp(jnp.asarray(dy))
    p = _linear(w, b)
    xt = torch.from_numpy(x).requires_grad_()
    tl = None if lora is None else {
        k: torch.from_numpy(v).requires_grad_(k != "alpha")
        for k, v in lora.items()}
    with ti8.int8_mode(mode):
        y = tw.linear(xt, p, tl)
    y.backward(torch.from_numpy(dy))
    pairs = [(y.detach(), y_ref), (xt.grad, dx_ref),
             (p.weight.grad, np.asarray(dw_ref).T)]
    # the exact delta sums its terms in another order than XLA: f32's
    # rounding of outputs near 40 (about 4e-6), not the quantization
    atol = OP_ATOL
    if lora is not None:
        pairs += [(tl[k].grad, dl_ref[k]) for k in ("A", "B")]
        atol = 1e-5
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=OP_RTOL, atol=atol)
    with torch.no_grad():
        exact = tw.linear(xt, p, tl)
    assert not torch.equal(exact, y.detach())


@pytest.mark.parametrize("mode", ("off",) + MODES)
@pytest.mark.parametrize("adalora", [False, True])
def test_folded_linear_matches_jax(mode, adalora):
    """`FoldedLinear` under each mode against the JAX ``folded_linear`` (its
    CPU branch): 'fwd' quantizes the W_eff product, 'full' the dx product
    too; dA, dB and dE come from the adapter-backward kernel's plain
    version on the exact x and dy."""
    x, w, dy = _arrays(6, (2, 7), 16, 24, scale=1.0)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(24).astype(np.float32)
    entry = {"A": (rng.standard_normal((16, 4)) * 0.1).astype(np.float32),
             "B": (rng.standard_normal((4, 24)) * 0.1).astype(np.float32),
             "alpha": np.full((1, 1), 8.0, np.float32)}
    if adalora:
        entry["E"] = rng.standard_normal((4, 1)).astype(np.float32)
    diff = [k for k in ("A", "B", "E") if k in entry]

    def jfn(xx, *leaves):
        e = {**{k: jnp.asarray(v) for k, v in entry.items()},
             **dict(zip(diff, leaves))}
        p = {"w": jnp.asarray(w.T), "b": jnp.asarray(b)}
        with ji8.int8_mode(mode):
            return jlora.folded_linear(xx, p, e)

    y_ref, vjp = jax.vjp(jfn, jnp.asarray(x),
                         *[jnp.asarray(entry[k]) for k in diff])
    refs = vjp(jnp.asarray(dy))
    p = _linear(w, b)
    p.requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_()
    te = {k: torch.from_numpy(v).requires_grad_(k in diff)
          for k, v in entry.items()}
    with ti8.int8_mode(mode):
        y = tlora.folded_linear(xt, p, te)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=OP_RTOL, atol=OP_ATOL)
    for got, ref, name in zip([xt.grad] + [te[k].grad for k in diff], refs,
                              ["x"] + diff):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=OP_RTOL, atol=OP_ATOL, err_msg=name)


# One step's gradients in int8 cannot hold the model bound elementwise:
# quantization rounds, so an input that differs in its last f32 bit (as the
# two packages' convs, layer norms and attention do) moves a few values to
# the next int8 step, and the gradients with them. The port against itself
# with its input features scaled by (1 + 1e-7 noise) moves its gradients by
# up to 3e-4 (fwd) and 2e-3 (full) absolute, 7e-5 of the loss. So the loss
# holds the model bound, and each gradient leaf the relative norm
# |g - g_jax| / |g_jax| below (measured against JAX at most 4.9e-3 under
# fwd and 1.8e-2 under full); `test_int8_rounding_moves_with_the_input`
# shows the same spread on the port alone. T' = 128: the JAX encoder pads
# T' to its flash block, and under 'full' the padded rows' values enter
# dW's per-column scales; at a multiple of 128 neither package pads.
INT8_GRAD_REL = {"fwd": 1e-2, "full": 5e-2}
T_SRC = 128


@pytest.fixture(scope="module")
def step_setup():
    config = tiny(max_source_positions=T_SRC)
    params, lora, _, _ = _setup(config)
    # B starts at 0: give the adapters a trained magnitude
    rng = np.random.default_rng(8)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "B" else np.asarray(x), lora)
    batch = _batch(config, seed=3)
    batch["input_features"] = np.random.default_rng(3).standard_normal(
        (2, 8, 4 * T_SRC)).astype(np.float32)
    return config, params, lora, batch


def _port_state(config, params, lora, tx):
    from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                     module_from_params)

    model = module_from_params(params, port(config), TSTEM, device="cpu",
                               dtype=torch.float32)
    return tts.init_train_state(model, lora_from_params(lora, device="cpu"),
                                tx)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _adapter_grads(frozen, jgrads):
    """(path, port gradient, JAX gradient) of every encoder adapter leaf
    and of the stem's first conv."""
    lg = jax.device_get(jgrads["lora"])["encoder"]["layers"]
    out = []
    for i, layer in enumerate(frozen.lora["encoder"]["layers"]):
        for path in (("fc1",), ("fc2",), ("self_attn", "q"),
                     ("self_attn", "k"), ("self_attn", "v"),
                     ("self_attn", "out")):
            got, ref = layer, lg
            for k in path:
                got, ref = got[k], ref[k]
            out += [(f"{i}/{'/'.join(path)}/{n}", got[n].grad.numpy(),
                     ref[n][i]) for n in ("A", "B")]
    stem = jax.device_get(jgrads["model"])["encoder"]["stem"]["conv_a"]["w"]
    out.append(("stem/conv_a/w",
                frozen.model.encoder.stem.conv_a.weight.grad.numpy(), stem))
    return out


@pytest.mark.parametrize("mode,fold", [("fwd", True), ("full", True),
                                       ("full", False)])
def test_train_step_loss_and_grads_match_jax(step_setup, mode, fold):
    """One step's loss (model bound) and every trainable gradient (relative
    norm, `INT8_GRAD_REL`) through ``make_loss_fn(int8_matmul=)``, then the
    step's metrics, against the JAX package's."""
    config, params, lora, batch = step_setup
    jtx, ttx = _optimizers()
    jstate, jfrozen = jts.init_train_state(jax.random.key(2), params, lora,
                                           jtx, jopt.default_trainable_pred())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jts.make_loss_fn(config, STEM, fold_lora=fold, int8_matmul=mode)
    (ref_loss, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jstate.trainable, jfrozen, jb, None)
    state, frozen = _port_state(config, params, lora, ttx)
    tb = _torch_batch(batch)
    loss, _ = tts.make_loss_fn(port(config), TSTEM, fold_lora=fold,
                               int8_matmul=mode)(frozen, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL,
                               atol=ATOL)
    for name, got, ref in _adapter_grads(frozen, jgrads):
        assert _rel(got, ref) <= INT8_GRAD_REL[mode], (name, _rel(got, ref))
    # the step
    for t in state.trainable.values():
        t.grad = None
    jstep = jts.make_train_step(config, STEM, jtx, fold_lora=fold,
                                int8_matmul=mode, donate=False)
    _, jm = jstep(jstate, jfrozen, jb)
    tm = tts.make_train_step(port(config), TSTEM, ttx, fold_lora=fold,
                             int8_matmul=mode)(state, frozen, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=INT8_GRAD_REL[mode])


def test_int8_rounding_moves_with_the_input(step_setup):
    """Why the gradients take a relative bound: when the input moves by
    1e-6 relative, the port's own gradients move by orders of magnitude
    more under 'full' than without int8 (a few values round to the next
    int8 step)."""
    config, params, lora, batch = step_setup
    spread = {}
    for mode in ("off", "full"):
        grads = []
        for eps in (0.0, 1e-6):
            _, ttx = _optimizers()
            state, frozen = _port_state(config, params, lora, ttx)
            tb = _torch_batch(batch)
            noise = torch.randn(tb["input_features"].shape,
                                generator=torch.Generator().manual_seed(0))
            tb["input_features"] = tb["input_features"] * (1 + eps * noise)
            loss, _ = tts.make_loss_fn(port(config), TSTEM, fold_lora=True,
                                       int8_matmul=mode)(frozen, tb)
            loss.backward()
            grads.append({k: t.grad.clone()
                          for k, t in state.trainable.items()
                          if t.grad is not None})
        spread[mode] = max((grads[0][k] - grads[1][k]).abs().max().item()
                           for k in grads[0])
    assert spread["off"] < 1e-6
    assert spread["full"] > 100 * spread["off"]


def test_int8_moves_the_loss_off_the_exact_step(step_setup):
    config, params, lora, batch = step_setup
    _, ttx = _optimizers()
    _, frozen = _port_state(config, params, lora, ttx)
    tb = _torch_batch(batch)
    with torch.no_grad():
        losses = {m: tts.make_loss_fn(port(config), TSTEM, fold_lora=True,
                                      int8_matmul=m)(frozen, tb)[0].item()
                  for m in ("off", "fwd")}
    assert losses["off"] != losses["fwd"]
    assert abs(losses["off"] - losses["fwd"]) < 0.05 * losses["off"]
    with pytest.raises(ValueError, match="int8_matmul"):
        tts.make_loss_fn(port(config), TSTEM, int8_matmul="int4")
