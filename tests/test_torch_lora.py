"""The port's LoRA pieces (neuspeech1_tpu_torch/models/lora.py and
ops/lora_bwd.py) against the JAX package's, in f32 on the CPU: the adapter
backward against the Pallas kernel in interpret mode, folded_linear's
gradients against jax.grad of its custom VJP, the adapter trees, and the
model's forward with adapters."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models import lora as jl
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.ops.lora_bwd import lora_adapter_bwd as jax_lora_bwd
from neuspeech1_tpu_torch.models import lora as tl
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (
    lora_from_params, module_from_params, params_from_lora)
from neuspeech1_tpu_torch.ops import lora_bwd as tlb
from tests.test_torch_flash_attention import _OnCuda
from tests.test_torch_whisper import scaled_params, tiny

torch.set_num_threads(1)

# the bound the JAX package holds against HF torch (test_model_parity.py)
RTOL, ATOL = 1e-4, 2e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_adapter_bwd_plain_matches_jax_kernel():
    """lora_adapter_bwd_plain against the Pallas kernel in interpret mode
    (N=512, din=128, dout=256, r=8); f32, so t1 and u are not rounded."""
    rng = np.random.default_rng(0)
    x, dy = _np(rng, 512, 128), _np(rng, 512, 256)
    a, b = _np(rng, 128, 8, scale=0.1), _np(rng, 8, 256, scale=0.1)
    ref = jax_lora_bwd(*(jnp.asarray(t) for t in (x, dy, a, b)),
                       block_n=256, interpret=True)
    before = tlb.launches
    got = tlb.lora_adapter_bwd(*(torch.from_numpy(t) for t in (x, dy, a, b)))
    assert tlb.launches == before
    for g, r, name in zip(got, ref, ("dA", "dB", "dE")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_adapter_bwd_plain_rounds_t1_and_u_to_the_input_dtype():
    """bf16 inputs: dA uses bf16(t1) and dB bf16(u), dE the f32 products."""
    rng = np.random.default_rng(1)
    x, dy = (torch.from_numpy(_np(rng, 300, w)).to(torch.bfloat16)
             for w in (64, 32))
    a, b = (torch.from_numpy(_np(rng, *s, scale=0.3)).to(torch.bfloat16)
            for s in ((64, 4), (4, 32)))
    da, db, de = tlb.lora_adapter_bwd_plain(x, dy, a, b)
    t1 = dy.double() @ b.double().T
    u = x.double() @ a.double()
    torch.testing.assert_close(
        da, (x.double().T @ t1.to(torch.bfloat16).double()).float())
    torch.testing.assert_close(
        db, (u.to(torch.bfloat16).double().T @ dy.double()).float())
    torch.testing.assert_close(de, (u * t1).sum(0).float())


def _entry(rng, din, dout, r, adalora):
    e = {"A": _np(rng, din, r, scale=0.1), "B": _np(rng, r, dout, scale=0.1),
         "alpha": np.full((1, 1), 2.0 * r, np.float32)}
    if adalora:
        e["E"] = _np(rng, r, 1, scale=0.5)
        e["mask"] = np.ones((r, 1), np.float32)
    return e


@pytest.mark.parametrize("adalora", [False, True])
def test_folded_linear_grads_match_jax(adalora):
    """FoldedLinear's output and its x / A / B (/ E) gradients against
    jax.grad through the JAX package's folded_linear custom VJP."""
    rng = np.random.default_rng(2)
    din, dout, r = 16, 24, 4
    x = _np(rng, 3, 5, din)
    w, bias = _np(rng, din, dout, scale=0.2), _np(rng, dout)
    entry = _entry(rng, din, dout, r, adalora)
    keys = ("A", "B") + (("E",) if adalora else ())

    def jloss(x, train):
        y = jl.folded_linear(x, {"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                             {**{k: jnp.asarray(v) for k, v in entry.items()},
                              **train})
        return jnp.sum(jnp.sin(y)), y

    (_, y_ref), g_ref = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(entry[k]) for k in keys})

    lin = torch.nn.Linear(din, dout).requires_grad_(False)
    lin.weight.copy_(torch.from_numpy(w.T))
    lin.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x).requires_grad_()
    te = {k: torch.from_numpy(v).requires_grad_(k in keys)
          for k, v in entry.items()}
    y = tl.folded_linear(tx, lin, te)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref[0]),
                               rtol=RTOL, atol=ATOL)
    for k in keys:
        np.testing.assert_allclose(te[k].grad.numpy(), np.asarray(g_ref[1][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("leaf", ["weight", "bias"])
def test_folded_linear_raises_when_the_base_requires_grad(leaf):
    """The frozen-base contract: the backward returns no gradient for W or
    the bias, so a trainable base is refused, not silently left at 0."""
    lin = torch.nn.Linear(8, 16).requires_grad_(False)
    getattr(lin, leaf).requires_grad_(True)
    entry = {"A": torch.zeros(8, 2), "B": torch.zeros(2, 16),
             "alpha": torch.ones(1, 1)}
    with pytest.raises(ValueError, match="no gradient for the base"):
        tl.folded_linear(torch.zeros(3, 8), lin, entry)


@pytest.fixture(scope="module")
def trees():
    config = tiny()
    lora = jax.device_get(jl.init_lora(jax.random.key(1), config, rank=4,
                                       alpha=8, adalora=True))
    # B and E start at zero: perturb every leaf so the deltas are nonzero
    lora = jax.tree_util.tree_map(
        lambda v: v + np.float32(0.05) * np.sign(v + 0.5), lora)
    return config, lora


def test_lora_bridge_round_trip_is_exact(trees):
    config, lora = trees
    ours = lora_from_params(lora)
    assert len(ours["encoder"]["layers"]) == config.encoder_layers
    assert ours["encoder"]["layers"][1]["fc1"]["A"].shape == (128, 4)
    back = params_from_lora(ours)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(lora)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, lora))


def test_split_lora_fc_matches_jax(trees):
    _, lora = trees
    m_ref, f_ref = jl.split_lora_fc(lora)
    m, f = tl.split_lora_fc(lora_from_params(lora))
    for ours, ref in ((m, m_ref), (f, f_ref)):
        back = params_from_lora(ours)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(ref)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, back, ref))


def test_merge_lora_matches_jax(trees):
    """Merged weights W + s A (E) B against the JAX package's merge_lora,
    layer by layer (torch weights are [out, in])."""
    config, lora = trees
    stem = StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    ref = jax.device_get(jl.merge_lora(params, lora))
    model = module_from_params(params, config, stem)
    merged = tl.merge_lora(model, lora_from_params(lora))
    assert len(merged) == 6 * config.encoder_layers
    for name, w in merged.items():
        _, _, layer, *path, _ = name.split(".")
        node = ref["encoder"]["layers"]
        for key in path:
            node = node[key]
        np.testing.assert_allclose(w.detach().numpy().T, node["w"][int(layer)],
                                   rtol=RTOL, atol=1e-6, err_msg=name)


def test_init_lora_tree_and_distributions():
    config = tiny()
    for adalora in (False, True):
        ours = params_from_lora(tl.init_lora(config, rank=8, alpha=16,
                                             adalora=adalora, seed=0))
        ref = jax.device_get(jl.init_lora(jax.random.key(0), config, rank=8,
                                          alpha=16, adalora=adalora))
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(ref)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            key = path[-1].key
            if key in ("alpha", "mask") or (key == "E") or \
                    (key == "B" and not adalora):
                np.testing.assert_array_equal(a, b, err_msg=str(path))
            else:
                std = 0.02 if adalora else 8 ** -0.5
                assert abs(a.std() / std - 1) < 0.1, path
    ranged = tl.init_lora(config, rank=4, layer_range=(1, 2))
    assert [float(layer["fc1"]["alpha"]) for layer in
            ranged["encoder"]["layers"]] == [0.0, 64.0]


@pytest.mark.parametrize("fold", [False, True])
def test_forward_with_lora_matches_jax(trees, fold):
    """Teacher-forcing logits with adapters on every encoder q/k/v/out/fc1/fc2:
    per-token deltas, and under fold_at_linear (folded weights), against
    the JAX package's forward."""
    config, lora = trees
    stem = StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 8, 400)).astype(np.float32)
    dec = rng.integers(0, config.vocab_size, (2, 6)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, f, d, lo: jw.forward(
        p, f, d, config, stem, lora=lo))(params, feats, dec, lora))
    model = module_from_params(params, config, stem)
    ours_lora = lora_from_params(lora)
    with torch.no_grad(), (tw.fold_at_linear() if fold
                           else contextlib.nullcontext()):
        out = tw.forward(model, torch.from_numpy(feats),
                         torch.from_numpy(dec).long(), ours_lora).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def _cuda_case(n, din=128, dout=256, r=8, dtype=torch.bfloat16):
    rng = np.random.default_rng(4)
    return [torch.from_numpy(_np(rng, *s)).to(dtype).as_subclass(_OnCuda)
            for s in ((n, din), (n, dout), (din, r), (r, dout))]


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """On a CUDA tensor the adapter backward launches its kernel or raises,
    whatever N: here N=1000 (no 1024-token block divides it, which sends
    the JAX package to its einsum path) reaches the library load."""
    def no_plain(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(tlb, "lora_adapter_bwd_plain", no_plain)
    monkeypatch.setattr(tlb, "_library", no_library)
    before = tlb.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        tlb.lora_adapter_bwd(*_cuda_case(1000))
    assert tlb.launches == before


KERNEL_REJECTS = {"rank": (dict(r=65), "rank 1..64"),
                  "width": (dict(din=120), "multiples of 16"),
                  "dtype": (dict(dtype=torch.float32), "takes bfloat16")}


@pytest.mark.parametrize("bad", list(KERNEL_REJECTS))
def test_cuda_path_rejects_what_kernel_does_not_take(monkeypatch, bad):
    def no_library():
        raise AssertionError("validation must fail before the launch")

    monkeypatch.setattr(tlb, "_library", no_library)
    kw, msg = KERNEL_REJECTS[bad]
    with pytest.raises(ValueError, match=msg):
        tlb.lora_adapter_bwd(*_cuda_case(64, **kw))
