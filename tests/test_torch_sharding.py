"""The port's weight splits (neuspeech1_tpu_torch/parallel/sharding.py)
against the JAX package's ``param_specs`` (neuspeech1_tpu/parallel/
sharding.py), leaf by leaf after the layout translation (JAX stacks layers
on a leading [L] axis and stores linears [d_in, d_out]; the port keeps one
module per layer and ``nn.Linear``'s [d_out, d_in]), and the split itself
on LocalRing threads of a {data: 2, fsdp: 2, tensor: 2} mesh: block
shapes, local heads, shard -> gather bit for bit, and checkpoints that hold
whole tensors and resume on another mesh."""

import copy
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.parallel.sharding import param_specs as jax_param_specs
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager
from neuspeech1_tpu_torch.train.optimizer import named_leaves
from tests.test_torch_whisper import port
from tests.test_train import mini_cfg

torch.set_num_threads(1)

STEM = StemConfig("base", in_channels=6)
MESH = {"data": 2, "fsdp": 2, "tensor": 2}


@pytest.fixture(scope="module")
def weights():
    config = mini_cfg()
    params = jax.device_get(init_params(jax.random.key(0), config, STEM))
    lora = jax.device_get(init_lora(jax.random.key(1), config, rank=4,
                                    alpha=8.0, adalora=True))
    return config, params, lora


def _model(config, params):
    return module_from_params(params, port(config), port(STEM), device="cpu",
                              dtype=torch.float32)


def _jax_specs_by_port_path(params, lora):
    """JAX's spec of every leaf, keyed by the port's leaf paths and
    translated to the port's layout: the [L] axis's entry dropped, a
    linear weight's two entries swapped."""
    out = {}

    def walk(node, spec, prefix, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{prefix}/{k}", stacked or k == "layers")
            return
        entries = tuple(spec) + (None,) * (node.ndim - len(tuple(spec)))
        if stacked:
            entries = entries[1:]
        if prefix.endswith("/w") and len(entries) == 2:
            entries = entries[::-1]  # [d_in, d_out] -> [d_out, d_in]
        if not stacked:
            out[prefix] = entries
            return
        head, tail = prefix.split("/layers/", 1)
        for i in range(node.shape[0]):
            out[f"{head}/layers/{i}/{tail}"] = entries

    walk(params, jax_param_specs(params), "model", False)
    walk(lora, jax_param_specs(lora), "lora", False)
    return out


def test_every_leaf_takes_the_jax_spec(weights):
    config, params, lora = weights
    model = _model(config, params)
    ours = sharding.param_specs(model, lora_from_params(lora, device="cpu"))
    ref = _jax_specs_by_port_path(params, lora)
    assert set(ours) == set(ref)
    for path, spec in ref.items():
        assert ours[path] == spec, path
    split = {p for p, s in ours.items() if any(s)}
    # every linear of both stacks (its weight, a column-parallel bias) and
    # the embedding; nothing of the stem, conv2, norms or adapters
    assert "model/decoder/token_embed" in split
    assert "model/encoder/layers/1/self_attn/out/w" in split
    assert "model/decoder/layers/0/cross_attn/k/w" in split
    assert not any(p.startswith("lora/") or "stem" in p or "ln" in p
                   for p in split)


def test_restrict_spec_drops_missing_and_single_axes():
    mesh = {"fsdp": SimpleNamespace(size=2, rank=0),
            "tensor": SimpleNamespace(size=1, rank=0)}
    assert sharding.restrict_spec(("tensor", "fsdp"), mesh) == (None, "fsdp")
    assert sharding.restrict_spec(("fsdp", "tensor"), {}) == (None, None)


def test_shard_then_gather_is_the_same_bits(weights):
    """Each rank's blocks have the split shapes and the local heads; the
    gathered model is the whole one bit for bit, on every rank."""
    config, params, _ = weights
    whole = _model(config, params)
    ref = {k: t.clone() for k, t in named_leaves(whole).items()}
    d, ffn, vocab = config.d_model, config.encoder_ffn, config.vocab_size

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            model = sharding.shard_params(copy.deepcopy(whole))
            leaves = named_leaves(model)
            shapes = {k: tuple(leaves[k].shape) for k in (
                "model/encoder/layers/0/self_attn/q/w",
                "model/encoder/layers/0/self_attn/q/b",
                "model/encoder/layers/0/self_attn/out/w",
                "model/encoder/layers/0/self_attn/out/b",
                "model/encoder/layers/0/fc1/w", "model/encoder/layers/0/fc2/w",
                "model/decoder/token_embed", "model/encoder/pos_embed")}
            heads = model.encoder.layers[0].n_heads
            back = named_leaves(sharding.gather_params(model))
            return shapes, heads, {k: t.clone() for k, t in back.items()}

    runs = LocalRing.run_mesh(rank, **MESH)
    for shapes, heads, back in runs:
        assert shapes == {
            "model/encoder/layers/0/self_attn/q/w": (d // 2, d // 2),
            "model/encoder/layers/0/self_attn/q/b": (d // 2,),
            "model/encoder/layers/0/self_attn/out/w": (d // 2, d // 2),
            "model/encoder/layers/0/self_attn/out/b": (d,),
            "model/encoder/layers/0/fc1/w": (ffn // 2, d // 2),
            "model/encoder/layers/0/fc2/w": (d // 2, ffn // 2),
            "model/decoder/token_embed": (vocab, d // 2),
            "model/encoder/pos_embed": (config.max_source_positions, d)}
        assert heads == config.encoder_heads // 2
        assert set(back) == set(ref)
        for k, t in ref.items():
            assert torch.equal(back[k], t), k


def test_checkpoint_holds_whole_tensors_and_resumes_on_another_mesh(
        weights, tmp_path):
    """--ft_full state saved under {fsdp: 2, tensor: 2}: the file's
    tensors have the one-rank shapes and values; restored under {tensor: 2}
    each rank holds its blocks of them, moments included."""
    config, params, _ = weights
    ckdir = str(tmp_path / "ck")

    def state_on():
        """This rank's state under the ambient mesh."""
        model = sharding.shard_params(_model(config, params))
        tx = topt.make_optimizer()
        state, _ = tts.init_train_state(
            model, None, tx, topt.default_trainable_pred(ft_full=True))
        with torch.no_grad():  # moments that differ per leaf
            for k, t in state.opt_state.mu.items():
                t.copy_(state.trainable[k] * 2)
        state.step = 3
        mgr = CheckpointManager(ckdir, writer=pmesh.is_first(),
                                specs=sharding.leaf_specs(model))
        return model, state, mgr

    def save(mesh):
        with pmesh.set_mesh(mesh):
            _, state, mgr = state_on()
            assert mgr.save(state, force=True)
            mgr.wait()
            pmesh.barrier()

    LocalRing.run_mesh(save, fsdp=2, tensor=2)
    saved = torch.load(os.path.join(ckdir, "3", "state.pt"),
                       weights_only=True)
    whole = named_leaves(_model(config, params))
    assert set(saved["trainable"]) == set(whole)
    for k, t in whole.items():
        assert torch.equal(saved["trainable"][k], t), k
        assert torch.equal(saved["opt_state"]["mu"][k], t * 2), k

    def restore(mesh):
        with pmesh.set_mesh(mesh):
            model, state, mgr = state_on()
            with torch.no_grad():
                for t in list(state.trainable.values()) + list(
                        state.opt_state.mu.values()):
                    t.zero_()
            mgr.restore_latest(state)
            specs = sharding.leaf_specs(model)
            return {k: (sharding.shard_leaf(whole[k], specs[k])
                        if k in specs else whole[k], t,
                        state.opt_state.mu[k])
                    for k, t in state.trainable.items()}

    for blocks in LocalRing.run_mesh(restore, tensor=2):
        for k, (want, got, mu) in blocks.items():
            assert torch.equal(got, want), k
            assert torch.equal(mu, want * 2), k
