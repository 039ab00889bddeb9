"""Tensor parallelism in the port (neuspeech1_tpu_torch/parallel/sharding.py
through models/whisper.py) against the JAX package's GSPMD placement
(tests/test_train.py's test_tensor_parallel_forward_matches), in f32 on the
CPU at its mini geometry, the port's ranks as LocalRing threads of a
{data: 2, tensor: 2} mesh (JAX's: data 4 x tensor 2 on its 8 virtual
devices):

- the teacher-forcing logits within rtol 1e-4 / atol 2e-4;
- every leaf's gradient (the whole model and every adapter leaf, on the
  per-token delta path; the adapters, stem and conv2 on the fold, whose
  fc adapters run K3's plain version at the local shapes), summed as the
  training step sums them and gathered whole, within the same bound.
The fine-tune CLI under tensor parallelism: tests/test_torch_sharded_cli.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.parallel.mesh import batch_sharding, make_mesh
from neuspeech1_tpu.parallel.sharding import shard_params as jax_shard
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_step_options import _torch_batch
from tests.test_torch_whisper import port
from tests.test_train import make_batch, mini_cfg

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
STEM = StemConfig("base", in_channels=6)
MESH = {"data": 2, "tensor": 2}


@pytest.fixture(scope="module")
def setup():
    config = mini_cfg()
    params = jax.device_get(init_params(jax.random.key(0), config, STEM))
    lora = jax.device_get(init_lora(jax.random.key(1), config, rank=4,
                                    alpha=8.0, adalora=True))
    rng = np.random.default_rng(3)
    # adapters at a trained magnitude, so that every factor has a gradient
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key in ("E", "B") else np.asarray(x), lora)
    batch = jax.device_get(make_batch(config, STEM, b=4))
    return config, params, lora, batch


def _on_mesh(fn):
    """``fn()`` on every rank of MESH under its ambient mesh."""
    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return fn()
    return LocalRing.run_mesh(rank, **MESH)


def _model(config, params):
    return module_from_params(params, port(config), port(STEM), device="cpu",
                              dtype=torch.float32)


def test_forward_matches_the_jax_tensor_mesh(setup):
    config, params, _, batch = setup
    mesh = make_mesh(data=4, tensor=2)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                        batch_sharding(mesh))
    ref = np.asarray(jax.jit(lambda p, b: jw.forward(
        p, b["input_features"], b["decoder_input_ids"], config, STEM))(
            jax_shard(mesh, params), jb))
    whole = _model(config, params)
    tb = _torch_batch(batch)

    def run():
        model = sharding.shard_params(copy.deepcopy(whole))
        shard = pmesh.batch_sharding()
        with torch.no_grad():
            return tw.forward(model, shard.shard(tb["input_features"]),
                              shard.shard(tb["decoder_input_ids"]))

    outs = _on_mesh(run)
    # data-major: ranks 0 and 2 hold the two row blocks
    np.testing.assert_allclose(torch.cat([outs[0], outs[2]]).numpy(), ref,
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])


def _port_leaves(tree, prefix):
    """A JAX-layout tree's leaves by the port's paths: stacked layers split
    per layer, linear weights transposed to [d_out, d_in]."""
    out = {}

    def walk(node, path, stacked):
        if node is None:  # a frozen leaf of JAX's trainable partition
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}", stacked or k == "layers")
            return
        node = np.asarray(node)
        per = ([(path, node)] if not stacked else
               [(path.replace("/layers/", f"/layers/{i}/", 1), node[i])
                for i in range(node.shape[0])])
        for p, x in per:
            out[p] = x.T if p.endswith("/w") and x.ndim == 2 else x

    walk(tree, prefix, False)
    return out


@pytest.mark.parametrize("fold", [False, True])
def test_every_gradient_matches_jax(setup, fold):
    """The delta path with every leaf trainable, and the fold with the
    reference's trainable set, the gradients after the step's reductions
    (adapters over 'tensor', every leaf over 'data'), gathered whole."""
    config, params, lora, batch = setup
    jpred = jopt.default_trainable_pred(ft_full=not fold)
    state, frozen = jts.init_train_state(
        jax.random.key(2), params, lora, jopt.make_optimizer(), jpred)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jts.make_loss_fn(config, STEM, 0.0, fold_lora=fold)
    jgrads, _ = jax.grad(loss_fn, has_aux=True)(state.trainable, frozen, jb,
                                                None)
    ref = {**_port_leaves(jgrads.get("model", {}), "model"),
           **_port_leaves(jgrads.get("lora", {}), "lora")}
    whole = _model(config, params)
    tb = _torch_batch(batch)
    tconfig = port(config)

    def run():
        model = sharding.shard_params(copy.deepcopy(whole))
        tstate, tfrozen = tts.init_train_state(
            model, lora_from_params(lora, device="cpu"), topt.make_optimizer(),
            topt.default_trainable_pred(ft_full=not fold))
        shard = pmesh.batch_sharding()
        rows = {k: shard.shard(v) for k, v in tb.items()}
        n_tokens = pmesh.data_ring().all_reduce_sum(
            (rows["labels"] != -100).sum())
        loss, aux = tts.make_loss_fn(tconfig, port(STEM), fold_lora=fold)(
            tfrozen, rows, n_tokens=n_tokens)
        loss.backward()
        specs = sharding.leaf_specs(model)
        grads = tts.reduce_grads(tstate.trainable, tconfig,
                                 pmesh.data_ring(), aux,
                                 tensor=pmesh.tensor_ring(), specs=specs)
        return {k: (sharding.gather_leaf(g, specs[k]) if k in specs else g
                    ).numpy() for k, g in grads.items()}

    runs = _on_mesh(run)
    got = runs[0]
    assert set(got) == {k for k in ref if not k.endswith(("alpha", "mask"))}
    for k, g in got.items():
        np.testing.assert_allclose(g, ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        for other in runs[1:]:
            np.testing.assert_array_equal(other[k], g, err_msg=k)
