"""GPipe pipeline parallelism in the port (neuspeech1_tpu_torch/parallel/
pipeline.py and ``pipeline_axis`` in models/whisper.py) against the JAX
package's ``pipeline_scan`` and ``pipeline_axis`` model (tests/
test_pipeline.py), in f32 on the CPU, the stages as LocalRing threads on a
{data: 2, pipe: 4} grid (``LocalRing.run_mesh``):

- the toy stack: forward bit for bit equal to the plain loop and within
  1e-6 of JAX's ``pipeline_scan``, gradients within JAX's bound (1e-5),
  with 4 and 8 microbatches; the constraints' ValueErrors;
- the model with both stacks pipelined (4 layers over 4 stages, each data
  rank on its half of the batch): loss within rtol 1e-6 and every
  parameter's gradient within rtol/atol 2e-5 of JAX's pipelined model;
- the same with LoRA adapters on both stacks and remat of the encoder;
- the schedule's bodies (``pipeline_fwd``/``pipeline_bwd``, which
  chip_smoke.py runs on the card) against the autograd wrapper."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.parallel.pipeline import pipeline_scan
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import (
    lora_from_params, module_from_params, params_from_lora,
    params_from_module)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.pipeline import (
    pipeline, pipeline_bwd, pipeline_fwd, stage_layers)
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.optimizer import named_leaves
from tests.test_pipeline import _body, _mesh, _toy
from tests.test_torch_whisper import port
from tests.test_train import mini_cfg

torch.set_num_threads(1)

GRID = {"data": 2, "pipe": 4}
# tests/test_pipeline.py's bounds
TOY_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-6, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _toy_body(h, xs, cst):
    return torch.tanh(h @ xs["w"] + xs["b"] + cst)


def _toy_port(ws, bs, x, c, microbatches=None):
    """Per grid rank: this data rank's rows of the pipelined toy's output
    and their gradients, and the stage leaves' gradients."""
    def rank(mesh):
        data, pipe = mesh["data"], mesh["pipe"]
        rows = x.shape[0] // data.size
        sl = slice(data.rank * rows, (data.rank + 1) * rows)
        w, b = _t(ws).requires_grad_(), _t(bs).requires_grad_()
        h = _t(x)[sl].requires_grad_()
        xs = [{"w": w[i], "b": b[i]} for i in range(w.shape[0])]
        o = pipeline(_toy_body, xs, h, pipe, microbatches, consts=(_t(c),))
        (o ** 2).sum().backward()
        return sl, o.detach(), h.grad, w.grad, b.grad
    return LocalRing.run_mesh(rank, **GRID)


def _toy_plain(ws, bs, x, c):
    w, b = _t(ws).requires_grad_(), _t(bs).requires_grad_()
    h = _t(x).requires_grad_()
    o = h
    for i in range(w.shape[0]):
        o = _toy_body(o, {"w": w[i], "b": b[i]}, _t(c))
    (o ** 2).sum().backward()
    return o.detach(), h.grad, w.grad, b.grad


@pytest.mark.parametrize("microbatches", [None, 8])
def test_toy_pipeline_matches_plain_loop_and_jax(microbatches):
    ws, bs, x, c = _toy()
    ref = np.asarray(pipeline_scan(_body, (ws, bs), x, _mesh(), "pipe",
                                   num_microbatches=microbatches,
                                   batch_axes="data", consts=(c,)))
    plain = _toy_plain(ws, bs, x, c)
    # 8 microbatches over each data rank's 8 rows: one row each
    for sl, o, *_ in _toy_port(ws, bs, x, c, microbatches):
        torch.testing.assert_close(o, plain[0][sl], rtol=0, atol=0)
        np.testing.assert_allclose(o.numpy(), ref[sl], rtol=1e-6, atol=1e-6)


def test_toy_pipeline_grads_match_jax():
    ws, bs, x, c = _toy(seed=3)

    def loss_pp(ws, bs, x):
        o = pipeline_scan(_body, (ws, bs), x, _mesh(), "pipe",
                          batch_axes="data", consts=(c,))
        return jnp.sum(o ** 2)

    g_ref = jax.grad(loss_pp, argnums=(0, 1, 2))(ws, bs, x)
    runs = _toy_port(ws, bs, x, c)
    dw = sum(r[3] for r in runs)
    db = sum(r[4] for r in runs)
    dx = torch.zeros(x.shape)
    for sl, _, gx, _, _ in runs:
        dx[sl] = gx
    for got, ref in zip((dw, db, dx), g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=TOY_TOL, atol=TOY_TOL)


def test_pipeline_constraints():
    """The JAX package's ValueErrors: depth not divisible by the stages,
    batch not divisible by the microbatches."""
    def run(n_layers, b):
        ws, bs, x, c = _toy(n_layers=n_layers, b=b)

        def rank(ring):
            xs = [{"w": _t(ws)[i], "b": _t(bs)[i]} for i in range(n_layers)]
            return pipeline(_toy_body, xs, _t(x), ring, consts=(_t(c),))
        return LocalRing.run(rank, 4)

    with pytest.raises(ValueError, match="layers not divisible"):
        run(6, 16)
    with pytest.raises(ValueError, match="microbatches"):
        run(8, 6)


def test_bodies_equal_the_autograd_wrapper():
    """pipeline_fwd then pipeline_bwd, called directly in each rank's
    thread as chip_smoke.py does on the card, without the autograd
    wrapper: the plain loop's output bit for bit and its gradients."""
    ws, bs, x, c = _toy(seed=4)

    def rank(ring):
        w, b = _t(ws).requires_grad_(), _t(bs).requires_grad_()
        xs = stage_layers([{"w": w[i], "b": b[i]}
                           for i in range(w.shape[0])], ring)
        h = _t(x)
        o, saved = pipeline_fwd(_toy_body, xs, h, ring, 4, (_t(c),))
        dh, _, dleaves = pipeline_bwd(saved, 2 * o)
        return o, dh, dleaves

    direct = LocalRing.run(rank, 4)
    plain = _toy_plain(ws, bs, x, c)
    for r, (o, dh, dleaves) in enumerate(direct):
        torch.testing.assert_close(o, plain[0], rtol=0, atol=0)
        torch.testing.assert_close(dh, plain[1], rtol=1e-6, atol=1e-6)
        # this stage's two layers, w then b of each, in flatten order
        for i in range(2):
            for j, ref in enumerate((plain[2], plain[3])):
                torch.testing.assert_close(dleaves[2 * i + j],
                                           ref[2 * r + i], rtol=TOY_TOL,
                                           atol=TOY_TOL)


# --------------------------------------------------------------------------
# the model with pipeline_axis
# --------------------------------------------------------------------------

def _model_inputs():
    cfg = mini_cfg(encoder_layers=4, decoder_layers=4)
    stem = StemConfig("base", in_channels=6)
    params = jax.device_get(init_params(jax.random.key(0), cfg, stem))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 6, 64)).astype(np.float32)
    dec_in = rng.integers(0, 60, (8, 8)).astype(np.int32)
    return cfg, stem, params, feats, dec_in


def _jax_ref(cfg, stem, params, feats, dec_in, lora=None):
    """JAX's pipelined model on the {data: 2, pipe: 4} mesh: the loss and
    the gradients of the weights (and adapters)."""
    cfg_pp = dataclasses.replace(cfg, pipeline_axis="pipe")

    def loss(p, l):
        out = jw.forward(p, jnp.asarray(feats), jnp.asarray(dec_in), cfg_pp,
                         stem, lora=l)
        return jnp.sum(out.astype(jnp.float32) ** 2) / out.size

    with jax.sharding.set_mesh(_mesh(pipe=4, data=2)):
        val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            params, lora)
    return float(val), jax.device_get(grads)


def _port_pp(cfg, stem, params, feats, dec_in, lora=None):
    """The port's pipelined model per grid rank: the loss over the global
    batch and the gradient trees (JAX layout), summed over both rings."""
    tcfg = port(dataclasses.replace(cfg, pipeline_axis="pipe"))

    def rank(mesh):
        model = module_from_params(params, tcfg, port(stem), device="cpu",
                                   dtype=torch.float32).requires_grad_(True)
        t_lora = None
        if lora is not None:
            t_lora = lora_from_params(lora, device="cpu")
            for _, t in _named(t_lora):
                t.requires_grad_(_ in ("A", "B"))
        shard = pmesh.batch_sharding(mesh)
        with pmesh.set_mesh(mesh):
            out = tw.forward(model, shard.shard(_t(feats)),
                             shard.shard(_t(dec_in).long()), t_lora)
            loss = (out.float() ** 2).sum() / (out.numel() * shard.count)
            loss.backward()
            leaves = named_leaves(model, t_lora)
            trainable = {k: t for k, t in leaves.items() if t.requires_grad}
            aux = {"ce_loss": loss.detach()}
            grads = tts.reduce_grads(trainable, tcfg, pmesh.data_ring(), aux)
        gmodel = copy.deepcopy(model)
        for (k, p), (_, gp) in zip(named_leaves(model).items(),
                                   named_leaves(gmodel).items()):
            gp.data = grads[k].detach().clone()
        g_lora = None
        if t_lora is not None:
            g_lora = params_from_lora(_grad_tree(t_lora, leaves, grads))
        return float(aux["ce_loss"]), params_from_module(gmodel), g_lora

    return LocalRing.run_mesh(rank, **GRID)


def _named(tree, name=None):
    """(key, tensor) for every tensor of an adapter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named(v, name)
    else:
        yield name, tree


def _grad_tree(t_lora, leaves, grads):
    """The adapter tree with each trainable tensor replaced by its summed
    gradient (zeros for alpha and mask)."""
    by_id = {id(t): k for k, t in leaves.items()}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        k = by_id[id(node)]
        return grads[k] if k in grads else torch.zeros_like(node)
    return walk(t_lora)


def _check_model(runs, ref_loss, ref_grads, ref_lora=None):
    for loss, g, g_lora in runs:
        assert loss == runs[0][0]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g),
                                jax.tree_util.tree_leaves(ref_grads)):
            np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=jax.tree_util.keystr(path))
        if ref_lora is not None:
            for (path, a), b in zip(
                    jax.tree_util.tree_leaves_with_path(g_lora),
                    jax.tree_util.tree_leaves(ref_lora)):
                np.testing.assert_allclose(
                    a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                    err_msg=jax.tree_util.keystr(path))


def test_model_pipeline_matches_jax():
    cfg, stem, params, feats, dec_in = _model_inputs()
    ref_loss, (ref_grads, _) = _jax_ref(cfg, stem, params, feats, dec_in)
    _check_model(_port_pp(cfg, stem, params, feats, dec_in), ref_loss,
                 ref_grads)


def test_model_pipeline_with_lora_and_remat_matches_jax():
    """Adapters on both stacks ride the stages as per-layer leaves; the
    encoder's stages run each layer under remat (policy 'flash_qkv')."""
    cfg, stem, params, feats, dec_in = _model_inputs()
    cfg = dataclasses.replace(cfg, remat=True, remat_policy="flash_qkv")
    lora = jax.device_get(init_lora(jax.random.key(1), cfg, rank=4, alpha=8,
                                    parts=("encoder", "decoder")))
    rng = np.random.default_rng(6)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "B" else np.asarray(x), lora)
    ref_loss, (ref_grads, ref_lora) = _jax_ref(cfg, stem, params, feats,
                                               dec_in, lora)
    runs = _port_pp(cfg, stem, params, feats, dec_in, lora)
    ref_lora = {part: {"layers": {k: v for k, v in sub["layers"].items()}}
                for part, sub in ref_lora.items()}
    _check_model(runs, ref_loss, ref_grads, ref_lora)
