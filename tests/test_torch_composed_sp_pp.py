"""Sequence parallelism inside GPipe stages in the port (models/whisper.py::
encoder_apply under both ``seq_parallel_axis`` and ``pipeline_axis``),
alone, beside data parallelism and beside tensor parallelism, against the
JAX package's composition (``pipeline_scan(auto_axes=)`` with its ring
nested in the stages, GSPMD for the splits) under ``set_mesh`` on its
virtual 8-device mesh, in f32 on the CPU. The port's ranks are LocalRing
threads of the same grid (``LocalRing.run_mesh``):

- the teacher-forcing forward's loss within rtol 1e-5 and every leaf's
  gradient, summed as the training step sums them and gathered whole,
  within rtol / atol 2e-4 (tests/test_ring_attention.py's SP bound), the
  loss and gradients the same bits on every rank;
- greedy tokens under {pipe: 2, seq: 2} through ``generate_over_mesh``
  exactly equal to the JAX package's greedy decode under its mesh.

Geometry: tests/test_train.py's mini config at d_model 128, 2 heads, 2+2
layers and 256 source positions (1024 input samples, two 128-row shards),
batch 4. FSDP and tensor parallelism beside GPipe alone: tests/
test_torch_composed_split.py; FSDP beside SP: tests/test_torch_composed_
fsdp_seq.py; the training step, the optimizer's norm and the trainer:
tests/test_torch_composed_step.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.decode import generate as jgen
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.parallel.sharding import shard_params as jax_shard
from neuspeech1_tpu_torch.decode import generate as tgen
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.optimizer import named_leaves
from tests.test_torch_tensor_parallel import _port_leaves
from tests.test_torch_whisper import port
from tests.test_train import mini_cfg

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL = 1e-5, 2e-4
STEM = StemConfig("base", in_channels=6)
BATCH = 4
SPLIT_AXES = ("fsdp", "tensor")


def config(**kw):
    return mini_cfg(d_model=128, encoder_heads=2, decoder_heads=2,
                    max_source_positions=256, max_target_positions=16, **kw)


def composed(cfg, axes):
    """``cfg`` with ``seq_parallel_axis`` and ``pipeline_axis`` set where
    ``axes`` (mesh sizes by name) has a ``seq`` or a ``pipe`` axis."""
    return dataclasses.replace(
        cfg, seq_parallel_axis="seq" if "seq" in axes else None,
        pipeline_axis="pipe" if "pipe" in axes else None)


def jax_mesh(axes):
    n = math.prod(axes.values())
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def inputs(cfg, seed=0):
    params = jax.device_get(init_params(jax.random.key(0), cfg, STEM))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (BATCH, STEM.in_channels, 4 * cfg.max_source_positions)
    ).astype(np.float32)
    dec_in = rng.integers(0, 60, (BATCH, 8)).astype(np.int32)
    return params, feats, dec_in


def _loss(out):
    return jnp.sum(out.astype(jnp.float32) ** 2) / out.size


def jit_composes(axes) -> bool:
    """Whether the JAX package's composition on ``axes`` may run under
    ``jax.jit``. Jitted with FSDP-split weights beside its ring, it does
    not compute the forward it runs eagerly: at this geometry the encoder
    states under {fsdp: 2, seq: 2} come out 0.0154 (of 3.23) from the
    one-device encoder's, the loss 1.6e-5 (5.0e-5 with tensor) relative
    from it, where the eager composition is within 7.2e-7 and 1.4e-7.
    There the gold runs eagerly (about 30 s against 10)."""
    return not {"fsdp", "seq"} <= set(axes)


def jax_gold(cfg, params, feats, dec_in, axes):
    """The JAX package's composition on ``axes`` under ``set_mesh`` (jitted
    where `jit_composes`): the forward's loss and every leaf's gradient by
    the port's paths."""
    c = composed(cfg, axes)
    mesh = jax_mesh(axes)

    def loss(p):
        return _loss(jw.forward(p, jnp.asarray(feats), jnp.asarray(dec_in),
                                c, STEM))

    grad_fn = jax.value_and_grad(loss)
    with jax.sharding.set_mesh(mesh):
        p = (jax_shard(mesh, params) if set(SPLIT_AXES) & set(axes)
             else params)
        val, grads = (jax.jit(grad_fn) if jit_composes(axes) else grad_fn)(p)
    return float(val), _port_leaves(jax.device_get(grads), "model")


def split_model(params, tcfg, requires_grad=True):
    """The port's f32 model of ``params``, split over the ambient mesh's
    fsdp and tensor axes (whole without them)."""
    model = module_from_params(params, tcfg, port(STEM), device="cpu",
                               dtype=torch.float32)
    return sharding.shard_params(model.requires_grad_(requires_grad))


def port_grads(cfg, params, feats, dec_in, axes):
    """Per grid rank: the port's loss over the global batch and every
    leaf's gradient, reduced as the training step reduces them
    (`reduce_grads`) and gathered whole."""
    tcfg = port(composed(cfg, axes))

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            model = split_model(params, tcfg)
            shard = pmesh.batch_sharding()
            out = tw.forward(model, shard.shard(torch.from_numpy(feats)),
                             shard.shard(torch.from_numpy(dec_in).long()))
            loss = (out.float() ** 2).sum() / (out.numel() * shard.count)
            loss.backward()
            aux = {"ce_loss": loss.detach()}
            specs = sharding.leaf_specs(model)
            grads = tts.reduce_grads(
                named_leaves(model), tcfg, pmesh.data_ring(), aux,
                fsdp=pmesh.fsdp_ring(), tensor=pmesh.tensor_ring(),
                specs=specs)
            whole = {k: (sharding.gather_leaf(g, specs[k]) if k in specs
                         else g).numpy() for k, g in grads.items()}
        return float(aux["ce_loss"]), whole

    return LocalRing.run_mesh(rank, **axes)


def check_grads(runs, ref_loss, ref_grads):
    """Every rank's loss and gradients the same bits, within the bounds of
    the JAX composition's."""
    for loss, grads in runs:
        assert loss == runs[0][0]
        for k, g in grads.items():
            np.testing.assert_array_equal(g, runs[0][1][k], err_msg=k)
    assert runs[0][0] == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert set(runs[0][1]) == set(ref_grads)
    for k, g in runs[0][1].items():
        np.testing.assert_allclose(g, ref_grads[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.fixture(scope="module")
def setup():
    cfg = config()
    return (cfg, *inputs(cfg))


MESHES = [{"pipe": 2, "seq": 2}, {"data": 2, "pipe": 2, "seq": 2},
          {"tensor": 2, "pipe": 2, "seq": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "_".join(a))
def test_forward_and_gradients_match_the_jax_composition(setup, axes):
    cfg, params, feats, dec_in = setup
    ref_loss, ref_grads = jax_gold(cfg, params, feats, dec_in, axes)
    check_grads(port_grads(cfg, params, feats, dec_in, axes), ref_loss,
                ref_grads)


def test_greedy_under_pipe_and_seq_matches_jax(setup):
    """The serving encoder under {pipe: 2, seq: 2} (the cached decoder
    leaves the pipeline axis out, as the JAX package's does): every rank's
    tokens equal to the JAX package's greedy decode under its mesh."""
    cfg, params, feats, _ = setup
    axes = {"pipe": 2, "seq": 2}
    c = composed(cfg, axes)
    prompt = np.tile(np.asarray([[cfg.sot_id]], np.int32), (BATCH, 1))
    gen = jgen.GenerationConfig(max_length=8)
    with jax.sharding.set_mesh(jax_mesh(axes)):
        ref = np.asarray(jgen.greedy_decode(
            params, jnp.asarray(feats), jnp.asarray(prompt), c, STEM, gen))

    tcfg = port(c)

    def rank(mesh):
        with pmesh.set_mesh(mesh), torch.no_grad():
            model = split_model(params, tcfg, requires_grad=False)
            return tgen.generate_over_mesh(
                model, torch.from_numpy(feats),
                torch.from_numpy(prompt).long(),
                tgen.GenerationConfig(max_length=8)).numpy()

    for tokens in LocalRing.run_mesh(rank, **axes):
        np.testing.assert_array_equal(tokens, ref)


def test_transcriber_under_pipe_and_seq_equals_one_rank(tmp_path):
    """``Transcriber(mesh=)`` on a model whose config names the mesh's
    ``seq`` and ``pipe`` axes: the encoder pass over both (100 frames
    padded to 256 and sharded, one layer a stage), every rank's texts and
    token timestamps (one rank's pass on the whole weights) those of a
    Transcriber without a mesh, at tests/test_torch_decode.py's geometry
    (a byte vocabulary, weights that make the tokens depend on the
    input)."""
    import json

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.serve import Transcriber
    from tests.test_torch_decode import scaled_params, tiny

    cfg, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(cfg, stem)
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)

    def model_dir(name, **axes):
        out = common.save_full_model(str(tmp_path / name), params, port(cfg),
                                     port(stem))
        with open(f"{out}/config.json") as f:
            meta = json.load(f)
        meta["config"].update(dtype="float32", flash_attention="on", **axes)
        with open(f"{out}/config.json", "w") as f:
            json.dump(meta, f)
        return out

    kw = dict(batch_size=2, max_new_tokens=8, device="cpu")
    one = Transcriber(model_dir("one"), **kw)
    ref = one.transcribe(signals), one.transcribe_with_timestamps(
        signals[:1])
    composed_dir = model_dir("composed", seq_parallel_axis="seq",
                             pipeline_axis="pipe")

    def rank(mesh):
        tr = Transcriber(composed_dir, mesh=mesh, **kw)
        return tr.transcribe(signals), tr.transcribe_with_timestamps(
            signals[:1])

    for got in LocalRing.run_mesh(rank, pipe=2, seq=2):
        assert got == ref
