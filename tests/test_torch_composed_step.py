"""The port's training step and trainer under compositions of the mesh's
parallel axes, in f32 on the CPU, the ranks as LocalRing threads; helpers
and geometry: tests/test_torch_composed_sp_pp.py.

- One LoRA 'fc' step (the fold, adapters, stem and conv2 trainable) under
  {tensor: 2, pipe: 2, seq: 2}, {fsdp: 2, tensor: 2, pipe: 2} and {fsdp: 2,
  seq: 2} against
  the JAX package's step under ``set_mesh`` on weights placed by its
  ``shard_params``: the loss within rtol 1e-5, the pre-clip gradient norm
  (each leaf counted once: stage leaves after the pipe sum, the encoder's
  after the seq sum, FSDP shards summed over fsdp) within rtol / atol
  2e-4, the updated leaves within rtol 1e-4 / atol 2e-4 where the two
  gradients settle AdamW's first update alike, the gradients within rtol /
  atol 2e-4 of the port's one-rank step's, and the same bits on every
  rank. Where the JAX package's jitted step on the mesh departs from its
  own one-device step (`jax_step_composes`), the gold is the one-device
  step.
- The trainer under {fsdp: 2, pipe: 2} with every leaf trainable (the
  fine-tune CLI's --ft_full): 4 steps in one run equal 2 steps, a save, a
  resume and 2 more, bit for bit on every rank; the checkpoint holds whole
  tensors.
- The batch's rows are split over data x fsdp only: ranks of a pipe, seq
  or tensor ring share them."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu.parallel.mesh import batch_sharding as jax_rows
from neuspeech1_tpu.parallel.sharding import shard_params as jax_shard
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models.convert import lora_from_params
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager
from neuspeech1_tpu_torch.train.trainer import Trainer
from tests.test_torch_composed_sp_pp import (
    BATCH, STEM, composed, config, inputs, jax_mesh, jit_composes,
    split_model)
from tests.test_torch_step_options import _torch_batch
from tests.test_torch_tensor_parallel import _port_leaves
from tests.test_torch_whisper import port
from tests.test_train import make_batch

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL, RTOL, ATOL = 1e-5, 2e-4, 1e-4, 2e-4
NORM_REL = 1e-3
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=None)


@pytest.fixture(scope="module")
def setup():
    cfg = config()
    params = inputs(cfg)[0]
    lora = jax.device_get(init_lora(jax.random.key(1), cfg, rank=4,
                                    alpha=8.0))
    rng = np.random.default_rng(6)
    # B at a trained magnitude, so that A takes a gradient too
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "B" else np.asarray(x), lora)
    batch = jax.device_get(make_batch(cfg, STEM, b=BATCH))
    return cfg, params, lora, batch


def jax_step_composes(axes) -> bool:
    """Whether the JAX package's jitted step on ``axes`` computes its own
    one-device step. Beside FSDP its ring does not (`jit_composes`), nor
    does its step with the ring inside pipeline stages: at this geometry
    the pre-clip gradient norm is 0.6559 under {pipe: 2, seq: 2} and
    0.7666 under {tensor: 2, pipe: 2, seq: 2} against 0.6252 on one device
    (the loss is the same bits), where its forward's gradients under
    {pipe: 2, seq: 2} are within 6.8e-6 of one device's
    (tests/test_torch_composed_sp_pp.py)."""
    return jit_composes(axes) and not {"pipe", "seq"} <= set(axes)


def _jax_step(cfg, params, lora, batch, axes=None):
    """One JAX step of the fold: its metrics, the gradients it takes (from
    the step's loss function) and the trainable leaves after it, by the
    port's paths; on ``axes``'s mesh where given."""
    tx = jopt.make_optimizer(**OPT)
    c = cfg if axes is None else composed(cfg, axes)
    step = jts.make_train_step(c, STEM, tx, fold_lora=True, donate=False)
    grad_fn = jax.jit(jax.grad(jts.make_loss_fn(c, STEM, 0.0, fold_lora=True),
                               has_aux=True))
    pred = jopt.default_trainable_pred()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = None if axes is None else jax_mesh(axes)
    with (jax.sharding.set_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        if mesh is not None:
            params, lora = jax_shard(mesh, params), jax_shard(mesh, lora)
            jb = jax.device_put(jb, jax_rows(mesh))
        state, frozen = jts.init_train_state(jax.random.key(2), params, lora,
                                             tx, pred)
        grads, _ = grad_fn(state.trainable, frozen, jb, None)
        state, m = step(state, frozen, jb)

    def by_path(tree):
        tree = jax.device_get(tree)
        return {**_port_leaves(tree.get("model", {}), "model"),
                **_port_leaves(tree.get("lora", {}), "lora")}

    return ({k: float(v) for k, v in m.items()}, by_path(grads),
            by_path(state.trainable))


def _port_step(cfg, params, lora, batch, axes):
    """Per grid rank: the port's step on its rows of the batch: its
    metrics, the gradients it hands the optimizer and the trainable leaves
    after it (split ones gathered whole)."""
    tcfg = port(composed(cfg, axes))

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            model = split_model(params, tcfg, requires_grad=False)
            tx = topt.make_optimizer(**OPT)
            state, frozen = tts.init_train_state(
                model, lora_from_params(lora, device="cpu"), tx)
            step = tts.make_train_step(tcfg, port(STEM), tx, fold_lora=True)
            seen = {}
            update = tx.update

            def record(params, grads, *a, **kw):
                seen.update(grads)
                return update(params, grads, *a, **kw)

            tx.update = record
            rows = pmesh.batch_sharding()
            m = step(state, frozen, {k: rows.shard(v) for k, v in
                                     _torch_batch(batch).items()})
            specs = sharding.leaf_specs(model)

            def whole(tensors):
                return {k: (sharding.gather_leaf(t.detach(), specs[k])
                            if k in specs else t.detach()).numpy().copy()
                        for k, t in tensors.items()}

            out = whole(seen), whole(state.trainable)
        return ({k: float(v) for k, v in m.items()}, *out)

    return LocalRing.run_mesh(rank, **axes)


STEP_MESHES = [{"tensor": 2, "pipe": 2, "seq": 2},
               {"fsdp": 2, "tensor": 2, "pipe": 2}, {"fsdp": 2, "seq": 2}]


@pytest.mark.parametrize("axes", STEP_MESHES, ids=lambda a: "_".join(a))
def test_step_matches_jax(setup, axes):
    """Against the gold: the loss and the gradient norm; the leaves, which
    AdamW's first update moves by lr g / (|g| + eps) ~ lr sign(g), wherever
    the step's gradient and the gold's have one sign (at least 98% of each
    leaf's elements: the rest lie within the packages' gradient difference
    of 0) and the gold's is past 1e-5. The gradients the step hands the optimizer against the port's
    one-rank step's, within rtol / atol 2e-4 and each leaf within 1e-3 in
    norm (a sum missed or taken twice is off by half or more): on one
    device the packages' gradients of this loss already differ by up to
    2.5e-4 at this width."""
    cfg, params, lora, batch = setup
    ref_m, ref_g, ref = _jax_step(cfg, params, lora, batch,
                                  axes if jax_step_composes(axes) else None)
    runs = _port_step(cfg, params, lora, batch, axes)
    one = _port_step(cfg, params, lora, batch, {})[0][1]
    for run in runs:
        assert run[0] == runs[0][0]
        for tree, first in zip(run[1:], runs[0][1:]):
            for k, a in tree.items():
                np.testing.assert_array_equal(a, first[k], err_msg=k)
    m, grads, leaves = runs[0]
    assert m["loss"] == pytest.approx(ref_m["loss"], rel=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], ref_m["grad_norm"],
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    # the leaves no stage reads take a pipeline's zeros
    assert set(one) <= set(grads) <= set(ref_g) and set(leaves) == set(ref)
    for k, g in grads.items():
        if k not in one:
            assert not g.any(), k
            continue
        np.testing.assert_allclose(g, one[k], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=k)
        assert (np.linalg.norm(g - one[k])
                <= NORM_REL * np.linalg.norm(one[k])), k
        same = np.sign(g) == np.sign(ref_g[k])
        assert same.mean() >= 0.98, k
        # past 1e-5 AdamW's eps (1e-8) moves the update by under 1e-3 of lr
        settled = same & (np.abs(ref_g[k]) > 1e-5)
        np.testing.assert_allclose(leaves[k][settled], ref[k][settled],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_rows_split_over_data_and_fsdp_only():
    """A global batch's rows: one block per (data, fsdp) coordinate; the
    pipe, seq and tensor coordinates share it."""
    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return ({a: r.rank for a, r in mesh.items()},
                    pmesh.batch_coordinate())

    for coords, (index, count) in LocalRing.run_mesh(
            rank, data=2, fsdp=2, pipe=2, seq=2, tensor=1):
        assert count == 4 and index == 2 * coords["data"] + coords["fsdp"]


class _Rows:
    """The same batches every epoch, this rank's rows of each."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        rows = pmesh.batch_sharding()
        return iter([{k: rows.shard(v) for k, v in b.items()}
                     for b in self.batches])

    def __len__(self):
        return len(self.batches)


def test_trainer_resume_under_fsdp_and_pipe_is_exact(setup, tmp_path):
    cfg, params, _, _ = setup
    axes = {"fsdp": 2, "pipe": 2}
    tcfg = port(composed(cfg, axes))
    data = [_torch_batch(jax.device_get(make_batch(cfg, STEM, b=BATCH,
                                                   seed=s))) for s in (0, 1)]

    def run(out, max_steps, resume=False):
        model = split_model(params, tcfg, requires_grad=False)
        tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                 total_steps=8)
        state, frozen = tts.init_train_state(
            model, None, tx, topt.default_trainable_pred(ft_full=True))
        tr = Trainer(tcfg, port(STEM), tx, state, frozen, _Rows(data),
                     output_dir=str(out), max_steps=max_steps, save_steps=2,
                     logging_steps=100)
        state = tr.train(resume_from_checkpoint=resume)
        tr.ckpt.close()
        return state, sharding.leaf_specs(model)

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return check()

    def check():
        whole, specs = run(tmp_path / "whole", 4)
        run(tmp_path / "split", 2)
        resumed, _ = run(tmp_path / "split", 4, resume=True)
        assert resumed.step == whole.step == 4
        for k, t in whole.trainable.items():
            assert torch.equal(resumed.trainable[k], t), k
            assert torch.equal(resumed.opt_state.mu[k],
                               whole.opt_state.mu[k]), k
            assert torch.equal(resumed.opt_state.nu[k],
                               whole.opt_state.nu[k]), k
        return {k: sharding.gather_leaf(t.detach(), specs[k]) if k in specs
                else t.detach() for k, t in whole.trainable.items()}, specs

    runs = LocalRing.run_mesh(rank, **axes)
    # the checkpoint holds whole tensors: a one-device state restores it
    state, _ = tts.init_train_state(
        split_model(params, port(cfg), requires_grad=False), None,
        topt.make_optimizer(), topt.default_trainable_pred(ft_full=True))
    CheckpointManager(str(tmp_path / "split" / "checkpoints")
                      ).restore_latest(state)
    trained, specs = runs[0]
    assert specs and state.step == 4
    assert set(state.trainable) == set(trained)
    for k, t in state.trainable.items():
        assert torch.equal(t, trained[k]), k
