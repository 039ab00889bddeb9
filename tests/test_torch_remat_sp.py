"""Remat under sequence parallelism in the port (models/whisper.py's
``_remat_layer`` with the ring, ``config.remat`` with
``seq_parallel_axis``) against the JAX package's remat + SP step, in f32 on
the CPU, the ring as LocalRing(2) threads (100 frames padded to 256: the
second rank's keys are all masked):

- one fold_lora step under every remat policy: loss, gradient norm and the
  updated leaves within the port's bound against JAX (rtol 1e-4 /
  atol 2e-4) of JAX's step under the same policy on a (data 1, seq 2) mesh,
  bit for bit equal on both ranks and to the port's SP step without remat;
- the ring's forward (K4's entry) runs again in the backward under every
  policy but 'everything': nothing of the ring is kept, as in the JAX
  package, whose ring names no residual."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models import whisper as tw
from neuspeech1_tpu_torch.models.convert import params_from_lora
from neuspeech1_tpu_torch.ops import flash_attention as fa
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_train import STEM, TSTEM, _batch, _setup, _torch_batch
from tests.test_torch_whisper import port, tiny

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
N = 2


def _optimizer(pkg):
    return pkg.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _jax_step(config):
    params, lora, _, _ = _setup(tiny())
    tx = _optimizer(jopt)
    state, frozen = jts.init_train_state(jax.random.key(2), params, lora, tx,
                                         jopt.default_trainable_pred())
    step = jts.make_train_step(config, STEM, tx, fold_lora=True, donate=False)
    batch = {k: jnp.asarray(v) for k, v in _batch(tiny()).items()}
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(1, N), ("data", "seq"))
    with jax.sharding.set_mesh(mesh):
        state, m = step(state, frozen, batch)
    return ({k: float(m[k]) for k in ("loss", "grad_norm")},
            jax.device_get(state.trainable["lora"]))


def _port_step(config):
    """One step on this thread's ring: metrics and the adapter tree."""
    _, _, model, t_lora = _setup(tiny(), config)
    tx = _optimizer(topt)
    state, frozen = tts.init_train_state(model, t_lora, tx)
    step = tts.make_train_step(config, TSTEM, tx, fold_lora=True)
    m = step(state, frozen, _torch_batch(_batch(tiny())))
    return ({k: float(m[k]) for k in ("loss", "grad_norm")},
            params_from_lora(t_lora))


def _sp_run(config):
    def rank(ring):
        with pmesh.set_mesh({"seq": ring}):
            return _port_step(config)
    return LocalRing.run(rank, N)


@pytest.fixture(scope="module")
def no_remat():
    return _sp_run(port(tiny(seq_parallel_axis="seq")))[0]


@pytest.mark.parametrize("policy", tw.REMAT_POLICIES)
def test_remat_sp_step_matches_jax_and_the_step_without_remat(
        policy, no_remat, monkeypatch):
    kw = dict(seq_parallel_axis="seq", remat=True, remat_policy=policy)
    calls = []
    real = fa.flash_bias_fwd

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(fa, "flash_bias_fwd", counted)
    runs = _sp_run(port(tiny(**kw)))
    n_layers = tiny().encoder_layers
    # per rank: N rounds per layer in the forward, again in the backward's
    # recompute unless the policy saves everything
    per_pass = N * N * n_layers
    assert len(calls) == per_pass * (1 if policy == "everything" else 2)
    (m0, l0), (m1, l1) = runs
    assert m0 == m1 == no_remat[0]
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(l0),
                               jax.tree_util.tree_leaves(l1),
                               jax.tree_util.tree_leaves(no_remat[1])):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        np.testing.assert_array_equal(a, c, err_msg=jax.tree_util.keystr(path))
    jm, jl = _jax_step(tiny(**kw))
    for k in jm:
        np.testing.assert_allclose(m0[k], jm[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(l0),
                            jax.tree_util.tree_leaves(jl)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
