"""Data parallelism in the port's training step (neuspeech1_tpu_torch/train/
trainstep.py under a mesh ``data`` axis) against the JAX package's step on
an 8-device data mesh (tests/test_train.py's
test_data_parallel_two_steps_match_single_device) and against the port's
one-rank step, in f32 on the CPU, with the ranks as LocalRing threads
(``LocalRing.run_mesh``), each holding its block of the global batch's rows
(``parallel/mesh.py::batch_sharding``) and its own copy of the weights:

- two steps over LocalRing(2) and LocalRing(4): loss within rel 1e-5 and
  the updated leaves within rtol 1e-4 / atol 1e-5 of JAX's, every rank's
  leaves equal bit for bit;
- ranks holding different numbers of unmasked labels (the token mean is
  global);
- AdaLoRA's orthogonality loss and importance EMAs, augmentation and
  dropout, against the one-rank port step on the same generator;
- data x sequence parallelism ({data: 2, seq: 2}), and FSDP or tensor
  parallelism beside sequence or pipeline parallelism, against the
  one-rank step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.parallel.mesh import batch_sharding, make_mesh
from neuspeech1_tpu.parallel.sharding import shard_params
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_step_options import AUG, _port, _torch_batch, _weights
from tests.test_torch_trainer import _configs
from tests.test_torch_whisper import port
from tests.test_train import make_batch

torch.set_num_threads(1)

# tests/test_train.py's bounds for the JAX data-parallel step
LOSS_REL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
# the port's one-device step against JAX's (tests/test_torch_train.py)
PORT_VS_JAX = (1e-4, 2e-4)
STEM = StemConfig("base", in_channels=4)
BATCH = 8
N_STEPS = 2


def _optimizer(pkg):
    return pkg.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                              grad_clip=None)


def _batches(jconfig, stem=STEM, seeds=(0, 1)):
    return [jax.device_get(make_batch(jconfig, stem, b=BATCH, seed=s))
            for s in seeds]


def _jax_run(jconfig, params, lora, batches, mesh=None):
    """N steps of JAX's fold_lora step, on one device or sharded over
    ``mesh``: per step the loss, and the trainable leaves after the last."""
    tx = _optimizer(jopt)
    step = jts.make_train_step(jconfig, STEM, tx, fold_lora=True,
                               donate=False)
    p = params if mesh is None else shard_params(mesh, params)
    state, frozen = jts.init_train_state(jax.random.key(2), p, lora, tx,
                                         jopt.default_trainable_pred())
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if mesh is not None:
            jb = jax.device_put(jb, batch_sharding(mesh))
        state, m = step(state, frozen, jb)
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.trainable)


def _port_run(tconfig, params, lora, batches, stem=STEM, split=False,
              **step_kw):
    """The port's step on this thread's ambient mesh, each rank on its
    block of every batch (with ``split``, on a model split over the mesh's
    fsdp and tensor axes): per step the metrics, then the trainable leaves,
    the importance EMAs and the generator's state."""
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                             grad_clip=step_kw.pop("grad_clip", None))
    state, frozen = _port(params, lora, tconfig, stem, tx)
    if split:  # the trainable leaves (adapters, stem, conv2) stay whole
        sharding.shard_params(frozen.model)
    step = tts.make_train_step(tconfig, port(stem), tx, fold_lora=True,
                               **step_kw)
    shard = pmesh.batch_sharding()
    metrics = []
    for b in batches:
        tb = {k: shard.shard(v) for k, v in _torch_batch(b).items()}
        m = step(state, frozen, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    leaves = {k: t.detach().numpy().copy() for k, t in state.trainable.items()}
    ipt = {f"{kind}/{path}/{n}": x.numpy().copy()
           for kind, tree in (state.ipt or {}).items()
           for path, e in tree.items() for n, x in e.items()}
    return metrics, leaves, ipt, state.generator.get_state()


def _dp(n, fn, **axes):
    axes = axes or {"data": n}

    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return fn()
    return LocalRing.run_mesh(rank, **axes)


def _jax_leaves(trainable):
    """JAX's trainable tree by the port's leaf paths."""
    from neuspeech1_tpu_torch.models.convert import lora_from_params
    from neuspeech1_tpu_torch.train.optimizer import named_leaves

    out = {}
    lora = lora_from_params(trainable["lora"], device="cpu")
    for k, v in named_leaves(torch.nn.Module(), lora).items():
        out[k] = v.numpy()
    enc = trainable["model"]["encoder"]
    out["model/encoder/stem/conv_a/w"] = np.asarray(enc["stem"]["conv_a"]["w"])
    out["model/encoder/conv2/w"] = np.asarray(enc["conv2"]["w"])
    return out


def _same_on_every_rank(runs):
    for r in runs[1:]:
        assert r[0] == runs[0][0]
        for k, a in runs[0][1].items():
            np.testing.assert_array_equal(r[1][k], a, err_msg=k)


def _close_leaves(got, ref, rtol=RTOL, atol=ATOL):
    assert set(got) == set(ref)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def setup():
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, STEM, adalora=False)
    batches = _batches(jconfig)
    jax_dp = _jax_run(jconfig, params, lora, batches, make_mesh(data=8))
    return jconfig, tconfig, params, lora, batches, jax_dp


@pytest.mark.parametrize("n", [2, 4])
def test_dp_steps_match_jax_data_mesh(setup, n):
    jconfig, tconfig, params, lora, batches, (jlosses, jtrain) = setup
    runs = _dp(n, lambda: _port_run(tconfig, params, lora, batches))
    _same_on_every_rank(runs)
    metrics, leaves, _, _ = runs[0]
    for m, ref in zip(metrics, jlosses):
        assert m["loss"] == pytest.approx(ref, rel=LOSS_REL)
    ref = _jax_leaves(jtrain)
    _close_leaves({k: leaves[k] for k in ref}, ref)


def test_dp_steps_match_the_one_rank_step(setup):
    """Two ranks against the port on the whole batch, and JAX's 8-device
    step against its one-device step (the pair the JAX test holds)."""
    jconfig, tconfig, params, lora, batches, (jlosses, _) = setup
    one = _port_run(tconfig, params, lora, batches)
    two = _dp(2, lambda: _port_run(tconfig, params, lora, batches))[0]
    for a, b in zip(two[0], one[0]):
        for k in ("loss", "ce_loss", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=LOSS_REL), k
    _close_leaves(two[1], one[1])
    jone, _ = _jax_run(jconfig, params, lora, batches)
    np.testing.assert_allclose(jlosses, jone, rtol=LOSS_REL)


def test_unequal_label_counts_take_the_global_token_mean(setup):
    """Rank 0's rows keep two labels, rank 1's all eight: a mean of the
    ranks' means would weigh rank 0's tokens four times as much. Two ranks
    against the port's one-rank step within the data-parallel bounds, and
    against JAX's 8-device step: the loss within rel 1e-5, the leaves
    within the bound the port's one-device step holds against JAX's
    (tests/test_torch_train.py), which that step needs on this batch too
    (one element of an Adam update on a near-zero gradient)."""
    jconfig, tconfig, params, lora, batches, _ = setup
    uneven = []
    for b in batches:
        b = {k: np.array(v) for k, v in b.items()}
        b["labels"][:BATCH // 2, 2:] = -100
        uneven.append(b)
    assert (uneven[0]["labels"][:4] != -100).sum() != \
        (uneven[0]["labels"][4:] != -100).sum()
    jlosses, jtrain = _jax_run(jconfig, params, lora, uneven,
                               make_mesh(data=8))
    one = _port_run(tconfig, params, lora, uneven)
    runs = _dp(2, lambda: _port_run(tconfig, params, lora, uneven))
    _same_on_every_rank(runs)
    for m, m1, ref in zip(runs[0][0], one[0], jlosses):
        assert m["loss"] == pytest.approx(ref, rel=LOSS_REL)
        assert m["loss"] == pytest.approx(m1["loss"], rel=LOSS_REL)
    _close_leaves(runs[0][1], one[1])
    ref = _jax_leaves(jtrain)
    _close_leaves({k: runs[0][1][k] for k in ref}, ref, *PORT_VS_JAX)
    _close_leaves({k: one[1][k] for k in ref}, ref, *PORT_VS_JAX)


def test_adalora_augmentation_and_dropout_match_the_one_rank_step():
    """The orthogonality loss counted once, the importance EMAs on the
    summed gradients, the clip on their norm, and the augmentation's and
    dropout's draws for the global batch: two ranks against one on the
    same generator, the generators in step afterwards."""
    jconfig, tconfig = _configs()
    stem = StemConfig("base", in_channels=4, dropout=0.1)
    params, lora = _weights(jconfig, stem)
    batches = _batches(jconfig, stem)
    kw = dict(stem=stem, orth_reg_weight=0.5, track_adalora_importance=True,
              augment_config=AUG, use_dropout=True, grad_clip=1.0)
    one = _port_run(tconfig, params, lora, batches, **dict(kw))
    runs = _dp(2, lambda: _port_run(tconfig, params, lora, batches,
                                    **dict(kw)))
    _same_on_every_rank(runs)
    metrics, leaves, ipt, gen = runs[0]
    assert "orth_reg" in metrics[0] and metrics[0]["orth_reg"] > 0
    for a, b in zip(metrics, one[0]):
        assert set(a) == set(b)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=LOSS_REL, abs=1e-7), k
    _close_leaves(leaves, one[1])
    assert ipt
    _close_leaves(ipt, one[2], atol=1e-7)
    assert torch.equal(gen, one[3]) and torch.equal(runs[1][3], gen)


def test_data_by_sequence_parallel_matches_the_one_rank_step():
    """{data: 2, seq: 2}: the encoder stack on each data rank's two
    sequence shards, its leaves summed over 'seq', then every leaf over
    'data'."""
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, STEM, adalora=False)
    batches = _batches(jconfig)
    one = _port_run(tconfig, params, lora, batches)
    sp = dataclasses.replace(tconfig, seq_parallel_axis="seq")
    runs = _dp(4, lambda: _port_run(sp, params, lora, batches), data=2,
               seq=2)
    _same_on_every_rank(runs)
    for a, b in zip(runs[0][0], one[0]):
        assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_REL)
    _close_leaves(runs[0][1], one[1])


def test_fsdp_and_tensor_axes_still_raise(setup):
    """FSDP and tensor parallelism beside sequence or pipeline parallelism,
    which raised until the mesh's axes composed: {fsdp: 2, seq: 2} and
    {tensor: 2, pipe: 2} (the ring's layers and the pipeline's stages on
    the split linears) give the one-rank step's losses and leaves, the
    same bits on every rank. Against the JAX package's compositions:
    tests/test_torch_composed_*.py."""
    _, tconfig, params, lora, batches, _ = setup
    one = _port_run(tconfig, params, lora, batches)
    for axes, axis in (({"fsdp": 2, "seq": 2}, "seq_parallel_axis"),
                       ({"tensor": 2, "pipe": 2}, "pipeline_axis")):
        config = dataclasses.replace(tconfig, **{axis: list(axes)[1]})
        runs = _dp(4, lambda: _port_run(config, params, lora, batches,
                                        split=True), **axes)
        _same_on_every_rank(runs)
        for a, b in zip(runs[0][0], one[0]):
            assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_REL)
        _close_leaves(runs[0][1], one[1])
