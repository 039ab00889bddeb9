"""FSDP (and FSDP beside tensor parallelism) in the port's training step
(neuspeech1_tpu_torch/train/trainstep.py on a model split by
parallel/sharding.py::shard_params) in f32 on the CPU, the ranks as
LocalRing threads:

- two steps on {data: 2, fsdp: 2, tensor: 2} against the JAX package's step
  on its 3D mesh (tests/test_train.py's test_3d_mesh_train_step): the loss
  within rel 1e-5, the updated leaves within rtol 1e-4 / atol 1e-5, the
  (replicated) trainable leaves equal bit for bit on every rank;
- --ft_full under {fsdp: 2}: every leaf trainable, the split ones gathered
  whole after two steps, against the JAX package's one-device step within
  the same bounds; each rank's parameters and AdamW moments hold its
  shards only;
- AdaLoRA (orthogonality loss, importance EMAs, the clip) with
  augmentation, dropout and remat under {tensor: 2}, against the port's
  one-rank step;
- a LocalRing of CUDA tensors refuses the split step at once (its
  backward's collectives would deadlock on one device), and the guard that
  catches a collective inside the backward;
- eval loss and eval-WER with an fsdp rank holding no row of the last
  eval batch.
The fine-tune CLI under FSDP: tests/test_torch_sharded_cli.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.parallel.mesh import batch_sharding, make_mesh
from neuspeech1_tpu.parallel.sharding import shard_params as jax_shard
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu_torch.models.convert import (lora_from_params,
                                                 module_from_params)
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import ring_attention
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from tests.test_torch_step_options import AUG, _torch_batch, _weights
from tests.test_torch_tensor_parallel import _port_leaves
from tests.test_torch_trainer import _configs
from tests.test_torch_whisper import port
from tests.test_train import make_batch

torch.set_num_threads(1)

# tests/test_train.py's bounds for the JAX sharded steps
LOSS_REL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
STEM = StemConfig("base", in_channels=4)
BATCH = 8


def _batches(jconfig, stem=STEM):
    return [jax.device_get(make_batch(jconfig, stem, b=BATCH, seed=s))
            for s in (0, 1)]


def _jax_run(jconfig, params, lora, batches, pred, mesh=None):
    """Two steps of JAX's step (the fold), on one device or with params,
    adapters and batches placed on ``mesh``: the losses and the trainable
    leaves by the port's paths."""
    tx = jopt.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                             grad_clip=None)
    step = jts.make_train_step(jconfig, STEM, tx, fold_lora=True,
                               donate=False)
    if mesh is not None:
        params = jax_shard(mesh, params)
        lora = None if lora is None else jax_shard(mesh, lora)
    state, frozen = jts.init_train_state(jax.random.key(2), params, lora, tx,
                                         pred)
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if mesh is not None:
            jb = jax.device_put(jb, batch_sharding(mesh))
        state, m = step(state, frozen, jb)
        losses.append(float(m["loss"]))
    tree = jax.device_get(state.trainable)
    return losses, {**_port_leaves(tree.get("model", {}), "model"),
                    **_port_leaves(tree.get("lora", {}), "lora")}


def _port_run(tconfig, params, lora, batches, ft_full=False, stem=STEM,
              grad_clip=None, **step_kw):
    """The port's step on this thread's ambient mesh, on a model split
    over it, each rank on its rows of every batch: the metrics per step,
    the trainable leaves (split ones gathered whole), the importance EMAs,
    and this rank's bytes of split parameters and of their moments."""
    model = sharding.shard_params(module_from_params(
        params, tconfig, port(stem), device="cpu", dtype=torch.float32))
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                             grad_clip=grad_clip)
    state, frozen = tts.init_train_state(
        model, None if lora is None else lora_from_params(lora, device="cpu"),
        tx, topt.default_trainable_pred(ft_full=ft_full))
    step = tts.make_train_step(tconfig, port(stem), tx, fold_lora=True,
                               **step_kw)
    shard = pmesh.batch_sharding()
    metrics = []
    for b in batches:
        m = step(state, frozen, {k: shard.shard(v)
                                 for k, v in _torch_batch(b).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    specs = sharding.leaf_specs(model)
    leaves = {k: (sharding.gather_leaf(t.detach(), specs[k]) if k in specs
                  else t.detach()).numpy().copy()
              for k, t in state.trainable.items()}
    ipt = {f"{kind}/{path}/{n}": x.numpy().copy()
           for kind, tree in (state.ipt or {}).items()
           for path, e in tree.items() for n, x in e.items()}
    split = [k for k in state.trainable if k in specs]
    nbytes = {
        "params": sum(state.trainable[k].nbytes for k in split),
        "moments": sum(state.opt_state.mu[k].nbytes
                       + state.opt_state.nu[k].nbytes for k in split)}
    return metrics, leaves, ipt, nbytes


def _on_mesh(fn, **axes):
    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return fn()
    return LocalRing.run_mesh(rank, **axes)


def _close_leaves(got, ref, rtol=RTOL, atol=ATOL):
    assert set(got) == set(ref)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=rtol, atol=atol,
                                   err_msg=k)


def _same_on_every_rank(runs):
    for r in runs[1:]:
        assert r[0] == runs[0][0]
        for k, a in runs[0][1].items():
            np.testing.assert_array_equal(r[1][k], a, err_msg=k)


@pytest.fixture(scope="module")
def setup():
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, STEM, adalora=False)
    return jconfig, tconfig, params, lora, _batches(jconfig)


def test_3d_mesh_steps_match_jax(setup):
    jconfig, tconfig, params, lora, batches = setup
    jlosses, jtrain = _jax_run(jconfig, params, lora, batches,
                               jopt.default_trainable_pred(),
                               make_mesh(data=2, fsdp=2, tensor=2))
    runs = _on_mesh(lambda: _port_run(tconfig, params, lora, batches),
                    data=2, fsdp=2, tensor=2)
    _same_on_every_rank(runs)
    for m, ref in zip(runs[0][0], jlosses):
        assert m["loss"] == pytest.approx(ref, rel=LOSS_REL)
    _close_leaves({k: runs[0][1][k] for k in jtrain}, jtrain)


def test_ft_full_under_fsdp_matches_jax(setup):
    jconfig, tconfig, params, _, batches = setup
    jlosses, jtrain = _jax_run(jconfig, params, None, batches,
                               jopt.default_trainable_pred(ft_full=True))
    runs = _on_mesh(lambda: _port_run(tconfig, params, None, batches,
                                      ft_full=True), fsdp=2)
    _same_on_every_rank(runs)
    for m, ref in zip(runs[0][0], jlosses):
        assert m["loss"] == pytest.approx(ref, rel=LOSS_REL)
    _close_leaves(runs[0][1], jtrain)
    # each fsdp rank holds half of every split leaf (the linears' weights)
    # and of its two moments
    whole = sum(a.nbytes for k, a in jtrain.items() if "/layers/" in k
                and k.endswith("/w") and ("attn" in k or "fc" in k))
    for r in runs:
        assert r[3]["params"] * 2 == whole
        assert r[3]["moments"] == 2 * r[3]["params"]


def test_adalora_and_remat_under_tensor_match_the_one_rank_step():
    """The orthogonality loss entered once, the adapters' partial
    gradients summed over 'tensor', the importance EMAs and the clip on the
    summed gradients, the augmentation's and dropout's draws, and remat
    replaying the row-parallel sums in the backward."""
    jconfig, tconfig = _configs()
    stem = StemConfig("base", in_channels=4, dropout=0.1)
    params, lora = _weights(jconfig, stem)
    batches = _batches(jconfig, stem)
    tconfig = dataclasses.replace(tconfig, remat=True,
                                  remat_policy="flash_qkv")
    kw = dict(stem=stem, orth_reg_weight=0.5, track_adalora_importance=True,
              augment_config=AUG, use_dropout=True, grad_clip=1.0)
    one = _port_run(tconfig, params, lora, batches, **dict(kw))
    runs = _on_mesh(lambda: _port_run(tconfig, params, lora, batches,
                                      **dict(kw)), tensor=2)
    _same_on_every_rank(runs)
    metrics, leaves, ipt, _ = runs[0]
    assert metrics[0]["orth_reg"] > 0
    for a, b in zip(metrics, one[0]):
        assert set(a) == set(b)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=LOSS_REL, abs=1e-7), k
    _close_leaves(leaves, one[1])
    assert ipt
    _close_leaves(ipt, one[2], atol=1e-7)


def test_split_step_on_a_cuda_local_ring_raises_at_once(setup):
    """CUDA runs every thread's backward on one autograd worker thread, so
    a LocalRing's collectives inside it would wait on each other until the
    barrier's timeout: the split step refuses before its backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tconfig, params, lora, batches = setup

    def run():
        model = sharding.shard_params(module_from_params(
            params, tconfig, port(STEM), device="cuda", dtype=torch.float32))
        tx = topt.make_optimizer()
        state, frozen = tts.init_train_state(
            model, None, tx, topt.default_trainable_pred(ft_full=True))
        b = {k: v.cuda() for k, v in _torch_batch(batches[0]).items()}
        tts.make_train_step(tconfig, port(STEM), tx)(state, frozen, b)

    with pytest.raises(RuntimeError, match="deadlock"):
        _on_mesh(run, tensor=2)


def test_collective_inside_the_backward_raises_for_cuda_tensors(
        setup, monkeypatch):
    """The guard itself, with the tensors taken for CUDA ones: the
    forward's collectives run, the first one autograd's backward reaches
    raises instead of waiting."""
    _, tconfig, params, _, batches = setup
    monkeypatch.setattr(ring_attention, "_on_cuda", lambda value: True)
    whole = module_from_params(params, tconfig, port(STEM), device="cpu",
                               dtype=torch.float32)

    def run():
        model = sharding.shard_params(copy.deepcopy(whole))
        x = torch.ones(2, 3, tconfig.d_model, requires_grad=True)
        layer = model.encoder.layers[0]
        y = sharding.reduce_from_tensor(layer.fc2.weight.new_ones(1), pmesh
                                        .tensor_ring())
        assert float(y) == 2.0  # a forward collective is no backward one
        with pytest.raises(RuntimeError, match="deadlock"):
            sharding.copy_to_tensor(x, pmesh.tensor_ring())
        out = sharding.reduce_from_tensor(x * 1.0, pmesh.tensor_ring())
        with pytest.raises(RuntimeError, match="deadlock"):
            # this rank's backward never leaves for the other's: one
            # collective in the backward is refused on its own
            (out.sum() * 0 + sharding._CopyToTensor.apply(
                x, pmesh.tensor_ring()).sum()).backward()

    _on_mesh(run, tensor=2)


def test_eval_with_an_empty_fsdp_share_matches_one_rank(tmp_path):
    """Eval loss and eval-WER on {fsdp: 2} where the last eval batch holds
    one row: rank 1's empty share runs a masked copy of its previous batch
    beside rank 0's forward and decode, so their weight gathers meet, and
    the results are one process's."""
    from neuspeech1_tpu_torch.data import synthetic as tsyn
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import EEGDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.train.trainer import Trainer
    from neuspeech1_tpu_torch.utils.tokenizer import ByteTokenizer

    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, STEM, adalora=False)
    root = str(tmp_path / "corpus")
    tsyn.make_synthetic_corpus(root, n_clips=24, n_channels=4, seed=5,
                               min_dur=0.5, max_dur=0.6)
    tok = ByteTokenizer(tconfig)

    def run(index=0, count=1):
        ds = EEGDataset(f"{root}/test.jsonl", tok, mode="eval", modal_ch=4,
                        min_duration=0.5, max_duration=0.64)
        assert len(ds) == 3  # batches of 2 and 1 rows
        col = Collator(pad_id=tok.pad_id, decoder_start_id=tconfig.sot_id,
                       max_label_len=40, eot_id=tconfig.eot_id)
        val = DataLoader(ds, col, 2, shuffle=False, drop_last=False,
                         num_threads=1, process_index=index,
                         process_count=count)
        model = sharding.shard_params(module_from_params(
            params, tconfig, port(STEM), device="cpu", dtype=torch.float32))
        tx = topt.make_optimizer()
        state, frozen = tts.init_train_state(
            model, lora_from_params(lora, device="cpu"), tx)
        tr = Trainer(tconfig, port(STEM), tx, state, frozen, [], val,
                     output_dir=str(tmp_path / f"out{index}of{count}"),
                     generate_eval_tokenizer=tok, generate_eval_max_new=6)
        return tr.evaluate(), tr.evaluate_generate()

    loss, wer = run()
    for got_loss, got_wer in _on_mesh(
            lambda: run(*pmesh.batch_coordinate()), fsdp=2):
        assert got_loss == pytest.approx(loss, rel=LOSS_REL)
        assert got_wer == wer
