"""The port's training loop (neuspeech1_tpu_torch/train) against the JAX
package's, in f32 on the CPU, on the same npz weights, the same adapters and
the same numpy-shuffled loader order:

- one AdaLoRA step with the orthogonality loss and importance tracking:
  loss and grad_norm within rtol 1e-4 / atol 2e-4, the EMAs within rtol
  1e-5 of their largest entry;
- 10 Trainer steps of AdaLoRA (tinit 2, tfinal 2, deltaT 2, orth 0.5) in
  the 'fc' fold regime: per-step loss and grad_norm within rtol 1e-4 / atol
  2e-4, the masks after every allocation exactly equal, the eval loss
  within the same bound, and the eval-WER decode's tokens exactly equal;
- resume is exact (6 steps = 3 + resume + 3, bit for bit), best-eval
  gating, ``ft_full``, gradient accumulation
  (tests/test_train.py::test_grad_accumulation_equivalence), and remat's
  gradients equal to no remat's for both policies."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.data import collate as jcol
from neuspeech1_tpu.data import dataset as jds
from neuspeech1_tpu.data import loader as jld
from neuspeech1_tpu.decode import generate as jgen
from neuspeech1_tpu.models import lora as jl
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.train import optimizer as jopt
from neuspeech1_tpu.train import trainstep as jts
from neuspeech1_tpu.train.trainer import Trainer as JTrainer
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jtok
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.data import collate as tcol
from neuspeech1_tpu_torch.data import dataset as tds
from neuspeech1_tpu_torch.data import loader as tld
from neuspeech1_tpu_torch.data import synthetic as tsyn
from neuspeech1_tpu_torch.decode import generate as tgen
from neuspeech1_tpu_torch.models import lora as tl
from neuspeech1_tpu_torch.models.convert import (
    lora_from_params, module_from_params)
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.train.checkpoint import CheckpointManager
from neuspeech1_tpu_torch.train.trainer import Trainer as TTrainer
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer as ttok

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
EMA_RTOL = 1e-5
GEO = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_heads=2,
           decoder_heads=2, encoder_ffn=128, decoder_ffn=128,
           max_source_positions=32, max_target_positions=40,
           dtype="float32", flash_attention="off")
ADALORA = {"init_r": 4, "target_r": 1, "tinit": 2, "tfinal": 2, "deltaT": 2,
           "total_steps": 10}
N_STEPS = 10


def _configs(**kw):
    jconfig = jc.tiny_config(**{**GEO, **kw})
    return jconfig, tc.WhisperConfig(**dataclasses.asdict(jconfig))


STEM = jc.StemConfig("base", in_channels=4)
TSTEM = tc.StemConfig("base", in_channels=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    tsyn.make_synthetic_corpus(root, n_clips=24, n_channels=4, seed=5,
                               min_dur=0.5, max_dur=0.6)
    return root


def _weights(jconfig, adalora=True):
    params = jax.device_get(init_params(jax.random.key(0), jconfig, STEM))
    lora = jax.device_get(jl.init_lora(jax.random.key(1), jconfig, rank=4,
                                       alpha=8.0, adalora=adalora))
    return params, lora


def _loaders(corpus, jconfig, tconfig):
    """Each package's dataset, collator and loader on the same manifest:
    the same numpy-shuffled order."""
    out = []
    for ds_mod, col_mod, ld_mod, tok, cfg in (
            (jds, jcol, jld, jtok, jconfig), (tds, tcol, tld, ttok, tconfig)):
        tk = tok("byte", cfg)
        kw = dict(modal_ch=4, min_duration=0.5, max_duration=0.64)
        col = col_mod.Collator(pad_id=tk.pad_id, decoder_start_id=cfg.sot_id,
                               max_label_len=40, eot_id=cfg.eot_id)
        train = ld_mod.DataLoader(
            ds_mod.EEGDataset(f"{corpus}/train.jsonl", tk, mode="train", **kw),
            col, 4, shuffle=True, seed=0, num_threads=2)
        val = ld_mod.DataLoader(
            ds_mod.EEGDataset(f"{corpus}/val.jsonl", tk, mode="eval", **kw),
            col, 4, shuffle=False, drop_last=False, num_threads=1)
        out.append((train, val, tk))
    return out


def _port_state(params, lora, tconfig, tx, pred=None):
    model = module_from_params(params, tconfig, TSTEM, device="cpu",
                               dtype=torch.float32)
    t_lora = lora_from_params(lora, device="cpu") if lora else None
    return tts.init_train_state(model, t_lora, tx, pred)


def _masks_jax(lora):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and "mask" in v:
                for i in range(v["mask"].shape[0]):
                    parts = p.split("/")
                    parts.insert(parts.index("layers") + 1, str(i))
                    out["/".join(parts)] = np.asarray(v["mask"][i])
            elif isinstance(v, dict):
                walk(v, p)

    walk(lora, "")
    return out


def _masks_port(lora):
    return {p: e["mask"].detach().numpy().copy()
            for p, e in tl.adalora_entries(lora)}


@pytest.fixture(scope="module")
def trainer_runs(corpus, tmp_path_factory):
    """Both Trainers, 10 AdaLoRA steps with eval and eval-WER at 5 and 10:
    their metrics.jsonl records, masks after each allocation and the
    eval-WER decodes' tokens."""
    root = tmp_path_factory.mktemp("runs")
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig)
    (jtrain, jval, jtk), (ttrain, tval, ttk) = _loaders(corpus, jconfig,
                                                        tconfig)
    kw = dict(max_steps=N_STEPS, eval_steps=5, save_steps=100,
              logging_steps=1, orth_reg_weight=0.5, adalora=ADALORA,
              fold_lora=True, generate_eval_max_new=8)
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=N_STEPS)
    jtx = jopt.make_optimizer(**opt_kw)
    jstate, jfrozen = jts.init_train_state(
        jax.random.key(2), params, lora, jtx, jopt.default_trainable_pred())
    jtr = JTrainer(jconfig, STEM, jtx, jstate, jfrozen, jtrain, jval,
                   output_dir=str(root / "jax"), generate_eval_tokenizer=jtk,
                   **kw)
    ttx = topt.make_optimizer(**opt_kw)
    tstate, tfrozen = _port_state(params, lora, tconfig, ttx)
    ttr = TTrainer(tconfig, TSTEM, ttx, tstate, tfrozen, ttrain, tval,
                   output_dir=str(root / "port"), generate_eval_tokenizer=ttk,
                   **kw)
    masks = {"jax": [], "port": []}
    tokens = {"jax": [], "port": []}

    def record(tr, name, read):
        orig = tr._adalora_update

        def wrapped(step_num):
            orig(step_num)
            masks[name].append((step_num, read(tr)))

        tr._adalora_update = wrapped

    record(jtr, "jax", lambda tr: _masks_jax(
        jax.device_get(tr.state.trainable["lora"])))
    record(ttr, "port", lambda tr: _masks_port(tr.frozen.lora))

    def spy(mod, name):
        orig = mod.greedy_decode

        def wrapped(*a, **k):
            out = orig(*a, **k)
            tokens[name].append(np.asarray(out) if name == "jax"
                                else out.numpy())
            return out

        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "greedy_decode", spy(jgen, "jax"))
    mp.setattr(tgen, "greedy_decode", spy(tgen, "port"))
    try:
        jtr.train()
        ttr.train()
    finally:
        mp.undo()
        jtr.ckpt.close()
    logs = {}
    for name, tr in (("jax", jtr), ("port", ttr)):
        with open(os.path.join(tr.output_dir, "metrics.jsonl")) as f:
            logs[name] = [json.loads(line) for line in f]
    return logs, masks, tokens


def _train_records(log):
    return [r for r in log if "loss" in r]


@pytest.mark.parametrize("step", range(1, N_STEPS + 1))
def test_trainer_step_metrics_match_jax(trainer_runs, step):
    logs, _, _ = trainer_runs
    got = _train_records(logs["port"])[step - 1]
    ref = _train_records(logs["jax"])[step - 1]
    assert list(got) == list(ref)
    assert got["step"] == ref["step"] == float(step)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert got["epoch"] == ref["epoch"]


def test_trainer_masks_match_jax_at_every_allocation(trainer_runs):
    _, masks, _ = trainer_runs
    assert [s for s, _ in masks["port"]] == list(range(1, N_STEPS + 1))
    pruned = 0
    for (step, got), (_, ref) in zip(masks["port"], masks["jax"]):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"step {step} {k}")
        pruned = max(pruned, sum(int((m == 0).sum()) for m in got.values()))
    assert pruned > 0  # the allocator pruned ranks


def test_trainer_eval_matches_jax(trainer_runs):
    logs, _, tokens = trainer_runs
    evals = {n: [r for r in log if "eval_loss" in r] for n, log in logs.items()}
    assert len(evals["port"]) == len(evals["jax"]) == 2
    for got, ref in zip(evals["port"], evals["jax"]):
        assert list(got) == list(ref)
        np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"],
                                   rtol=RTOL, atol=ATOL)
        assert got["eval_wer"] == ref["eval_wer"]
        assert got["eval_bleu1"] == ref["eval_bleu1"]
    assert len(tokens["port"]) == len(tokens["jax"]) > 0
    for got, ref in zip(tokens["port"], tokens["jax"]):
        np.testing.assert_array_equal(got, ref)


def test_adalora_step_matches_jax():
    """Three steps of the train step with the orthogonality loss and
    importance tracking, stop step 2: the EMAs stop moving after step 2."""
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig)
    rng = np.random.default_rng(4)
    # E nonzero, so that A and B get gradients too
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "E" else np.asarray(x), lora)
    from tests.test_train import make_batch

    batch = jax.device_get(make_batch(jconfig, STEM))
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              if k != "input_features" else torch.from_numpy(np.array(v))
              for k, v in batch.items()}
    opt_kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    jtx, ttx = jopt.make_optimizer(**opt_kw), topt.make_optimizer(**opt_kw)
    jstate, jfrozen = jts.init_train_state(
        jax.random.key(2), params, lora, jtx, jopt.default_trainable_pred())
    jstep = jts.make_train_step(jconfig, STEM, jtx, orth_reg_weight=0.5,
                                track_adalora_importance=True,
                                fold_lora=True, adalora_ipt_stop_step=2,
                                donate=False)
    tstate, tfrozen = _port_state(params, lora, tconfig, ttx)
    tstep = tts.make_train_step(tconfig, TSTEM, ttx, orth_reg_weight=0.5,
                                track_adalora_importance=True, fold_lora=True,
                                adalora_ipt_stop_step=2)
    for step in range(3):
        jstate, jm = jstep(jstate, jfrozen, batch)
        tm = tstep(tstate, tfrozen, tbatch)
        for k in ("loss", "ce_loss", "orth_reg", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{step} {k}")
        assert float(tm["orth_reg"]) > 0
        jipt = jax.device_get(jstate.ipt)
        for which in ("avg", "unc"):
            for path, entry in tl.adalora_entries(tfrozen.lora):
                parts = path.split("/")
                layer = next(int(p) for p in parts if p.isdigit())
                node = jipt[which]
                for p in parts:
                    if not p.isdigit():
                        node = node[p]
                for n in tl.IPT_NAMES:
                    ref = np.asarray(node[n][layer])
                    got = tstate.ipt[which][path][n].numpy()
                    np.testing.assert_allclose(
                        got, ref, rtol=EMA_RTOL,
                        atol=EMA_RTOL * np.abs(ref).max(),
                        err_msg=f"step {step} {which} {path}/{n}")
        for path, e in tl.adalora_entries(tfrozen.lora):
            parts = path.split("/")
            layer = next(int(p) for p in parts if p.isdigit())
            node = jax.device_get(jstate.trainable["lora"])
            for p in parts:
                if not p.isdigit():
                    node = node[p]
            for n in ("A", "B", "E"):
                np.testing.assert_allclose(e[n].detach().numpy(),
                                           node[n][layer], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{path}/{n}")
    # the stop step: the third step left the EMAs as the second did
    frozen_avg = {p: v["E"].clone() for p, v in tstate.ipt["avg"].items()}
    tstep(tstate, tfrozen, tbatch)
    for p, v in tstate.ipt["avg"].items():
        assert torch.equal(v["E"], frozen_avg[p])


class _Batches:
    """The same three batches every epoch (a resumed run sees the steps'
    data again)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter([dict(b) for b in self.batches])

    def __len__(self):
        return len(self.batches)


def _batches(corpus):
    train = _loaders(corpus, *_configs())[1][0]
    out = []
    for b in train:
        out.append(b)
        if len(out) == 3:
            return out


def test_resume_is_exact(corpus, tmp_path):
    """6 steps in one run equal 3 steps, a resume, and 3 more, bit for bit:
    the adapters, the stem, the optimizer's moments and count."""
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig)
    data = _Batches(_batches(corpus))
    ada = dict(ADALORA, tinit=6)  # ranks are allocated after the window

    def run(out, max_steps, resume=False):
        tx = topt.make_optimizer(peak_lr=1e-2, warmup_steps=2,
                                 total_steps=10)
        state, frozen = _port_state(params, lora, tconfig, tx)
        tr = TTrainer(tconfig, TSTEM, tx, state, frozen, data,
                      output_dir=str(out), max_steps=max_steps,
                      save_steps=3, logging_steps=100, orth_reg_weight=0.5,
                      adalora=ada, fold_lora=True)
        return tr.train(resume_from_checkpoint=resume)

    whole = run(tmp_path / "whole", 6)
    run(tmp_path / "split", 3)
    resumed = run(tmp_path / "split", 6, resume=True)
    assert resumed.step == whole.step == 6
    assert resumed.opt_state.count == whole.opt_state.count == 6
    for k, t in whole.trainable.items():
        assert torch.equal(resumed.trainable[k], t), k
        assert torch.equal(resumed.opt_state.mu[k], whole.opt_state.mu[k]), k
        assert torch.equal(resumed.opt_state.nu[k], whole.opt_state.nu[k]), k
    # by step: step 0 is a step (identity, not truthiness)
    cm = CheckpointManager(str(tmp_path / "split" / "checkpoints"))
    assert cm.all_steps() == [3, 6]
    with pytest.raises(FileNotFoundError, match=r"saved steps: \[3, 6\]"):
        cm.restore_latest(resumed, step=4)


def test_resume_in_the_final_phase_matches_jax(corpus, tmp_path):
    """A resume inside AdaLoRA's final phase (step > total - tfinal) in
    both packages: neither checkpoints the importance EMAs or the frozen
    rank pattern, so after the resume both mask to the budget on all-zero
    scores and every E goes to 0, the trained ranks included (a fault of
    the reference that the port keeps; ROADMAP queue 3)."""
    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig)
    loaders = _loaders(corpus, jconfig, tconfig)
    data = [_Batches([b for b, _ in zip(ld[0], range(3))]) for ld in loaders]
    kw = dict(save_steps=8, logging_steps=100, orth_reg_weight=0.5,
              adalora=ADALORA, fold_lora=True)
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)

    def run_jax(out, max_steps, resume=False):
        tx = jopt.make_optimizer(**opt_kw)
        state, frozen = jts.init_train_state(
            jax.random.key(2), params, lora, tx,
            jopt.default_trainable_pred())
        tr = JTrainer(jconfig, STEM, tx, state, frozen, data[0], None,
                      output_dir=str(out), max_steps=max_steps, **kw)
        try:
            tree = jax.device_get(
                tr.train(resume_from_checkpoint=resume).trainable["lora"])
        finally:
            tr.ckpt.close()
        es = []

        def walk(node):
            for v in node.values():
                if isinstance(v, dict) and "E" in v:
                    es.append(np.asarray(v["E"]))
                elif isinstance(v, dict):
                    walk(v)

        walk(tree)
        return _masks_jax(tree), np.concatenate([e.ravel() for e in es])

    def run_port(out, max_steps, resume=False):
        tx = topt.make_optimizer(**opt_kw)
        state, frozen = _port_state(params, lora, tconfig, tx)
        tr = TTrainer(tconfig, TSTEM, tx, state, frozen, data[1],
                      output_dir=str(out), max_steps=max_steps, **kw)
        tr.train(resume_from_checkpoint=resume)
        return _masks_port(frozen.lora), torch.cat([
            e["E"].detach().ravel() for _, e in
            tl.adalora_entries(frozen.lora)]).numpy()

    for name, run in (("jax", run_jax), ("port", run_port)):
        masks, e = run(tmp_path / name, 8)
        assert np.count_nonzero(e) == sum(int(m.sum()) for m in masks.values()
                                          ) > 0, name
        masks, e = run(tmp_path / name, 10, resume=True)
        assert not np.any(e) and not any(m.any() for m in masks.values()), \
            name


def test_best_eval_gating(tmp_path):
    """tests/test_trainer.py::test_best_eval_gating on the port's manager."""
    _, tconfig = _configs()
    jconfig, _ = _configs()
    params, _ = _weights(jconfig)
    tx = topt.make_optimizer()
    state, _ = _port_state(params, None, tconfig, tx,
                           topt.default_trainable_pred(ft_full=True))
    cm = CheckpointManager(str(tmp_path / "ck"))
    assert cm.save(state, eval_loss=1.0) is True       # first eval -> best
    state.step += 1
    assert cm.save(state, eval_loss=2.0) is False      # worse -> gated
    state.step += 1
    assert cm.save(state, eval_loss=0.5) is True       # better -> saved
    assert cm.save(state, force=True) is True          # already saved
    cm.wait()
    assert cm.all_steps() == [0, 2]
    with open(tmp_path / "ck" / "gating.json") as f:
        assert json.load(f) == {"best_eval": 0.5}
    # a new manager reads the gate back
    assert CheckpointManager(str(tmp_path / "ck")).best_eval == 0.5


def test_checkpoint_write_joins_through_wait(tmp_path, monkeypatch):
    """The file is written by a thread: the step's directory appears under
    its final name once wait() has joined it, and a failed write re-raises
    from wait() and leaves no step behind."""
    _, tconfig = _configs()
    jconfig, _ = _configs()
    params, _ = _weights(jconfig)
    tx = topt.make_optimizer()
    state, _ = _port_state(params, None, tconfig, tx,
                           topt.default_trainable_pred(ft_full=True))
    cm = CheckpointManager(str(tmp_path / "ck"))
    assert cm.save(state, force=True) is True
    cm.wait()
    assert cm.all_steps() == [0]
    assert cm._writer is None

    import neuspeech1_tpu_torch.train.checkpoint as ckmod

    def failing_save(*_a, **_k):
        raise OSError("disk full")

    monkeypatch.setattr(ckmod.torch, "save", failing_save)
    state.step += 1
    assert cm.save(state, force=True) is True
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.all_steps() == [0]
    cm.wait()  # the error is raised once


def test_ft_full_matches_jax():
    """ft_full trains every leaf: the trainable set and three steps' losses
    and updated weights against the JAX step."""
    from tests.test_train import make_batch

    jconfig, tconfig = _configs()
    params, _ = _weights(jconfig)
    batch = jax.device_get(make_batch(jconfig, STEM))
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              if k != "input_features" else torch.from_numpy(np.asarray(v))
              for k, v in batch.items()}
    opt_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jtx, ttx = jopt.make_optimizer(**opt_kw), topt.make_optimizer(**opt_kw)
    jstate, jfrozen = jts.init_train_state(
        jax.random.key(2), params, None, jtx,
        jopt.default_trainable_pred(ft_full=True))
    jstep = jts.make_train_step(jconfig, STEM, jtx, donate=False)
    tstate, tfrozen = _port_state(params, None, tconfig, ttx,
                                  topt.default_trainable_pred(ft_full=True))
    model = tfrozen.model
    assert set(tstate.trainable) == set(topt.named_leaves(model))
    assert all(p.requires_grad for p in model.parameters())
    tstep = tts.make_train_step(tconfig, TSTEM, ttx)
    for _ in range(3):
        jstate, jm = jstep(jstate, jfrozen, batch)
        tm = tstep(tstate, tfrozen, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
    jw = jax.device_get(jstate.trainable["model"])
    np.testing.assert_allclose(
        model.encoder.layers[1].fc1.weight.detach().numpy().T,
        jw["encoder"]["layers"]["fc1"]["w"][1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        model.decoder.token_embed.weight.detach().numpy(),
        jw["decoder"]["token_embed"], rtol=RTOL, atol=ATOL)


def test_grad_accumulation_equivalence():
    """Accumulating two half batches equals one step on the whole batch
    (tests/test_train.py::test_grad_accumulation_equivalence), and equals
    the JAX package's MultiSteps run; the parameters do not move on the
    first half."""
    from tests.test_train import make_batch

    jconfig, tconfig = _configs()
    params, lora = _weights(jconfig, adalora=False)
    batch = jax.device_get(make_batch(jconfig, STEM, b=4))
    tb = {k: torch.from_numpy(np.asarray(v)).long()
          if k != "input_features" else torch.from_numpy(np.asarray(v))
          for k, v in batch.items()}
    halves = [{k: v[:2] for k, v in tb.items()},
              {k: v[2:] for k, v in tb.items()}]
    kw = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=None)

    full_tx = topt.make_optimizer(**kw)
    full, ffrozen = _port_state(params, lora, tconfig, full_tx)
    tts.make_train_step(tconfig, TSTEM, full_tx)(full, ffrozen, tb)

    acc_tx = topt.make_optimizer(accum_steps=2, **kw)
    acc, afrozen = _port_state(params, lora, tconfig, acc_tx)
    step = tts.make_train_step(tconfig, TSTEM, acc_tx)
    before = {k: t.clone() for k, t in acc.trainable.items()}
    step(acc, afrozen, halves[0])
    assert all(torch.equal(acc.trainable[k], t) for k, t in before.items())
    assert acc.opt_state.count == 0 and acc.opt_state.mini_step == 1
    step(acc, afrozen, halves[1])
    assert acc.opt_state.count == 1 and acc.opt_state.mini_step == 0
    for k, t in full.trainable.items():
        np.testing.assert_allclose(acc.trainable[k].detach().numpy(),
                                   t.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    jtx = jopt.make_optimizer(accum_steps=2, **kw)
    js, jfz = jts.init_train_state(jax.random.key(2), params, lora, jtx,
                                   jopt.default_trainable_pred())
    jstep = jts.make_train_step(jconfig, STEM, jtx, donate=False)
    for h in (slice(0, 2), slice(2, 4)):
        js, _ = jstep(js, jfz, {k: jnp.asarray(v[h]) for k, v in
                                batch.items()})
    jfc1 = jax.device_get(js.trainable["lora"])["encoder"]["layers"]["fc1"]
    for i, layer in enumerate(afrozen.lora["encoder"]["layers"]):
        for n in ("A", "B"):
            np.testing.assert_allclose(layer["fc1"][n].detach().numpy(),
                                       jfc1[n][i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("policy", [None, "flash_qkv"])
def test_remat_grads_equal_no_remat(fold, policy):
    """Each encoder layer under a checkpoint (full recompute, or 'flash_qkv'
    keeping q, k, v, o and lse) gives the loss and every gradient of the
    run without remat, on AdaLoRA adapters with the orthogonality loss, on
    the delta path and in the fold regime (whose merged weights and fold
    context the recompute must see again). 'flash_qkv' runs the flash
    forward once per layer; full recompute twice."""
    from neuspeech1_tpu_torch.ops import flash_attention as fa

    _, tconfig = _configs()
    jconfig, _ = _configs()
    params, lora = _weights(jconfig)
    rng = np.random.default_rng(6)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key in ("E", "B") else np.asarray(x), lora)
    config = dataclasses.replace(tconfig, flash_attention="on")
    state, frozen = _port_state(params, lora, config, topt.make_optimizer())
    from tests.test_train import make_batch

    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             jax.device_get(make_batch(jconfig, STEM)).items()}
    batch["labels"] = batch["labels"].long()
    batch["decoder_input_ids"] = batch["decoder_input_ids"].long()
    calls = [0]
    orig = fa._forward

    def counted(*a):
        calls[0] += 1
        return orig(*a)

    runs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(fa, "_forward", counted)
    try:
        for c in (config, dataclasses.replace(config, remat=True,
                                              remat_policy=policy)):
            frozen.model.config = c
            calls[0] = 0
            loss, _ = tts.make_loss_fn(c, TSTEM, orth_reg_weight=0.5,
                                       fold_lora=fold)(frozen, batch)
            leaves = [t for t in state.trainable.values() if t.requires_grad]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            runs.append((loss.item(), grads, calls[0]))
    finally:
        mp.undo()
    (l0, g0, n0), (l1, g1, n1) = runs
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    layers = config.encoder_layers
    assert n1 - n0 == (0 if policy == "flash_qkv" else layers)


def test_greedy_past_the_position_table_matches_jax():
    """The eval-WER decode asks for prompt + 48 tokens, which passes a
    small model's decoder position table (40 rows in tests/test_cli.py's
    geometry). The JAX package's reads clamp there (``lax.dynamic_slice``);
    the port's cached decoder read an empty slice and failed. Tokens past
    the table equal the JAX package's."""
    jconfig, tconfig = _configs(max_target_positions=12)
    params = jax.device_get(init_params(jax.random.key(3), jconfig, STEM))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 8.0 if p[-1].key in ("w", "token_embed") else x,
        params)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 4, 128)).astype(np.float32)
    prompt = np.tile(np.asarray([[jconfig.sot_id, jconfig.first_language_id,
                                  jconfig.transcribe_id,
                                  jconfig.notimestamps_id]], np.int32), (2, 1))
    jgen_cfg = jgen.GenerationConfig.for_model(jconfig, max_length=20)
    ref = np.asarray(jgen.greedy_decode(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(feats),
        jnp.asarray(prompt), jconfig, STEM, jgen_cfg))
    model = module_from_params(params, tconfig, TSTEM, device="cpu")
    got = tgen.greedy_decode(
        model, torch.from_numpy(feats), torch.from_numpy(prompt).long(),
        tgen.GenerationConfig.for_model(tconfig, max_length=20)).numpy()
    assert got.shape == ref.shape == (2, 20)
    np.testing.assert_array_equal(got, ref)
