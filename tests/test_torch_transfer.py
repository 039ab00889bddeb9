"""The Schoffelen transfer recipe (scripts/reproduce_schoffelen.sh) through
the port's CLIs against the JAX package's, in f32 on the CPU.

A tiny 301-channel separable corpus in Dutch (``make_separable_corpus``),
cut by ``--channel_slice schoffelen`` to its 273 channels; a word
vocabulary of 50257 entries, the corpus's words first, which keeps
Whisper's special-token layout and its language block (Dutch is language
12); a base model over 208 channels and a 208-channel adapter (LoRA r=8
on encoder and decoder with nonzero B, and a trained stem), both written
by the JAX package. Both fine-tune CLIs take the recipe's flags
(``--lora_model <adapter> --lora_eeg_ch 208 --eeg_ch 273 --channel_slice
schoffelen --language Dutch --use_adalora True``), the port's
``init_lora`` and ``init_stem`` handed the JAX package's draws:

- the adapter is merged first and the stem re-initialized for 273
  channels, in both: the final adapters' stems are [d, 273, 3];
- per-step losses, gradient norms and the eval loss within rtol 1e-4 /
  atol 2e-4;
- each package's ``merge_lora`` on the JAX run's adapter gives the same
  full model (within 1e-6), and both eval CLIs on it at beam 5, repetition
  penalty 5.0, no-repeat-ngram 2 write the same result files byte for
  byte, as tests/test_torch_eval_cli.py compares them."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jcommon
from neuspeech1_tpu.cli.finetune import main as jax_finetune
from neuspeech1_tpu.cli.merge_lora import main as jax_merge
from neuspeech1_tpu.config import StemConfig, WhisperConfig
from neuspeech1_tpu.data.synthetic import make_separable_corpus
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.init import init_stem as jax_init_stem
from neuspeech1_tpu.models.lora import init_lora as jax_init_lora
from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from neuspeech1_tpu_torch.cli.merge_lora import main as port_merge
from neuspeech1_tpu_torch.models import init as tinit
from neuspeech1_tpu_torch.models import lora as tlora
from neuspeech1_tpu_torch.models.convert import lora_from_params
from neuspeech1_tpu_torch.perf.flagship_drive import word_vocab
from tests.test_torch_eval_cli import _scaled, run_both

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
MERGE_RTOL = MERGE_ATOL = 1e-6
GEO = dict(d_model=64, encoder_layers=1, decoder_layers=1, encoder_heads=2,
           decoder_heads=2, encoder_ffn=128, decoder_ffn=128,
           max_source_positions=80, max_target_positions=40)
GEO_FLAGS = [f"--{k}={v}" for k, v in GEO.items()]
SLICE_FLAGS = ["--eeg_ch=273", "--channel_slice=schoffelen",
               "--language=Dutch"]


def _adapter208(config):
    """A 208-channel run's adapter: LoRA r=8 on encoder and decoder with B
    at N(0, 0.05^2), and its stem in the 'model' tree."""
    lora = jax.device_get(jax_init_lora(
        jax.random.key(5), config, rank=8, alpha=16.0,
        parts=("encoder", "decoder")))
    rng = np.random.default_rng(6)

    def f(path, x):
        if path[-1].key == "B":
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    stem = jax.device_get(jax_init_stem(
        jax.random.key(7), config, StemConfig("base", in_channels=208)))
    return {"lora": jax.tree_util.tree_map_with_path(f, lora),
            "model": {"encoder": {"stem": stem}}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("transfer"))
    corpus = os.path.join(root, "corpus")
    make_separable_corpus(corpus, n_clips=10, n_channels=301, seed=17,
                          language="Dutch")
    tokenizer = word_vocab(os.path.join(root, "vocab.txt"))
    config = WhisperConfig(**GEO)
    stem = StemConfig("base", in_channels=208)
    params = _scaled(jax.device_get(init_params(jax.random.key(0), config,
                                                stem)), config)
    base = jcommon.save_full_model(os.path.join(root, "base"), params,
                                   config, stem)
    adapter = os.path.join(root, "adapter208.npz")
    jcommon.save_adapter(adapter, _adapter208(config))
    return {"root": root, "corpus": corpus, "tokenizer": tokenizer,
            "base": os.path.join(base, "params.npz"), "adapter": adapter,
            "config": config}


def _train_argv(s, out):
    return [f"--train_data={s['corpus']}/train.jsonl",
            f"--val_data={s['corpus']}/val.jsonl",
            f"--base_model={s['base']}", f"--tokenizer={s['tokenizer']}",
            f"--lora_model={s['adapter']}", "--lora_eeg_ch=208",
            *SLICE_FLAGS, "--use_adalora=True", "--max_audio_len=1.6",
            "--min_audio_len=0.5", "--max_steps=3",
            "--per_device_train_batch_size=2", "--learning_rate=0.01",
            "--warmup_steps=1", "--eval_steps=3", "--save_steps=3",
            "--logging_steps=1", "--label_max_length=24", "--bf16=False",
            "--remat=False", "--mesh_data=1", "--adalora_tinit=1",
            "--adalora_tfinal=1", "--adalora_deltaT=1", "--num_workers=1",
            # the threaded loader's numpy batch order, the same in both
            # packages (the port's device cache draws its own)
            "--device_cache=off", f"--output_dir={out}", *GEO_FLAGS]


def _jax_draws(monkeypatch):
    """The port's ``init_lora`` and ``init_stem`` hand back the JAX
    package's draws for the same seeds."""
    def init_lora(config, rank=32, alpha=64.0, adalora=False, seed=1,
                  device="cpu", layer_range=None, **kw):
        jconfig = WhisperConfig(**dataclasses.asdict(config))
        tree = jax.device_get(jax_init_lora(
            jax.random.key(seed), jconfig, rank=rank, alpha=alpha,
            adalora=adalora, layer_range=layer_range, **kw))
        return lora_from_params(tree, device=device)

    def init_stem(config, stem, seed=0, generator=None):
        assert generator is None
        tree = jax_init_stem(jax.random.key(seed),
                             WhisperConfig(**dataclasses.asdict(config)),
                             StemConfig(**dataclasses.asdict(stem)))
        return jax.tree_util.tree_map(lambda x: torch.from_numpy(
            np.array(x)), jax.device_get(tree))

    monkeypatch.setattr(tlora, "init_lora", init_lora)
    monkeypatch.setattr(tinit, "init_stem", init_stem)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = next(a.split("=", 1)[1] for a in argv
               if a.startswith("--output_dir="))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f], buf.getvalue()


@pytest.fixture(scope="module")
def runs(setup):
    mp = pytest.MonkeyPatch()
    _jax_draws(mp)
    try:
        out = {k: os.path.join(setup["root"], f"ft_{k}")
               for k in ("jax", "port")}
        res = {"jax": _run(jax_finetune, _train_argv(setup, out["jax"])),
               "port": _run(port_finetune, _train_argv(setup, out["port"])
                            + ["--device=cpu"])}
    finally:
        mp.undo()
    return out, res


def test_both_merge_the_adapter_and_reinitialize_the_stem(runs):
    out, res = runs
    for k in ("jax", "port"):
        assert "stem re-initialized: 208 -> 273 channels" in res[k][1], k
    stems = {k: np.load(os.path.join(v, "adapter_final.npz"))[
        "model/encoder/stem/conv_a/w"] for k, v in out.items()}
    # the trained stems' values part where AdamW's first steps (lr times
    # the gradient's sign) meet gradients near 0; the re-initialized stem
    # they start from is held by the first step's loss (test_losses_match)
    assert stems["port"].shape == stems["jax"].shape == (64, 273, 3)


def test_losses_match_jax(runs):
    _, res = runs
    jr, tr = res["jax"][0], res["port"][0]
    steps = [r for r in jr if "loss" in r]
    got = [r for r in tr if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in steps] == [1, 2, 3]
    for a, b in zip(got, steps):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {a['step']} {k}")
    evals = [(a, b) for a, b in zip(tr, jr) if "eval_loss" in a]
    assert evals
    for a, b in evals:
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], rtol=RTOL,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def merged(setup, runs):
    """Each package's merge_lora on the JAX run's final adapter."""
    out, _ = runs
    argv = [f"--lora_model={out['jax']}/adapter_final.npz",
            f"--base_model={setup['base']}",
            f"--tokenizer={setup['tokenizer']}", "--eeg_ch=273", *GEO_FLAGS]
    root = setup["root"]
    dirs = {"jax": jax_merge(argv + [f"--output_dir={root}/merged_jax"]),
            "port": port_merge(argv + ["--device=cpu",
                                       f"--output_dir={root}/merged_port"])}
    for d in dirs.values():  # the eval CLIs decode in f32
        path = os.path.join(d, "config.json")
        meta = json.load(open(path))
        meta["config"]["dtype"] = "float32"
        json.dump(meta, open(path, "w"))
    return dirs


def test_merges_agree(merged):
    got = np.load(os.path.join(merged["port"], "params.npz"))
    ref = np.load(os.path.join(merged["jax"], "params.npz"))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_allclose(got[k], ref[k], rtol=MERGE_RTOL,
                                   atol=MERGE_ATOL, err_msg=k)
    assert got["encoder/stem/conv_a/w"].shape == (64, 273, 3)
    with open(os.path.join(merged["port"], "config.json")) as f:
        assert json.load(f)["stem"]["in_channels"] == 273


@pytest.mark.parametrize("merged_by", ["jax", "port"])
def test_eval_clis_write_the_same_files(setup, merged, merged_by):
    argv = [f"--test_data={setup['corpus']}/all.jsonl",
            f"--model_path={merged[merged_by]}",
            f"--tokenizer={setup['tokenizer']}", *SLICE_FLAGS,
            "--max_audio_len=1.6", "--num_beams=5",
            "--repetition_penalty=5.0", "--no_repeat_ngram_size=2",
            "--batch_size=4", "--max_new_tokens=8", "--per_sentence=True"]
    out, metrics = run_both(setup, argv, f"eval_{merged_by}")
    assert sorted(os.listdir(out)) == sorted([
        "all_beam5.json", "all_beam5.jsonl", "all_beam5_per_sentence.jsonl",
        "all_beam5.txt"])
    assert np.isfinite(float(metrics["wer"]))
