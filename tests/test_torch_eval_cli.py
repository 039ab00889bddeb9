"""The port's eval CLI (neuspeech1_tpu_torch/cli/evaluation.py) against the
JAX package's on the same argv, in f32 on the CPU: the result files
(.txt, .jsonl, _per_sentence.jsonl, .json) equal byte for byte, the returned
metrics exactly. Models: a full-model directory written by the JAX
package's `save_full_model` and adapters from its `init_lora` with nonzero
B (LoRA and AdaLoRA). `tests/test_torch_eval_controls.py` holds the
controls, the speculative decode and the refusals."""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jcommon
from neuspeech1_tpu.cli.evaluation import main as jax_main
from neuspeech1_tpu.config import StemConfig, WhisperConfig
from neuspeech1_tpu.data.synthetic import _WORDS, make_synthetic_corpus
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.models.lora import init_lora
from neuspeech1_tpu_torch.cli.evaluation import main as port_main

torch.set_num_threads(1)

GEO = dict(d_model=64, encoder_layers=1, decoder_layers=1, encoder_heads=2,
           decoder_heads=2, encoder_ffn=128, decoder_ffn=128,
           max_source_positions=32, max_target_positions=40)


def _scaled(params, config):
    """init_params weights with the matrices and embeddings scaled by 4 and
    the stem, conv2 and cross-attention by 16 more, so that the tokens
    depend on the input, and the embeddings of the special tokens past eot
    zeroed (their logits 0), so that the decode emits words."""
    def f(path, x):
        keys = [getattr(k, "key", None) for k in path]
        m = 4.0 if keys[-1] in ("w", "token_embed") else 1.0
        if {"cross_attn", "stem", "conv2"} & set(keys):
            m *= 4.0
        return x * m

    params = jax.tree_util.tree_map_with_path(f, params)
    params["decoder"]["token_embed"][config.eot_id + 1:] = 0.0
    return params


def _adapter(config, adalora: bool):
    """A decoder+encoder adapter with nonzero B (and E), plus a stem
    override in the adapter's 'model' tree."""
    lora = jax.device_get(init_lora(
        jax.random.key(1), config, rank=4, alpha=8.0,
        parts=("encoder", "decoder"), adalora=adalora))
    rng = np.random.default_rng(3)

    def f(path, x):
        if path[-1].key in ("B", "E"):
            return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    stem = {"conv_a": {"b": np.full((config.d_model,), 0.05, np.float32)}}
    return {"lora": jax.tree_util.tree_map_with_path(f, lora),
            "model": {"encoder": {"stem": stem}}}


def make_eval_setup(root):
    """A corpus of 8 clips over 4 channels, a word vocabulary of its words,
    a full-model directory computing in f32 (``dtype`` in config.json), its
    npz, and LoRA and AdaLoRA adapter npz files."""
    corpus = os.path.join(root, "corpus")
    make_synthetic_corpus(corpus, n_clips=8, n_channels=4, seed=5,
                          max_dur=0.6, min_dur=0.5, with_audio=False)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(_WORDS) + "\n")
    config = WhisperConfig(**GEO, **WhisperConfig.layout_for_vocab(
        len(_WORDS)))
    stem = StemConfig("base", in_channels=4)
    params = _scaled(jax.device_get(init_params(jax.random.key(0), config,
                                                stem)), config)
    model_dir = jcommon.save_full_model(os.path.join(root, "full"), params,
                                        config, stem)
    meta = json.load(open(os.path.join(model_dir, "config.json")))
    meta["config"]["dtype"] = "float32"
    json.dump(meta, open(os.path.join(model_dir, "config.json"), "w"))
    for name, ada in (("lora", False), ("adalora", True)):
        jcommon.save_adapter(os.path.join(root, f"{name}.npz"),
                             _adapter(config, ada))
    common = [f"--test_data={corpus}/all.jsonl", f"--tokenizer=word:{vocab}",
              "--eeg_ch=4", "--batch_size=3", "--max_new_tokens=10",
              "--max_audio_len=0.64", "--per_sentence=True"]
    base = [f"--base_model={model_dir}/params.npz", "--bf16=False",
            *[f"--{k}={v}" for k, v in GEO.items()]]
    return {"root": root, "corpus": corpus, "model_dir": model_dir,
            "common": common, "base": base}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_eval_setup(str(tmp_path_factory.mktemp("eval_cli")))


def run_both(setup, argv, tag, port_extra=()):
    """Both CLIs on ``argv`` into their own output directories; asserts the
    same files byte for byte and the same metrics; returns the port's
    output directory and metrics."""
    out_j = os.path.join(setup["root"], f"jax_{tag}")
    out_t = os.path.join(setup["root"], f"port_{tag}")
    m_j = jax_main(list(argv) + [f"--output_dir={out_j}"])
    m_t = port_main(list(argv) + list(port_extra)
                    + ["--device=cpu", f"--output_dir={out_t}"])
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    assert any(f.endswith("_per_sentence.jsonl") for f in files)
    for name in files:
        assert filecmp.cmp(os.path.join(out_j, name),
                           os.path.join(out_t, name), shallow=False), name
    assert {k: float(v) for k, v in m_t.items()} == \
        {k: float(v) for k, v in m_j.items()}
    return out_t, m_t


def preds(out_dir):
    name = next(f for f in os.listdir(out_dir)
                if f.endswith(".jsonl") and "per_sentence" not in f)
    return [json.loads(ln)["pred"]
            for ln in open(os.path.join(out_dir, name), encoding="utf-8")]


CASES = {
    # the eval defaults: beam 5, rp 5.0, ngram 2, on a full-model directory
    "defaults": lambda s: [f"--model_path={s['model_dir']}"],
    "lora": lambda s: s["base"] + [f"--lora_model={s['root']}/lora.npz"],
    "adalora": lambda s: s["base"] + [
        f"--lora_model={s['root']}/adalora.npz"],
    "sequence_bias": lambda s: [
        f"--model_path={s['model_dir']}", "--sequence_bias=True",
        f"--train_data={s['corpus']}/train.jsonl", "--bias_weight=3.0"],
    "prompt_text": lambda s: [f"--model_path={s['model_dir']}",
                              "--prompt_text=the quick brown fox"],
    "prompt_from_labels": lambda s: [f"--model_path={s['model_dir']}",
                                     "--prompt_from_labels=True"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_files_equal_jax(setup, case):
    out, metrics = run_both(setup, setup["common"] + CASES[case](setup), case)
    ps = preds(out)
    assert len(ps) == 8 and any(ps)
    assert metrics["wer"] > 0
    if case == "prompt_text":
        assert not any(p.startswith("the quick brown fox") for p in ps)


def test_adapters_and_bias_change_the_decode(setup):
    """The cases above would pass with adapters or a bias that did
    nothing: their predictions differ from the plain model's."""
    def port_preds(case):
        out = os.path.join(setup["root"], f"port_{case}")
        if not os.path.isdir(out):  # its case was deselected
            run_both(setup, setup["common"] + CASES[case](setup), case)
        return preds(out)

    plain = port_preds("defaults")
    for case in ("lora", "adalora", "sequence_bias"):
        assert port_preds(case) != plain, case
