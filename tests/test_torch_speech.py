"""The port's speech modality against the JAX package's, in f32 on the CPU,
on a corpus with 16 kHz wavs and a whisper geometry with the ``speech``
stem (80 mel bins, 3000 frames -> 1500 positions; one layer each, d_model
64, as tests/test_cli.py runs the speech eval):

- ``SpeechDataset`` items (log-mel features, labels) bit for bit;
- the speech eval CLI (cli/evaluation_speech.py) on a full-model directory
  written by the JAX package's ``save_full_model`` and on a base npz: the
  result files byte for byte, the metrics exactly.

`tests/test_torch_speech_finetune.py` holds ``--modal=speech`` fine-tuning
on the same corpus and model."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jcommon
from neuspeech1_tpu.cli.evaluation_speech import main as jax_eval
from neuspeech1_tpu.config import StemConfig, WhisperConfig
from neuspeech1_tpu.data.dataset import SpeechDataset as JSpeechDataset
from neuspeech1_tpu.data.synthetic import _WORDS, make_synthetic_corpus
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jax_tokenizer
from neuspeech1_tpu_torch.cli.evaluation_speech import main as port_eval
from neuspeech1_tpu_torch.data.dataset import SpeechDataset
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer
from tests.test_torch_eval_cli import _scaled

torch.set_num_threads(1)

GEO = dict(d_model=64, encoder_layers=1, decoder_layers=1, encoder_heads=2,
           decoder_heads=2, encoder_ffn=128, decoder_ffn=128,
           max_source_positions=1500, max_target_positions=40)
GEO_FLAGS = [f"--{k}={v}" for k, v in GEO.items()]


def make_speech_setup(root):
    """8 clips of 0.5-1 s with their wavs (6 train, 1 val, 1 test), a word
    vocabulary of the corpus's words, and a speech-stem model computing in
    f32 as a full-model directory and its npz."""
    corpus = os.path.join(root, "corpus")
    make_synthetic_corpus(corpus, n_clips=8, n_channels=2, seed=5,
                          min_dur=0.5, max_dur=1.0, with_audio=True)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(_WORDS) + "\n")
    config = WhisperConfig(**GEO, **WhisperConfig.layout_for_vocab(
        len(_WORDS)))
    stem = StemConfig("speech")
    params = _scaled(jax.device_get(init_params(jax.random.key(0), config,
                                                stem)), config)
    model_dir = jcommon.save_full_model(os.path.join(root, "full"), params,
                                        config, stem)
    meta = json.load(open(os.path.join(model_dir, "config.json")))
    meta["config"]["dtype"] = "float32"
    json.dump(meta, open(os.path.join(model_dir, "config.json"), "w"))
    return {"root": root, "corpus": corpus, "model_dir": model_dir,
            "tokenizer": f"word:{vocab}", "config": config}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_speech_setup(str(tmp_path_factory.mktemp("speech")))


# --------------------------------------------------------------------------
# SpeechDataset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("language,task", [("English", "transcribe"),
                                           (None, "translate")])
def test_speech_dataset_items_equal_jax_package(setup, language, task):
    manifest = os.path.join(setup["corpus"], "all.jsonl")
    spec = setup["tokenizer"]
    got = SpeechDataset(manifest, make_tokenizer(spec), language=language,
                        task=task, mode="train")
    ref = JSpeechDataset(manifest, jax_tokenizer(spec), language=language,
                         task=task, mode="train")
    assert len(got) == len(ref) == 8
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert a["input_features"].dtype == np.float32
        assert a["input_features"].shape == (80, 3000)
        np.testing.assert_array_equal(a["input_features"],
                                      b["input_features"])
        assert list(a["labels"]) == list(b["labels"])
        assert got.text(i) == ref.text(i)
    # the clips differ: their features do too
    assert not np.array_equal(got[0]["input_features"],
                              got[1]["input_features"])


# --------------------------------------------------------------------------
# the speech eval CLI
# --------------------------------------------------------------------------

EVAL_CASES = {
    # the CLI's defaults (beam 5, punctuation removed) but the budget, at
    # a batch size that leaves a partial last batch
    "defaults": lambda s: [f"--model_path={s['model_dir']}",
                           "--batch_size=3"],
    "greedy_penalties": lambda s: [
        f"--model_path={s['model_dir']}", "--num_beams=1",
        "--repetition_penalty=2.0", "--no_repeat_ngram_size=2",
        "--remove_pun=False", "--suppress_tokens=none"],
    "base_model": lambda s: [
        f"--base_model={s['model_dir']}/params.npz", "--bf16=False",
        "--num_beams=2", "--batch_size=8", *GEO_FLAGS],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_speech_eval_cli_writes_the_jax_files(setup, case):
    argv = [f"--test_data={setup['corpus']}/all.jsonl",
            f"--tokenizer={setup['tokenizer']}", "--max_new_tokens=8",
            *EVAL_CASES[case](setup)]
    out = {k: os.path.join(setup["root"], f"eval_{k}_{case}")
           for k in ("jax", "port")}
    m_j = jax_eval(argv + [f"--output_dir={out['jax']}"])
    m_t = port_eval(argv + ["--device=cpu", f"--output_dir={out['port']}"])
    files = sorted(os.listdir(out["jax"]))
    assert files == sorted(os.listdir(out["port"])) == [
        "all_speech.json", "all_speech.jsonl", "all_speech.txt"]
    for name in files:
        with open(os.path.join(out["jax"], name), "rb") as a, \
                open(os.path.join(out["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert {k: float(v) for k, v in m_t.items()} == \
        {k: float(v) for k, v in m_j.items()}
    with open(os.path.join(out["port"], "all_speech.jsonl")) as f:
        preds = [json.loads(ln)["pred"] for ln in f]
    assert len(preds) == 8 and any(preds)


def test_speech_eval_cli_refuses_cuda_without_it(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        port_eval([f"--test_data={setup['corpus']}/all.jsonl",
                   f"--model_path={setup['model_dir']}",
                   f"--output_dir={tmp_path}"])
    assert not os.listdir(tmp_path)
