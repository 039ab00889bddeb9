"""The port's self-speculative greedy decoding
(neuspeech1_tpu_torch/decode/spec.py) against the JAX package, in f32 on
the CPU: the drafters and the draft table exactly, then tokens and
iteration counts of ``spec_greedy_decode`` exactly, its tokens against the
port's own greedy decoding, the dispatch in ``generate`` and the
Transcriber's spec options."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jax_common
from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.decode import spec as jspec
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer
from neuspeech1_tpu_torch.data.manifest import read_jsonlines
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.decode import spec as tspec
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.serve import Transcriber
from tests.test_torch_decode import scaled_params, tiny
from tests.test_torch_whisper import port

torch.set_num_threads(1)


class IdTokenizer:
    """Texts of space-separated token ids: a corpus made of decoded outputs
    drafts exactly those outputs."""

    def encode(self, text):
        return [int(w) for w in text.split()]


@pytest.fixture(scope="module")
def setup():
    config, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    feats = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    prompt = np.asarray([ByteTokenizer(config).prefix_tokens()] * 3, np.int32)
    model = module_from_params(params, port(config), port(stem), device="cpu")
    return config, stem, params, model, feats, prompt


def _greedy(setup, max_length, **kw):
    config, _, _, model, feats, prompt = setup
    gen = tg.GenerationConfig.for_model(port(config), max_length=max_length,
                                        **kw)
    return tg.greedy_decode(model, torch.from_numpy(feats),
                            torch.from_numpy(prompt.astype(np.int64)), gen)


@pytest.fixture(scope="module")
def corpus(setup):
    """Texts of the greedy outputs past the prompt (the drafts then hold
    whole runs), beside two unrelated ones."""
    p = setup[-1].shape[1]
    rows = _greedy(setup, p + 16)[:, p:].tolist()
    return [" ".join(map(str, r)) for r in rows] + ["1 2 3 1 2 4", "7 7 7"]


def _tables(corpus, vocab):
    """The same table from both packages, each in its own array types."""
    jt = jspec.build_draft_table(corpus, IdTokenizer(), vocab)
    tt = tspec.build_draft_table(corpus, IdTokenizer(), vocab)
    return ({k: jnp.asarray(v) for k, v in jt.items()},
            {k: torch.from_numpy(v) for k, v in tt.items()})


def _histories(rng, b, length, vocab):
    """Fuzzed decode buffers: rows of a few distinct ids (so that pairs
    recur), each with its own length, the last token, pad past it."""
    out = rng.integers(0, 5, (b, length)) * (vocab // 7) + 3
    out_len = rng.integers(1, length + 1, b)
    out_len[0] = 1  # no pair context: prev2 < 0
    for i, n in enumerate(out_len):
        out[i, n:] = vocab - 1
    t_last = out[np.arange(b), out_len - 1]
    return out, out_len, t_last


@pytest.mark.parametrize("vocab", [97, 51865])
def test_drafters_equal_jax(vocab):
    """_ngram_draft, _table_draft and build_draft_table on fuzzed histories,
    at a small vocabulary and at whisper's, where pair codes pass 2^31; an
    empty-trigram table holds the sentinel row."""
    rng = np.random.default_rng(vocab)
    out, out_len, t_last = _histories(rng, 16, 12, vocab)
    corpus = [" ".join(map(str, r)) for r in out[:8, :10]]
    empty = ["3 4"]
    for texts in (corpus, empty):
        jt = jspec.build_draft_table(texts, IdTokenizer(), vocab)
        tt = tspec.build_draft_table(texts, IdTokenizer(), vocab)
        assert tt["keys"].dtype == np.int64
        np.testing.assert_array_equal(tt["keys"], jt["keys"].astype(np.int64))
        np.testing.assert_array_equal(tt["vals"], jt["vals"])
        np.testing.assert_array_equal(tt["uni"], jt["uni"])
        if texts is empty:
            assert tt["keys"].tolist() == [tspec.NO_MATCH_CODE]
        elif vocab > 46341:
            assert tt["keys"].max() > 2 ** 31
        for gamma in (2, 4):
            j_in = (jnp.asarray(out, jnp.int32), jnp.asarray(out_len, jnp.int32),
                    jnp.asarray(t_last, jnp.int32))
            t_in = tuple(torch.from_numpy(np.asarray(x, np.int64))
                         for x in (out, out_len, t_last))
            ref = jspec._table_draft(*j_in, gamma,
                                     {k: jnp.asarray(v) for k, v in jt.items()})
            ours = tspec._table_draft(*t_in, gamma,
                                      {k: torch.from_numpy(v)
                                       for k, v in tt.items()})
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
            ref = jspec._ngram_draft(*j_in, gamma)
            ours = tspec._ngram_draft(*t_in, gamma)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_draft_table_refuses_a_vocab_past_uint32_codes():
    with pytest.raises(ValueError, match="65535"):
        tspec.build_draft_table(["1 2 3"], IdTokenizer(), 65536)


# (gamma, max_length, drafter, eos from the greedy output): every gamma and
# both lengths with each drafter; one case with a mid-sequence eos
SPEC_CASES = [(2, 10, "self", None), (3, 10, "table", None),
              (4, 10, "self", None), (2, 20, "table", None),
              (3, 20, "self", 6), (4, 20, "table", 6)]


@pytest.mark.parametrize("gamma,max_length,drafter,eos", SPEC_CASES)
def test_spec_tokens_and_iterations_equal_jax(setup, corpus, gamma,
                                              max_length, drafter, eos):
    config, stem, params, model, feats, prompt = setup
    p = prompt.shape[1]
    kw = {}
    if eos is not None:
        # row 0's token at that generated position: rows finish mid-loop
        kw["eos_id"] = int(_greedy(setup, max_length)[0, p + eos])
    jtab, ttab = _tables(corpus, config.vocab_size) if drafter == "table" \
        else (None, None)
    ref, ref_iters = jspec.spec_greedy_decode(
        params, feats, prompt, config, stem,
        jg.GenerationConfig.for_model(config, max_length=max_length, **kw),
        gamma=gamma, draft_table=jtab)
    gen = tg.GenerationConfig.for_model(port(config), max_length=max_length,
                                        **kw)
    ours, iters = tspec.spec_greedy_decode(
        model, torch.from_numpy(feats),
        torch.from_numpy(prompt.astype(np.int64)), gen, gamma=gamma,
        draft_table=ttab)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert iters == int(ref_iters)
    np.testing.assert_array_equal(ours.numpy(),
                                  _greedy(setup, max_length, **kw).numpy())
    if drafter == "table":
        # the table holds the greedy runs: nearly every draft is accepted,
        # gamma tokens per iteration after the prefill's one
        assert iters <= -(-(max_length - p - 1) // gamma) + 2


def test_generate_dispatches_spec_and_checks_options(setup):
    config, _, _, model, feats, prompt = setup
    args = (model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)))
    gen = tg.GenerationConfig.for_model(port(config), max_length=14,
                                        spec_gamma=3)
    np.testing.assert_array_equal(tg.generate(*args, gen).numpy(),
                                  _greedy(setup, 14).numpy())
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        tg.generate(*args, tg.GenerationConfig.for_model(
            port(config), max_length=14, spec_gamma=2,
            repetition_penalty=5.0))
    with pytest.raises(NotImplementedError, match="only applies to plain"):
        tg.generate(*args, tg.GenerationConfig.for_model(
            port(config), max_length=14, spec_gamma=2, num_beams=3))
    with pytest.raises(ValueError, match="gamma must be >= 2"):
        tspec.spec_greedy_decode(*args, gen, gamma=1)


@pytest.fixture(scope="module")
def model_dir(setup, tmp_path_factory):
    """A full-model directory written by the JAX package, set to compute in
    f32 with its Pallas flash kernel on, and a training manifest whose
    sentences the draft table is built from."""
    config, stem, params, *_ = setup
    root = tmp_path_factory.mktemp("spec_model")
    out = jax_common.save_full_model(str(root / "full_model"), params, config,
                                     stem)
    with open(f"{out}/config.json") as f:
        meta = json.load(f)
    meta["config"].update(dtype="float32", flash_attention="on")
    with open(f"{out}/config.json", "w") as f:
        json.dump(meta, f)
    manifest = root / "train.jsonl"
    rows = [{"sentence": s} for s in ("the cat sat on the mat",
                                      "the dog sat on the log", "abcabcabc")]
    manifest.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    return out, str(manifest)


def test_spec_transcriber_texts_equal_jax(model_dir):
    """Transcriber(spec_gamma=2, spec_draft_from=...) in both packages, with
    a short clip and a last chunk padded to the batch."""
    path, manifest = model_dir
    assert [r["sentence"] for r in read_jsonlines(manifest)][1] == \
        "the dog sat on the log"
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0
    kw = dict(batch_size=2, max_new_tokens=12, spec_gamma=2,
              spec_draft_from=manifest)
    ref = JaxTranscriber(path, **kw).transcribe(signals)
    ours = Transcriber(path, device="cpu", **kw).transcribe(signals)
    assert len(ours) == 3 and any(ours)
    assert ours == ref
    assert ours == Transcriber(path, device="cpu", batch_size=2,
                               max_new_tokens=12).transcribe(signals)
    with pytest.raises(ValueError, match="only applies to plain"):
        Transcriber(path, device="cpu", spec_gamma=2, num_beams=5)
