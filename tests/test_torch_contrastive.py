"""The port's contrastive search (neuspeech1_tpu_torch/decode/generate.py::
contrastive_search) against the JAX package's, token for token, in f32 on
the CPU, and the cached decoder's final-LN hidden states
(``decoder_apply(return_hidden=True)``) that its degeneration penalty reads,
within the bound the JAX package holds against HF torch."""

import numpy as np
import pytest
import torch

from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.models import whisper as jw
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.models import whisper as tw
from tests.test_torch_sampling import N_NEW, _gens, _port_inputs, setup  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
SUPPRESS = (5, 6, 7, 120, 121)

CASES = {
    "alpha0.6_k2": dict(penalty_alpha=0.6, top_k=2),
    "alpha0.6_k5": dict(penalty_alpha=0.6, top_k=5),
    "alpha1_k2": dict(penalty_alpha=1.0, top_k=2),
    # the reference's strategy (utils/process_str.py:64-65)
    "alpha1_k5": dict(penalty_alpha=1.0, top_k=5),
    "alpha1_k5_rp_ngram": dict(penalty_alpha=1.0, top_k=5,
                               repetition_penalty=5.0,
                               no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_contrastive_tokens_equal_jax(setup, case):
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    length = prompt.shape[1] + N_NEW
    jgen, tgen = _gens(setup, max_length=length, suppress_ids=SUPPRESS,
                       **CASES[case])
    ref = np.asarray(jg.contrastive_search(params, feats, prompt, jconfig,
                                           jstem, jgen))
    ours = tg.contrastive_search(model, *_port_inputs(setup), tgen)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # generate dispatches it
    assert torch.equal(tg.generate(model, *_port_inputs(setup), tgen), ours)
    assert not np.isin(ours.numpy()[:, prompt.shape[1]:], SUPPRESS).any()


def test_contrastive_differs_from_greedy(setup):
    """The penalty is read: at alpha 1 the tokens are not greedy's."""
    length = setup[-1].shape[1] + N_NEW
    _, tgen = _gens(setup, max_length=length, penalty_alpha=1.0, top_k=5)
    model = setup[4]
    ours = tg.contrastive_search(model, *_port_inputs(setup), tgen)
    greedy = tg.greedy_decode(model, *_port_inputs(setup), tgen)
    assert not torch.equal(ours, greedy)


def test_decoder_hidden_equals_jax(setup):
    """The prompt's prefill at B*k rows, then two width-1 steps: the hidden
    states against JAX's, and the logits and cache equal to the call
    without ``return_hidden``."""
    jconfig, jstem, tconfig, params, model, feats, prompt = setup
    k, length = 2, prompt.shape[1] + 4
    feats_t, _ = _port_inputs(setup)
    enc_j = jw.encoder_apply(params, feats, jconfig, jstem)
    cache_j = jw.init_cache(params, enc_j, jconfig, max_len=length,
                            self_batch=3 * k)
    with torch.no_grad():
        enc_t = tw.encoder_apply(model, feats_t)
        caches = [tw.init_cache(model, enc_t, max_len=length, self_batch=3 * k)
                  for _ in range(2)]
    toks = np.repeat(prompt, k, axis=0)
    steps = [toks] + [np.full((3 * k, 1), t, np.int32) for t in (40, 41)]
    idx = 0
    for tok in steps:
        logits_j, cache_j, hid_j = jw.decoder_apply(
            params, tok, enc_j, jconfig, cache=cache_j, cache_index=idx,
            return_hidden=True)
        with torch.no_grad():
            tt = torch.from_numpy(tok.astype(np.int64))
            logits_t, caches[0], hid_t = tw.decoder_apply(
                model, tt, enc_t, cache=caches[0], cache_index=idx,
                return_hidden=True)
            logits_0, caches[1] = tw.decoder_apply(
                model, tt, enc_t, cache=caches[1], cache_index=idx)
        assert hid_t.shape == (3 * k, tok.shape[1], jconfig.d_model)
        np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(logits_t, logits_0)
        idx += tok.shape[1]
    for a, b in zip(caches[0]["self"], caches[1]["self"]):
        assert all(torch.equal(a[n], b[n]) for n in a)
