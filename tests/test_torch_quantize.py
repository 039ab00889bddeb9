"""The port's int8 weight quantization (neuspeech1_tpu_torch/models/
quantize.py) against the JAX package's, on the CPU: the quantized tree and
its round trip bit for bit, the error metric exactly, and greedy and beam
serving on int8 weights (``Transcriber(int8_weights=True)``) with the JAX
Transcriber's texts."""

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.models import quantize as jq
from neuspeech1_tpu.serve import Transcriber as JaxTranscriber
from neuspeech1_tpu_torch.cli import common
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.models import quantize as tq
from neuspeech1_tpu_torch.serve import Transcriber
from tests.test_torch_sampling import N_NEW, setup  # noqa: F401
from tests.test_torch_timestamps import model_dir  # noqa: F401


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _with_edges(params):
    """The weights with an all-zero column, a column of one value and
    entries at exact half-steps of their column's scale, so that the scale
    1 of a zero column and rounding half to even both show."""
    params = jax.tree_util.tree_map(np.array, params)
    w = params["decoder"]["layers"]["fc1"]["w"]        # [L, d_in, d_out]
    w[:, :, 0] = 0.0
    w[:, :, 1] = 0.25
    w[:, :, 2] = 0.0
    w[:, 0, 2] = 127.0
    w[:, 1:6, 2] = [0.5, 1.5, 2.5, -0.5, -2.5]
    return params


def test_quantize_params_equal_jax(setup):
    params = _with_edges(setup[3])
    ref = jax.device_get(jq.quantize_params(params))
    ours = tq.quantize_params(params)
    got, want = dict(_leaves(ours)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    quantized = [n for n in got if n.endswith("/w_int8")]
    # every stacked linear of both stacks; the stem and conv2 stay dense
    assert len(quantized) == 16   # 6 encoder and 10 decoder linears
    assert not any("/stem/" in n or "/conv2/" in n for n in quantized)
    q = ours["decoder"]["layers"]["fc1"]["w_int8"]
    assert (q[:, 1:6, 2] == [0, 2, 2, 0, -2]).all()   # half to even
    assert (ours["decoder"]["layers"]["fc1"]["w_scale"][:, 0, 0] == 1.0).all()

    back = tq.dequantize_params(ours)
    back_ref = jax.device_get(jq.dequantize_params(ref, dtype=np.float32))
    got, want = dict(_leaves(back)), dict(_leaves(back_ref))
    assert got.keys() == want.keys() == dict(_leaves(params)).keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    attn = ours["decoder"]["layers"]["self_attn"]["q"]
    x, s = attn["w_int8"][:1, :3, :4], attn["w_scale"][:1, :, :4]
    np.testing.assert_array_equal(
        tq.dequantize_int8(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jq.dequantize_int8(x, s)))


def test_quantization_error_equals_jax(setup):
    params = setup[3]
    err = tq.quantization_error(params)
    assert err == jq.quantization_error(params)
    assert 0.0 < err < 0.02


@pytest.mark.parametrize("kw", [
    dict(), dict(num_beams=3, repetition_penalty=5.0,
                 no_repeat_ngram_size=2),
    dict(int8_kv_cache=True)])
def test_int8_weights_transcriber_equals_jax(model_dir, kw):  # noqa: F811
    """Both Transcribers with ``int8_weights``: the same texts, and the
    same tokens from their served weights on the same clips."""
    signals = np.random.default_rng(0).standard_normal(
        (3, 8, 400)).astype(np.float32)
    signals[1, :, 200:] = 0.0
    kw = dict(kw, batch_size=3, max_new_tokens=N_NEW, int8_weights=True)
    jtr = JaxTranscriber(model_dir, **kw)
    tr = Transcriber(model_dir, device="cpu", **kw)
    assert tr.transcribe(signals) == jtr.transcribe(signals)
    feats = jtr._prepare(signals)
    prompt = np.repeat(jtr.prompt, 3, axis=0)
    ref = np.asarray(jg.generate(jtr.params, feats, prompt, jtr.config,
                                 jtr.stem, jtr.gen))
    ours = tg.generate(tr.model, torch.from_numpy(feats),
                       torch.from_numpy(prompt.astype(np.int64)), tr.gen)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert len({tuple(r) for r in ref[:, prompt.shape[1]:]}) > 1
    # the served weights are the round trip's, not the stored ones
    params, _, _ = common.load_full_model(model_dir)
    served = tr.model.decoder.layers[0].fc1.weight.detach().numpy().T
    stored = params["decoder"]["layers"]["fc1"]["w"][0]
    assert not np.array_equal(served, stored)
    np.testing.assert_array_equal(
        served, tq.dequantize_params(tq.quantize_params(params))[
            "decoder"]["layers"]["fc1"]["w"][0])
