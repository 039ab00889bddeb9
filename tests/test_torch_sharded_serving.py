"""Sharded serving in the port (decode/generate.py::generate_over_mesh and
serve.py's ``Transcriber(mesh=)``) in f32 on the CPU, the ranks as
LocalRing threads, token for token:

- greedy decoding with the batch split over {data: 2} against the JAX
  package's greedy decode on weights and features placed on its data mesh
  (tests/test_decode.py's test_generate_with_sharded_params);
- greedy and beam search with the weights split over {tensor: 2} (K6 and
  K7's plain versions on the local heads of the caches), alone and beside
  {data: 2}, against the port's one-rank decode, every rank returning the
  whole batch;
- sampling with the batch split over {data: 2}: each step's noise drawn for
  the whole batch, so the tokens are the one-rank call's;
- the Transcriber on a {data: 2, tensor: 2} mesh against one without,
  its token timestamps (on the weights gathered whole) included;
- greedy and beam search with the rows split over {fsdp: 2}, whose ranks
  stop together."""

import copy

import jax
import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import StemConfig
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.parallel.mesh import batch_sharding, make_mesh
from neuspeech1_tpu.parallel.sharding import shard_params as jax_shard
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel import sharding
from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
from neuspeech1_tpu_torch.serve import Transcriber
from tests.test_torch_decode import model_dir, scaled_params, setup, tiny  # noqa: F401
from tests.test_torch_whisper import port

torch.set_num_threads(1)

ROWS = 4


@pytest.fixture(scope="module")
def inputs():
    config, stem = tiny(), StemConfig("base", in_channels=8)
    params = scaled_params(config, stem)
    feats = np.random.default_rng(0).standard_normal(
        (ROWS, 8, 400)).astype(np.float32)
    prompt = np.asarray([ByteTokenizer(config).prefix_tokens()] * ROWS,
                        np.int32)
    model = module_from_params(params, port(config), port(stem), device="cpu")
    return (config, stem, params, model, torch.from_numpy(feats),
            torch.from_numpy(prompt.astype(np.int64)))


def _decode_on_mesh(model, feats, prompt, gen, **axes):
    """Every rank's tokens of `generate_over_mesh` on its own split copy of
    ``model``."""
    def rank(mesh):
        with pmesh.set_mesh(mesh):
            return tg.generate_over_mesh(
                sharding.shard_params(copy.deepcopy(model)), feats, prompt,
                gen, generator=torch.Generator().manual_seed(3))
    return LocalRing.run_mesh(rank, **axes)


def test_greedy_over_a_data_mesh_equals_jax(inputs):
    config, stem, params, model, feats, prompt = inputs
    mesh = make_mesh(data=2)
    ref = np.asarray(jg.greedy_decode(
        jax_shard(mesh, params),
        jax.device_put(feats.numpy(), batch_sharding(mesh)),
        prompt.numpy().astype(np.int32), config, stem,
        jg.GenerationConfig.for_model(config, max_length=20)))
    gen = tg.GenerationConfig.for_model(port(config), max_length=20)
    for out in _decode_on_mesh(model, feats, prompt, gen, data=2):
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("axes", [{"tensor": 2}, {"data": 2, "tensor": 2}],
                         ids=["tensor", "data_tensor"])
@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam"])
def test_tensor_split_decode_equals_one_rank(inputs, axes, beams):
    config, _, _, model, feats, prompt = inputs
    gen = tg.GenerationConfig.for_model(port(config), max_length=20,
                                        num_beams=beams)
    ref = tg.generate(model, feats, prompt, gen)
    for out in _decode_on_mesh(model, feats, prompt, gen, **axes):
        assert torch.equal(out, ref)


def test_sampling_over_a_data_mesh_draws_the_whole_batch(inputs):
    config, _, _, model, feats, prompt = inputs
    gen = tg.GenerationConfig.for_model(port(config), max_length=16,
                                        do_sample=True, top_k=20)
    ref = tg.generate(model, feats, prompt, gen,
                      generator=torch.Generator().manual_seed(3))
    for out in _decode_on_mesh(model, feats, prompt, gen, data=2):
        assert torch.equal(out, ref)


def test_transcriber_on_a_mesh_equals_one_rank(model_dir):  # noqa: F811
    signals = np.random.default_rng(5).standard_normal(
        (3, 8, 400)).astype(np.float32)
    kw = dict(batch_size=2, max_new_tokens=10, device="cpu")
    one = Transcriber(model_dir, **kw)
    ref = one.transcribe(signals), one.transcribe_with_timestamps(
        signals[:1])

    def rank(mesh):
        tr = Transcriber(model_dir, mesh=mesh, **kw)
        return tr.transcribe(signals), tr.transcribe_with_timestamps(
            signals[:1])

    for got in LocalRing.run_mesh(rank, data=2, tensor=2):
        assert got == ref


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam"])
def test_fsdp_ranks_decode_until_every_rank_is_done(inputs, beams):
    """Over {fsdp: 2} each rank decodes its own rows but gathers every
    weight with the other, so both leave the loop together, with the
    one-rank tokens. With eos set to the first token greedy decoding gives
    row 0, greedy's rank 0 (rows 0, 1) is done after the first step and
    rank 1 (rows 2, 3) one step later: a rank that left alone would leave
    the other waiting in its next gather."""
    config, _, _, model, feats, prompt = inputs
    gen = tg.GenerationConfig.for_model(port(config), max_length=20,
                                        num_beams=beams)
    free = tg.generate(model, feats, prompt, gen)
    eos = int(free[0, prompt.shape[1]])
    gen = tg.GenerationConfig.for_model(port(config), max_length=20,
                                        num_beams=beams, eos_id=eos)
    ref = tg.generate(model, feats, prompt, gen)
    for out in _decode_on_mesh(model, feats, prompt, gen, fsdp=2):
        assert torch.equal(out, ref)
