"""The port's per-process batch sharding of the DataLoader (neuspeech1_tpu_
torch/data/loader.py; the port of tests/test_multihost_loader.py:36-143):
each process sees the [process_index::process_count] slice of every global
batch, in the same batch order as the JAX package's loader; the union
reconstructs each global batch exactly once; an uneven split raises; and
a two-process data-parallel step over gloo (tests/torch_spawn.py) on the
two shards reproduces the one-process step on the same global rows, as
JAX's 2-device step does."""

import numpy as np
import pytest
import torch

from neuspeech1_tpu.config import tiny_config as jax_tiny_config
from neuspeech1_tpu.data.collate import Collator as JaxCollator
from neuspeech1_tpu.data.dataset import EEGDataset as JaxEEGDataset
from neuspeech1_tpu.data.loader import DataLoader as JaxDataLoader
from neuspeech1_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from neuspeech1_tpu_torch.config import StemConfig, tiny_config
from neuspeech1_tpu_torch.data.collate import Collator
from neuspeech1_tpu_torch.data.dataset import EEGDataset
from neuspeech1_tpu_torch.data.loader import DataLoader
from neuspeech1_tpu_torch.data.synthetic import make_synthetic_corpus
from neuspeech1_tpu_torch.models.convert import module_from_params
from neuspeech1_tpu_torch.models.init import init_params
from neuspeech1_tpu_torch.train import optimizer as topt
from neuspeech1_tpu_torch.train import trainstep as tts
from neuspeech1_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.torch_spawn import dp_step_rank

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus_ds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh") / "corpus")
    make_synthetic_corpus(root, n_clips=16, n_channels=4, seed=2,
                          min_dur=0.5, max_dur=0.6)
    tok = ByteTokenizer(tiny_config())
    ds = EEGDataset(f"{root}/train.jsonl", tok, mode="eval", modal_ch=4,
                    max_duration=0.64)
    return ds, tok, root


def _loader(ds, tok, pi, pc, bs=8):
    col = Collator(pad_id=tok.pad_id, decoder_start_id=tok.config.sot_id,
                   max_label_len=32)
    return DataLoader(ds, col, batch_size=bs, shuffle=True, seed=7,
                      drop_last=True, process_index=pi, process_count=pc,
                      num_threads=1, prefetch=1)


def test_two_host_shards_partition_each_global_batch(corpus_ds):
    ds, tok, _ = corpus_ds
    global_batches = [b["_indices"] for b in _loader(ds, tok, 0, 1)]
    h0 = [b["_indices"] for b in _loader(ds, tok, 0, 2)]
    h1 = [b["_indices"] for b in _loader(ds, tok, 1, 2)]
    assert len(h0) == len(h1) == len(global_batches)
    for g, a, b in zip(global_batches, h0, h1):
        np.testing.assert_array_equal(a, g[0::2])
        np.testing.assert_array_equal(b, g[1::2])
        assert sorted(np.concatenate([a, b]).tolist()) == sorted(g.tolist())
        assert a.shape[0] == b.shape[0] == g.shape[0] // 2


@pytest.mark.parametrize("pi", [0, 1])
def test_shards_equal_the_jax_loaders(corpus_ds, pi):
    """The same per-process rows, batch for batch, and the same features
    and labels, as the JAX package's loader over its own dataset."""
    ds, tok, root = corpus_ds
    jtok = JaxByteTokenizer(jax_tiny_config())
    jds = JaxEEGDataset(f"{root}/train.jsonl", jtok, mode="eval",
                        modal_ch=4, max_duration=0.64)
    jcol = JaxCollator(pad_id=jtok.pad_id,
                       decoder_start_id=jtok.config.sot_id, max_label_len=32)
    jl = JaxDataLoader(jds, jcol, batch_size=8, shuffle=True, seed=7,
                       drop_last=True, process_index=pi, process_count=2,
                       num_threads=1, prefetch=1)
    got = list(_loader(ds, tok, pi, 2))
    ref = list(jl)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in ("_indices", "input_features", "labels"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_four_host_shapes_and_order_stability(corpus_ds):
    ds, tok, _ = corpus_ds
    shards = [[b["_indices"] for b in _loader(ds, tok, pi, 4)]
              for pi in range(4)]
    n_batches = len(shards[0])
    assert all(len(s) == n_batches for s in shards)
    for bi in range(n_batches):
        union = np.concatenate([shards[pi][bi] for pi in range(4)])
        assert len(set(union.tolist())) == len(union)
        assert all(shards[pi][bi].shape[0] == 2 for pi in range(4))


def test_uneven_batch_size_rejected(corpus_ds):
    ds, tok, _ = corpus_ds
    with pytest.raises(ValueError, match="divide evenly"):
        _loader(ds, tok, 0, 3, bs=8)


def test_short_last_batch_gives_every_process_a_batch(corpus_ds):
    """Without drop_last a last batch of fewer rows than processes leaves
    some with none: they get an empty ``_indices``, the same count of
    batches as the others."""
    ds, tok, _ = corpus_ds
    col = Collator(pad_id=tok.pad_id, decoder_start_id=tok.config.sot_id,
                   max_label_len=32)
    n = len(ds)
    shards = [list(DataLoader(ds, col, batch_size=n - 1, shuffle=False,
                              drop_last=False, process_index=pi,
                              process_count=n - 1, num_threads=1))
              for pi in (0, 1)]
    assert len(shards[0]) == len(shards[1]) == 2
    assert shards[0][1]["_indices"].tolist() == [n - 1]
    assert set(shards[1][1]) == {"_indices"}
    assert shards[1][1]["_indices"].shape == (0,)


def test_two_process_step_matches_single(corpus_ds, tmp_path):
    """Two process-sharded loaders' first batches, each in its own gloo
    process of a data-2 mesh, one full fine-tune step: the one-process
    step on the same global rows (the two shards concatenated, the order
    the mesh's data axis lays them out)."""
    ds, tok, _ = corpus_ds
    b0 = next(iter(_loader(ds, tok, 0, 2)))
    b1 = next(iter(_loader(ds, tok, 1, 2)))
    keys = ("input_features", "labels", "decoder_input_ids")
    shards = [{k: np.asarray(b[k]) for k in keys} for b in (b0, b1)]
    config = tiny_config(
        d_model=32, encoder_layers=2, decoder_layers=2, encoder_heads=2,
        decoder_heads=2, encoder_ffn=64, decoder_ffn=64,
        max_source_positions=32, max_target_positions=32, dtype="float32")
    stem = StemConfig("base", in_channels=4)
    params = {k: v for k, v in init_params(config, stem, seed=0).items()}
    torch.multiprocessing.spawn(
        dp_step_rank, args=(2, str(tmp_path / "store"), str(tmp_path),
                            params, shards, config, stem), nprocs=2)

    model = module_from_params(params, config, stem, device="cpu",
                               dtype=torch.float32)
    tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=4,
                             grad_clip=None)
    state, frozen = tts.init_train_state(
        model, None, tx, topt.default_trainable_pred(ft_full=True))
    batch = {k: torch.from_numpy(np.concatenate([s[k] for s in shards]))
             for k in keys}
    for k in ("labels", "decoder_input_ids"):
        batch[k] = batch[k].long()
    m = tts.make_train_step(config, stem, tx)(state, frozen, batch)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    assert float(got[0]["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    for k, t in state.trainable.items():
        name = k.replace("/", ".")
        np.testing.assert_array_equal(got[0][name], got[1][name], err_msg=k)
        np.testing.assert_allclose(got[0][name], t.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
