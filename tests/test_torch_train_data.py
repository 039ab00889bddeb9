"""The fine-tune path's memory plan, device caches, bf16 collation and HF
export in the port (neuspeech1_tpu_torch) against the JAX package's, on the
CPU: `train/memory.py`'s plan and remat decision equal for the same memory
figure; `DeviceCache` epochs are permutations whose batches are the
collated rows of their indices, bit for bit; `RotatingDeviceCache` takes
the JAX package's shard and batch order with the same bytes; bf16 features
carry `ml_dtypes.bfloat16`'s bits; `params_to_hf_state_dict` equals the JAX
function's and inverts `params_from_hf_state_dict` exactly."""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from neuspeech1_tpu import config as jc
from neuspeech1_tpu.data import collate as jcol
from neuspeech1_tpu.data import dataset as jds
from neuspeech1_tpu.data.rotating_cache import RotatingDeviceCache as JRot
from neuspeech1_tpu.models import convert as jconv
from neuspeech1_tpu.models.init import init_params
from neuspeech1_tpu.train import memory as jmem
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jtok
from neuspeech1_tpu_torch import config as tc
from neuspeech1_tpu_torch.data import collate as tcol
from neuspeech1_tpu_torch.data import dataset as tds
from neuspeech1_tpu_torch.data import synthetic as tsyn
from neuspeech1_tpu_torch.data.device_cache import DeviceCache
from neuspeech1_tpu_torch.data.rotating_cache import RotatingDeviceCache
from neuspeech1_tpu_torch.models import convert as tconv
from neuspeech1_tpu_torch.train import memory as tmem
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer as ttok

torch.set_num_threads(1)

HBM16, HBM80 = 16 * 1024**3, 80 * 1024**3


# ---------------------------------------------------------------- memory
# tests/test_memory.py's cases, and the card's memory beside a TPU's
MEMORY_CASES = {
    "base_lora32": ("base", 64, False, 32, False, 0, HBM16, 64),
    "small_ft_full": ("small", 64, True, None, False, 0, HBM16, 64),
    "base_big_corpus": ("base", 64, False, 32, False, 4 * 1024**3, HBM16, 64),
    "base_adalora_h100": ("base", 64, False, 12, True, 400 * 2**20, HBM80,
                          128),
    "small_adalora_h100": ("small", 64, False, None, True, 0, HBM80, 128),
    "medium_ft_full_h100": ("medium", 32, True, None, False, 0, HBM80, 128),
    "large_lora_h100": ("large", 64, False, 32, False, 2**30, HBM80, 64),
}


@pytest.mark.parametrize("case", list(MEMORY_CASES))
def test_memory_plan_and_remat_match_jax(case):
    size, bs, ft_full, rank, ada, corpus, hbm, label_len = MEMORY_CASES[case]
    plans, decisions = [], []
    for cfgmod, stemcls, mem in ((jc, jc.StemConfig, jmem),
                                 (tc, tc.StemConfig, tmem)):
        cfg = cfgmod.preset_config(size)
        stem = stemcls("base", in_channels=208)
        count = mem.trainable_count_estimate(cfg, stem, ft_full=ft_full,
                                             lora_rank=rank, adalora=ada)
        plans.append(mem.train_memory_plan(
            cfg, stem, bs, trainable_count=count, corpus_bytes=corpus,
            hbm_bytes=hbm, label_len=label_len))
        decisions.append([mem.resolve_remat(
            spec, cfg, stem, bs, trainable_count=count, corpus_bytes=corpus,
            hbm_bytes=hbm, label_len=label_len)
            for spec in ("auto", "false", "True", False)])
    assert plans[0] == plans[1]
    assert decisions[0] == decisions[1]


def test_memory_defaults_on_the_cpu():
    assert tmem.device_hbm_bytes("cpu") == jmem.DEFAULT_HBM_BYTES
    cfg, stem = tc.WhisperConfig(), tc.StemConfig("base", in_channels=208)
    assert tmem.param_count(cfg, stem) == jmem.param_count(
        jc.WhisperConfig(), jc.StemConfig("base", in_channels=208))
    assert tmem.train_memory_plan(cfg, stem, 64)["hbm_bytes"] == HBM16


# ---------------------------------------------------------------- data
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    tsyn.make_synthetic_corpus(root, n_clips=24, n_channels=4, seed=2,
                               min_dur=0.5, max_dur=1.2)
    return root


def _datasets(corpus):
    jconfig = jc.tiny_config()
    tconfig = tc.tiny_config()
    t = tds.EEGDataset(f"{corpus}/train.jsonl", ttok("byte", tconfig),
                       modal_ch=4, min_duration=0.5, max_duration=1.28)
    j = jds.EEGDataset(f"{corpus}/train.jsonl", jtok("byte", jconfig),
                       modal_ch=4, min_duration=0.5, max_duration=1.28)
    assert len(t) == len(j) >= 16
    return t, j, tconfig


def _collators(tconfig, dtype="bfloat16"):
    kw = dict(pad_id=tconfig.eot_id, decoder_start_id=tconfig.sot_id,
              max_label_len=64, feature_dtype=dtype, eot_id=tconfig.eot_id)
    return tcol.Collator(**kw), jcol.Collator(**kw)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_bf16_collate_has_ml_dtypes_bits(corpus):
    t_ds, j_ds, tconfig = _datasets(corpus)
    tcoll, jcoll = _collators(tconfig)
    samples = [t_ds[i] for i in range(8)]
    got, ref = tcoll(samples), jcoll(samples)
    assert got["input_features"].dtype == torch.bfloat16
    assert ref["input_features"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bits(got["input_features"]),
                                  _bits(ref["input_features"]))
    for k in ("labels", "decoder_input_ids"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_device_cache_epochs_are_permutations(corpus):
    t_ds, _, tconfig = _datasets(corpus)
    coll, _ = _collators(tconfig)
    whole = coll([t_ds[i] for i in range(len(t_ds))])
    cache = DeviceCache.build(t_ds, coll, device="cpu")
    assert cache.nbytes() == (whole["input_features"].numel() * 2
                              + 2 * whole["labels"].size * 8)
    loader = cache.loader(batch_size=4, seed=7)
    epochs = []
    for _ in range(2):
        seen = []
        for batch in loader:
            idx = batch["_indices"].numpy()
            seen.extend(idx.tolist())
            np.testing.assert_array_equal(_bits(batch["input_features"]),
                                          _bits(whole["input_features"][idx]))
            for k in ("labels", "decoder_input_ids"):
                np.testing.assert_array_equal(batch[k].numpy(), whole[k][idx])
        assert len(seen) == len(loader) * 4
        assert len(set(seen)) == len(seen)  # a permutation's prefix
        epochs.append(seen)
    assert epochs[0] != epochs[1]  # seeded seed + epoch
    again = [b["_indices"].tolist() for b in cache.loader(4, seed=7)]
    assert sum(again, []) == epochs[0]


@pytest.mark.parametrize("shard_clips,repeats", [(8, 1), (7, 2), (24, 1)])
def test_rotating_cache_matches_jax(corpus, shard_clips, repeats):
    t_ds, j_ds, tconfig = _datasets(corpus)
    tcoll, jcoll = _collators(tconfig)
    kw = dict(shard_clips=shard_clips, batch_size=4, seed=3,
              shard_repeats=repeats)
    port = RotatingDeviceCache(t_ds, tcoll, device="cpu", **kw)
    ref = JRot(j_ds, jcoll, **kw)
    assert len(port) == len(ref)
    for _ in range(2):  # two epochs
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["_indices"], w["_indices"])
            np.testing.assert_array_equal(_bits(g["input_features"]),
                                          _bits(w["input_features"]))
            for k in ("labels", "decoder_input_ids"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    n_shards = -(-len(t_ds) // shard_clips)
    assert port.shards_staged == 2 * n_shards
    assert RotatingDeviceCache.shards_for_budget(10_000, 300) == \
        JRot.shards_for_budget(10_000, 300) == 16


# ---------------------------------------------------------------- export
@pytest.mark.parametrize("kind", ["base", "replace", "premel", "speech"])
def test_params_to_hf_state_dict_matches_jax(kind):
    config = jc.tiny_config(d_model=32, encoder_layers=2, decoder_layers=1,
                            encoder_heads=2, decoder_heads=2, encoder_ffn=64,
                            decoder_ffn=64)
    stem = jc.StemConfig(kind, in_channels=4)
    params = jax.device_get(init_params(jax.random.key(0), config, stem))
    ref = jconv.params_to_hf_state_dict(params, config, stem)
    tstem = tc.StemConfig(**dataclasses.asdict(stem))
    got = tconv.params_to_hf_state_dict(params, tstem)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    tconfig = tc.WhisperConfig(**dataclasses.asdict(config))
    back = tconv.params_from_hf_state_dict(got, tconfig, tstem)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (p, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
