"""The port's augmentation (neuspeech1_tpu_torch/ops/augment.py,
ops/signal.py, and EEGDataset in train mode) against the JAX package's on
the CPU: the numpy tier and the dataset's items bit-equal for the same
seed; the batched tier's apply on JAX's own draws (``jax.random.split``
replayed as ``augment_batch_jnp`` splits) equal to ``augment_batch_jnp``
and ``spec_augment``; the port's draws held by their distributions; and
``preprocess_eeg`` against ``preprocess_eeg_jnp``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuspeech1_tpu.data import dataset as jds
from neuspeech1_tpu.ops import augment as ja
from neuspeech1_tpu.ops import signal as jsig
from neuspeech1_tpu_torch.data import dataset as tds
from neuspeech1_tpu_torch.ops import augment as ta
from neuspeech1_tpu_torch.ops import signal as tsig
from tests.test_torch_data import _tokenizers, corpus  # noqa: F401

torch.set_num_threads(1)

# noise: the power's mean and 10 ** (snr / 10) round differently in XLA and
# torch (one or two f32 ulps), so the noisy samples agree to this bound;
# every other transform selects or zeroes samples and agrees exactly
NOISE_RTOL, NOISE_ATOL = 1e-5, 1e-6

FULL = {"noise": {"prob": 0.5, "min_snr_dB": 5, "max_snr_dB": 20},
        "mask": {"prob": 0.5, "kwargs": {"unit": [2, 40], "mask_prob": 0.25,
                                         "random_type": 1}},
        "shift": {"prob": 0.5},
        "taylor": {"prob": 0.5}}


# --------------------------------------------------------------------------
# numpy tier
# --------------------------------------------------------------------------

NUMPY_CASES = {
    "block_mask": lambda m, rng: m.block_mask((7, 130), (2, 40), 0.3, rng),
    "channel_mask": lambda m, rng: m.channel_mask((40, 30), 2, 9, rng),
    "length_mask": lambda m, rng: m.length_mask((5, 170), 40, (0.2, 0.8),
                                                rng),
    "masker_block": lambda m, rng: m.RandomShapeMasker((2, 40), 0.25, 1)(
        (7, 130), rng),
    "masker_time": lambda m, rng: m.RandomShapeMasker((1, 30), 0.5, 2)(
        (7, 130), rng),
    "masker_channel": lambda m, rng: m.RandomShapeMasker((3, 40), 0.5, 3)(
        (7, 130), rng),
    "shift_data": lambda m, rng: m.shift_data(
        rng.standard_normal((3, 20)).astype(np.float32), 7),
    "taylor_trim": lambda m, rng: m.taylor_trim(
        rng.standard_normal((3, 40)).astype(np.float32), 10, rng),
    "augment_sample": lambda m, rng: m.augment_sample(
        rng.standard_normal((6, 300)).astype(np.float32), FULL, rng),
    "augment_sample_time_mask": lambda m, rng: m.augment_sample(
        rng.standard_normal((6, 300)).astype(np.float32),
        {"mask": {"prob": 1.0, "kwargs": {"random_type": 2}},
         "noise": {"prob": 1.0, "min_snr_dB": 0, "max_snr_dB": 3}}, rng),
}


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_tier_bit_equal(case):
    for seed in range(4):
        a = NUMPY_CASES[case](ja, np.random.default_rng(seed))
        b = NUMPY_CASES[case](ta, np.random.default_rng(seed))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_add_gaussian_noise_bit_equal():
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    a = jsig.add_gaussian_noise(x, (3.0, 9.0), np.random.default_rng(1))
    b = tsig.add_gaussian_noise(x, (3.0, 9.0), np.random.default_rng(1))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


AUG_DATASET_CASES = {
    "full": FULL,
    "shift_only": {"shift": {"prob": 1.0}},
    "all_zero": {k: {**v, "prob": 0.0} for k, v in FULL.items()},
}


@pytest.mark.parametrize("case", sorted(AUG_DATASET_CASES))
def test_train_dataset_items_equal(corpus, case):  # noqa: F811
    """Train mode with an augment config: shift with the transcript
    realigned, then noise, mask and taylor per item, from the dataset's
    seeded generator: arrays bit-equal and labels equal item by item, over
    two passes; the native loader is off with any config, as in JAX."""
    root, vocab = corpus
    path = os.path.join(root, "mixed.jsonl")
    for spec in ("byte", "word"):
        tj, tt = _tokenizers(vocab, spec)
        kw = dict(mode="train", modal_ch=6, seed=3, max_duration=4.0,
                  augment_config=AUG_DATASET_CASES[case])
        dj, dt = jds.EEGDataset(path, tj, **kw), tds.EEGDataset(path, tt, **kw)
        assert dj.supports_native_signals() is False
        assert dt.supports_native_signals() is False
        changed = 0
        for i in list(range(len(dj))) * 2:
            a, b = dj[i], dt[i]
            assert a["input_features"].dtype == b["input_features"].dtype
            np.testing.assert_array_equal(a["input_features"],
                                          b["input_features"])
            assert list(a["labels"]) == list(b["labels"])
            changed += not np.array_equal(
                b["input_features"][:, :10], np.load(
                    dt.rows[i]["eeg"]["path"])[:6, :10])
        assert (changed > 0) == (case != "all_zero")


def test_eval_mode_ignores_the_config(corpus):  # noqa: F811
    root, vocab = corpus
    path = os.path.join(root, "mixed.jsonl")
    tj, tt = _tokenizers(vocab, "byte")
    dj = jds.EEGDataset(path, tj, mode="test", modal_ch=6,
                        augment_config=FULL)
    dt = tds.EEGDataset(path, tt, mode="test", modal_ch=6,
                        augment_config=FULL)
    assert dj.supports_native_signals() == dt.supports_native_signals() \
        is True
    for i in range(len(dj)):
        np.testing.assert_array_equal(dj[i]["input_features"],
                                      dt[i]["input_features"])


# --------------------------------------------------------------------------
# batched tier: the port's apply on JAX's draws
# --------------------------------------------------------------------------

def _span_draws(key, b, length, mask_prob, mask_length, min_masks):
    """``_span_mask``'s draws for ``key``, as it splits it."""
    plan = ta._span_plan(length, mask_prob, mask_length, min_masks)
    if plan is None:
        return None
    k_start, k_eps = jax.random.split(key)
    starts = jax.random.randint(k_start, (b, plan[2]), 0,
                                length - mask_length + 1)
    return {"starts": torch.from_numpy(np.array(starts)).long(),
            "eps": torch.tensor(float(jax.random.uniform(k_eps, ())))}


def jax_spec_draws(key, shape, mask_time_prob=0.05, mask_time_length=10,
                   mask_time_min_masks=2, mask_feature_prob=0.0,
                   mask_feature_length=10, mask_feature_min_masks=0):
    """``spec_augment``'s draws for ``key``, replayed as it splits it, in
    the port's `draw_spec_augment` layout."""
    b, ch, t = shape
    k_time, k_feat = jax.random.split(key)
    out = {}
    if mask_time_prob > 0:
        out["time"] = _span_draws(k_time, b, t, mask_time_prob,
                                  mask_time_length, mask_time_min_masks)
    if mask_feature_prob > 0:
        out["feature"] = _span_draws(k_feat, b, ch, mask_feature_prob,
                                     mask_feature_length,
                                     mask_feature_min_masks)
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_augment_draws(key, shape, config):
    """``augment_batch_jnp``'s draws for ``key`` (its ``jax.random.split``
    sequence replayed), in the port's `draw_augment` layout."""
    b, ch, t = shape
    draws = {}
    if not config:
        return draws
    if "noise" in config and config["noise"]["prob"] > 0:
        c = config["noise"]
        key, k_apply, k_snr, k_noise = jax.random.split(key, 4)
        draws["noise"] = {
            "apply": _t(jax.random.uniform(k_apply, (b, 1, 1)) < c["prob"]),
            "snr": _t(jax.random.uniform(k_snr, (b, ch, 1),
                                         minval=c["min_snr_dB"],
                                         maxval=c["max_snr_dB"])),
            "normal": _t(jax.random.normal(k_noise, shape))}
    if "mask" in config and config["mask"]["prob"] > 0:
        mask_prob, gc, gt, _, _ = ta._mask_geometry(config, ch, t)
        key, k_apply, k_grid = jax.random.split(key, 3)
        draws["mask"] = {
            "apply": _t(jax.random.uniform(k_apply, (b, 1, 1))
                        < config["mask"]["prob"]),
            "keep": _t(jax.random.uniform(k_grid, (b, gc, gt)) >= mask_prob)}
    if "taylor" in config and config["taylor"]["prob"] > 0:
        key, k_apply, k_n0, k_n1 = jax.random.split(key, 4)
        draws["taylor"] = {
            "apply": _t(jax.random.uniform(k_apply, (b, 1, 1))
                        < config["taylor"]["prob"]),
            "n0": _t(jax.random.randint(k_n0, (b, 1, 1), 1, 10), torch.long),
            "n1": _t(jax.random.randint(k_n1, (b, 1, 1), 1, 10), torch.long)}
    if "spec_augment" in config:
        key, k_spec = jax.random.split(key)
        draws["spec_augment"] = jax_spec_draws(k_spec, shape,
                                               **config["spec_augment"])
    return draws


SPEC = {"mask_time_prob": 0.2, "mask_time_length": 7,
        "mask_time_min_masks": 2, "mask_feature_prob": 0.3,
        "mask_feature_length": 2, "mask_feature_min_masks": 1}
BATCH_CASES = {
    "noise": {"noise": FULL["noise"]},
    "mask_block": {"mask": FULL["mask"]},
    "mask_time": {"mask": {"prob": 0.7, "kwargs": {"unit": [1, 16],
                                                   "random_type": 2}}},
    "mask_channel": {"mask": {"prob": 0.7, "kwargs": {"unit": [3, 16],
                                                      "mask_prob": 0.5,
                                                      "random_type": 3}}},
    "taylor": {"taylor": {"prob": 0.6}},
    "spec_augment": {"spec_augment": SPEC},
    "spec_defaults": {"spec_augment": {}},
    "all": {**{k: v for k, v in FULL.items() if k != "shift"},
            "spec_augment": SPEC},
    "zero_probs": {k: {**v, "prob": 0.0} for k, v in FULL.items()},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_apply_on_jax_draws_equals_augment_batch_jnp(case, dtype):
    config = BATCH_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 10, 130)).astype(np.float32)
    x[2, 3] = 0.0  # a silent channel: power 0, noise std 0
    key = jax.random.key(4)
    ref = ja.augment_batch_jnp(key, jnp.asarray(x, dtype), config)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ta.apply_augment(xt, jax_augment_draws(key, x.shape, config),
                           config)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if "noise" in config and config["noise"]["prob"] > 0:
        np.testing.assert_allclose(got, ref, rtol=NOISE_RTOL,
                                   atol=NOISE_ATOL)
        np.testing.assert_array_equal(got == 0, ref == 0)
    else:
        np.testing.assert_array_equal(got, ref)
    if case == "zero_probs":
        np.testing.assert_array_equal(got, xt.float().numpy())


@pytest.mark.parametrize("seed", range(3))
def test_spec_augment_on_jax_draws(seed):
    x = np.random.default_rng(seed).standard_normal((5, 9, 120)) \
        .astype(np.float32)
    key = jax.random.key(seed)
    ref = np.asarray(ja.spec_augment(key, jnp.asarray(x), **SPEC))
    got = ta.apply_spec_augment(torch.from_numpy(x),
                                jax_spec_draws(key, x.shape, **SPEC), **SPEC)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any()


def test_span_mask_edges_mask_nothing():
    """A span longer than the sequence, or a cap of 0 spans, masks nothing
    and draws nothing, in both packages."""
    for args in ((5, 0.5, 6, 1), (5, 0.1, 0, 1)):
        assert ta._span_plan(*args) is None
        ref = ja._span_mask(jax.random.key(0), 3, *args)
        got = ta._span_mask(None, 3, *args, "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ta.draw_spec_augment(torch.Generator(), (2, 3, 5),
                                mask_time_length=6) == {"time": None}


# --------------------------------------------------------------------------
# the port's own draws, by their distributions
# --------------------------------------------------------------------------

def _binomial_ok(hits: int, n: int, p: float, z: float = 5.0) -> bool:
    return abs(hits - n * p) <= z * (n * p * (1 - p)) ** 0.5 + 1


def test_port_draws_follow_their_distributions():
    config = {**{k: v for k, v in FULL.items() if k != "shift"},
              "spec_augment": SPEC}
    shape = (4000, 8, 120)
    gen = torch.Generator().manual_seed(0)
    d = ta.draw_augment(gen, shape, config)
    b, ch, t = shape
    for name in ("noise", "mask", "taylor"):
        assert _binomial_ok(int(d[name]["apply"].sum()), b, 0.5), name
        assert d[name]["apply"].shape == (b, 1, 1)
    snr = d["noise"]["snr"]
    assert snr.shape == (b, ch, 1)
    assert 5 <= snr.min() and snr.max() < 20
    assert abs(snr.mean().item() - 12.5) < 0.05
    normal = d["noise"]["normal"]
    assert normal.dtype == torch.float32 and normal.shape == shape
    assert abs(normal.mean().item()) < 3e-3
    assert abs(normal.std().item() - 1) < 3e-3
    keep = d["mask"]["keep"]
    assert keep.shape == (b, 4, 3)  # unit (2, 40) over (8, 120)
    assert _binomial_ok(int(keep.sum()), keep.numel(), 0.75)
    for n in ("n0", "n1"):
        v = d["taylor"][n]
        assert v.min() == 1 and v.max() == 9
        counts = torch.bincount(v.flatten(), minlength=10)[1:]
        assert all(_binomial_ok(int(c), b, 1 / 9) for c in counts)
    spans = d["spec_augment"]
    starts = spans["time"]["starts"]
    assert starts.min() == 0 and starts.max() == t - 7
    assert spans["feature"]["starts"].max() == ch - 2
    assert 0 <= spans["time"]["eps"] < 1
    # the draws follow the config's sections only
    assert ta.draw_augment(gen, shape, {"taylor": {"prob": 0.0}}) == {}
    assert ta.draw_augment(gen, shape, None) == {}


def test_augment_batch_is_apply_of_draw():
    config = {k: v for k, v in FULL.items() if k != "shift"}
    x = torch.randn(5, 8, 120, generator=torch.Generator().manual_seed(1))
    a = ta.augment_batch(torch.Generator().manual_seed(2), x, config)
    d = ta.draw_augment(torch.Generator().manual_seed(2), x.shape, config)
    assert torch.equal(a, ta.apply_augment(x, d, config))


def test_masked_share_and_snr_of_the_applied_batch():
    """What the apply does with the port's draws: a masked row loses close
    to mask_prob of its samples; a noisy row's measured SNR lies in
    [min_snr_dB, max_snr_dB] up to the finite-sample spread."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(400, 8, 400, generator=gen)
    mask_cfg = {"mask": {"prob": 1.0, "kwargs": {"unit": [1, 40],
                                                 "mask_prob": 0.25}}}
    got = ta.augment_batch(gen, x, mask_cfg)
    share = (got == 0).float().mean().item()
    assert abs(share - 0.25) < 0.01
    noise_cfg = {"noise": {"prob": 1.0, "min_snr_dB": 10, "max_snr_dB": 30}}
    got = ta.augment_batch(gen, x, noise_cfg)
    snr = 10 * torch.log10(x.pow(2).mean(-1) / (got - x).pow(2).mean(-1))
    assert 10 - 0.7 < snr.min() and snr.max() < 30 + 0.7


# --------------------------------------------------------------------------
# preprocess_eeg
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,baseline", [((3, 5, 800), 500),
                                            ((4, 6, 31), 10),
                                            ((2, 7, 64), 500)])
def test_preprocess_eeg_matches_jnp(shape, baseline):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    x[0, 1] = 2.0  # a constant channel: IQR 0, scaled by 1
    x[1, 2, ::2] = 50.0  # outliers past the clip
    ref = np.asarray(jsig.preprocess_eeg_jnp(jnp.asarray(x),
                                             baseline_samples=baseline))
    got = tsig.preprocess_eeg(torch.from_numpy(x),
                              baseline_samples=baseline).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() <= 1.0
