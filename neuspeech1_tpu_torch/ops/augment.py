"""EEG/MEG augmentation of the PyTorch port: the port of
``neuspeech1_tpu/ops/augment.py``.

Two tiers:
  * numpy per-item ops, copied as they are in the JAX package (parity with
    reference `utils/augment_eeg.py` and the dispatch in
    `utils/reader.py:552-594`): the same ``np.random.Generator`` gives the
    same arrays. The data pipeline runs them on the host.
  * batched ops on a whole [B, ch, T] batch on its device (the JAX
    package's jitted ``augment_batch_jnp`` and ``spec_augment``), each split
    into its draws, taken from an explicit ``torch.Generator`` on the
    batch's device (`draw_augment`, `draw_spec_augment`), and a
    deterministic apply that reads them (`apply_augment`,
    `apply_spec_augment`). ``torch``'s generators cannot reproduce
    ``jax.random``'s draws; the split lets an apply take another package's
    draws, and the draws are held by their distributions.

The batched tier keeps the JAX package's dtypes: the noise power is the
mean of ``batch**2`` in the batch's dtype and the noise an f32 normal
draw, so a bf16 batch comes out of the noise in f32 (and stays f32
through mask and taylor); the mask grid takes the batch's dtype.

Augment config schema (reference `configs/augmentation1.json`):
    {"noise": {"prob": p, "min_snr_dB": a, "max_snr_dB": b},
     "mask":  {"prob": p, "kwargs": {"unit": [cu, tu], "mask_prob": q,
                                      "random_type": 1|2|3}},
     "shift": {"prob": p},
     "taylor": {"prob": p},
     "spec_augment": {apply_spec_augment's keyword arguments}}
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from neuspeech1_tpu_torch.ops.signal import add_gaussian_noise


# --------------------------------------------------------------------------
# numpy tier
# --------------------------------------------------------------------------

def block_mask(
    shape: Tuple[int, int],
    unit: Tuple[int, int] = (1, 40),
    keep_prob_threshold: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random block mask on a (ch_unit, time_unit) grid.

    Parity with `random_discrete_only_mask` (`utils/augment_eeg.py:15-26`):
    a uniform sample per grid cell; cells with value >= threshold are kept
    (1), the rest zeroed, then the grid is nearest-neighbor upsampled to
    ``shape``.
    """
    rng = rng or np.random.default_rng()
    ch, t = shape
    grid_t = math.ceil(t / unit[1])
    grid_c = math.ceil(ch / unit[0])
    pre = (rng.random((grid_c, grid_t)) >= keep_prob_threshold).astype(np.float32)
    pre = np.repeat(pre, math.ceil(ch / grid_c), axis=0)
    pre = np.repeat(pre, math.ceil(t / grid_t), axis=1)
    return pre[:ch, :t]


def channel_mask(
    shape: Tuple[int, int],
    low: int = 1,
    high: int = 32,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Zero a random subset of channels (`utils/augment_eeg.py:29-39`)."""
    rng = rng or np.random.default_rng()
    n = int(rng.integers(low, high + 1))
    chans = rng.permutation(shape[0])[:n]
    mask = np.ones(shape, dtype=np.float32)
    mask[chans, :] = 0.0
    return mask


def length_mask(
    shape: Tuple[int, int],
    unit_length: int = 40,
    prob_range: Tuple[float, float] = (0.2, 0.8),
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Zero random time blocks across all channels
    (`utils/augment_eeg.py:42-51`)."""
    rng = rng or np.random.default_rng()
    prob = rng.uniform(*prob_range)
    grid_t = math.ceil(shape[1] / unit_length)
    pre = (rng.random((1, grid_t)) >= prob).astype(np.float32)
    pre = np.repeat(pre, shape[0], axis=0)
    pre = np.repeat(pre, unit_length, axis=1)
    return pre[:, : shape[1]]


class RandomShapeMasker:
    """Parity with reference `utils/augment_eeg.py:81-98`.

    random_type: 1 = block mask, 2 = time mask (unit spans all channels),
    3 = channel mask (unit spans full time).
    """

    def __init__(self, unit=(1, 40), mask_prob: float = 0.25, random_type: int = 1):
        self.unit = list(unit)
        self.mask_prob = mask_prob
        self.random_type = random_type

    def __call__(self, shape, rng: Optional[np.random.Generator] = None):
        unit = list(self.unit)
        if self.random_type == 2:
            unit[0] = shape[0]
        elif self.random_type == 3:
            unit[1] = shape[1]
        elif self.random_type != 1:
            raise NotImplementedError(self.random_type)
        return block_mask(shape, unit=tuple(unit), keep_prob_threshold=self.mask_prob, rng=rng)


def shift_data(eeg: np.ndarray, shift: int) -> np.ndarray:
    """Left zero-pad (delays the signal); `utils/augment_eeg.py:54-56`."""
    return np.pad(eeg, [[0, 0], [shift, 0]])


def taylor_trim(
    sample: np.ndarray, max_points: int = 10, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Zero 1..max_points-1 samples at each end (reference 'taylor' aug,
    `utils/reader.py:581-591`)."""
    rng = rng or np.random.default_rng()
    out = sample.copy()
    n0 = int(rng.integers(1, max_points))
    n1 = int(rng.integers(1, max_points))
    out[:, :n0] = 0
    out[:, -n1:] = 0
    return out


def augment_sample(
    sample: np.ndarray,
    config: Optional[dict],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-item dispatch, parity with `utils/reader.py:552-594` (eeg modal)."""
    if not config:
        return sample
    rng = rng or np.random.default_rng()
    if "noise" in config and rng.random() < config["noise"]["prob"]:
        sample = add_gaussian_noise(
            sample,
            (config["noise"]["min_snr_dB"], config["noise"]["max_snr_dB"]),
            rng=rng,
        )
    if "mask" in config and rng.random() < config["mask"]["prob"]:
        masker = RandomShapeMasker(**config["mask"].get("kwargs", {}))
        sample = sample * masker(sample.shape, rng=rng)
    if "taylor" in config and rng.random() < config["taylor"]["prob"]:
        sample = taylor_trim(sample, rng=rng)
    return sample


# --------------------------------------------------------------------------
# batched tier: draws on the batch's device, then a deterministic apply
# --------------------------------------------------------------------------

def _mask_geometry(config: dict, ch: int, t: int):
    """(mask_prob, grid_c, grid_t, repeat_c, repeat_t) of the 'mask'
    section for [.., ch, t] signals."""
    kwargs = config["mask"].get("kwargs", {})
    unit = list(kwargs.get("unit", (1, 40)))
    rtype = kwargs.get("random_type", 1)
    if rtype == 2:
        unit[0] = ch
    elif rtype == 3:
        unit[1] = t
    grid_c = -(-ch // unit[0])
    grid_t = -(-t // unit[1])
    return (kwargs.get("mask_prob", 0.25), grid_c, grid_t,
            -(-ch // grid_c), -(-t // grid_t))


def _active(config: dict, name: str) -> bool:
    return name in config and config[name]["prob"] > 0


def draw_augment(gen: torch.Generator, shape, config: Optional[dict]
                 ) -> dict:
    """Every draw `apply_augment` reads for a [B, ch, T] batch, from
    ``gen`` on its device, section by section in the JAX package's order
    (noise, mask, taylor, spec_augment); a section that is off draws
    nothing. Per section:
      noise:  ``apply`` bool [B,1,1] (uniform < prob), ``snr`` f32 [B,ch,1]
              (uniform in [min_snr_dB, max_snr_dB)), ``normal`` f32 [B,ch,T];
      mask:   ``apply`` bool [B,1,1], ``keep`` bool [B,grid_c,grid_t]
              (uniform >= mask_prob);
      taylor: ``apply`` bool [B,1,1], ``n0``/``n1`` int64 [B,1,1] in 1..9;
      spec_augment: `draw_spec_augment`'s."""
    if not config:
        return {}
    b, ch, t = shape
    dev = gen.device

    def uniform(*size):
        return torch.rand(size, generator=gen, device=dev)

    draws = {}
    if _active(config, "noise"):
        c = config["noise"]
        draws["noise"] = {
            "apply": uniform(b, 1, 1) < c["prob"],
            "snr": uniform(b, ch, 1) * (c["max_snr_dB"] - c["min_snr_dB"])
            + c["min_snr_dB"],
            "normal": torch.randn((b, ch, t), generator=gen, device=dev)}
    if _active(config, "mask"):
        mask_prob, grid_c, grid_t, _, _ = _mask_geometry(config, ch, t)
        draws["mask"] = {"apply": uniform(b, 1, 1) < config["mask"]["prob"],
                         "keep": uniform(b, grid_c, grid_t) >= mask_prob}
    if _active(config, "taylor"):
        draws["taylor"] = {
            "apply": uniform(b, 1, 1) < config["taylor"]["prob"],
            "n0": torch.randint(1, 10, (b, 1, 1), generator=gen, device=dev),
            "n1": torch.randint(1, 10, (b, 1, 1), generator=gen, device=dev)}
    if "spec_augment" in config:
        draws["spec_augment"] = draw_spec_augment(
            gen, shape, **config["spec_augment"])
    return draws


def apply_augment(batch: torch.Tensor, draws: dict, config: Optional[dict]
                  ) -> torch.Tensor:
    """``augment_batch_jnp`` on a [B, ch, T] batch with `draw_augment`'s
    draws: noise at a per-(row, channel) SNR where a row's noise applies,
    the block mask where its mask applies, taylor's trim of n0 leading and
    n1 trailing samples where it applies, then SpecAugment's spans."""
    if not config:
        return batch
    b, ch, t = batch.shape
    if _active(config, "noise"):
        d = draws["noise"]
        power = (batch ** 2).mean(-1, keepdim=True)
        noise_std = torch.sqrt(power / (10.0 ** (d["snr"] / 10.0)))
        batch = torch.where(d["apply"], batch + d["normal"] * noise_std, batch)
    if _active(config, "mask"):
        d = draws["mask"]
        _, _, _, rep_c, rep_t = _mask_geometry(config, ch, t)
        mask = d["keep"].to(batch.dtype).repeat_interleave(rep_c, 1) \
            .repeat_interleave(rep_t, 2)[:, :ch, :t]
        batch = torch.where(d["apply"], batch * mask, batch)
    if _active(config, "taylor"):
        d = draws["taylor"]
        idx = torch.arange(t, device=batch.device)[None, None, :]
        keep = (idx >= d["n0"]) & (idx < t - d["n1"])
        batch = batch.masked_fill(d["apply"] & ~keep, 0.0)
    if "spec_augment" in config:
        batch = apply_spec_augment(batch, draws["spec_augment"],
                                   **config["spec_augment"])
    return batch


def augment_batch(gen: torch.Generator, batch: torch.Tensor,
                  config: Optional[dict]) -> torch.Tensor:
    """Noise, mask, taylor and SpecAugment on a [B, ch, T] batch, drawn from
    ``gen`` (on the batch's device): `apply_augment` of `draw_augment`."""
    return apply_augment(batch, draw_augment(gen, batch.shape, config),
                         config)


def _span_plan(length: int, mask_prob: float, mask_length: int,
               min_masks: int):
    """(n_full, frac, n_max) of `_span_mask`, or None where it masks
    nothing."""
    if mask_length < 1 or length < mask_length:
        return None
    raw = mask_prob * length / mask_length
    n_full = int(raw)
    # cap like HF: num_spans * mask_length <= length
    n_max = min(max(n_full + 1, min_masks), length // mask_length)
    if n_max == 0:
        return None
    return n_full, raw - n_full, n_max


def _draw_spans(gen, b: int, length: int, mask_prob: float,
                mask_length: int, min_masks: int):
    plan = _span_plan(length, mask_prob, mask_length, min_masks)
    if plan is None:
        return None
    starts = torch.randint(0, length - mask_length + 1, (b, plan[2]),
                           generator=gen, device=gen.device)
    return {"starts": starts,
            "eps": torch.rand((), generator=gen, device=gen.device)}


def _span_mask(draw, b: int, length: int, mask_prob: float,
               mask_length: int, min_masks: int, device) -> torch.Tensor:
    """[b, length] bool span mask, SpecAugment-style (HF wav2vec2
    `_compute_mask_indices` semantics: expected span count
    mask_prob·L/len with probabilistic rounding, ≥ min_masks, spans of
    exactly mask_length, clipped to the sequence), from `_draw_spans`'s
    ``starts`` [b, n_max] and ``eps`` (one uniform per call).

    The JAX package's divergence from HF (PARITY.md), kept: span starts
    are drawn WITH replacement (HF draws without), so spans may overlap
    slightly more often; the expected masked fraction is unchanged."""
    plan = _span_plan(length, mask_prob, mask_length, min_masks)
    if plan is None:
        return torch.zeros((b, length), dtype=torch.bool, device=device)
    n_full, frac, n_max = plan
    # span i is active if i < num_spans = n_full + (eps < frac), floored at
    # min_masks (HF: int(prob·L/len + eps) with one eps per call)
    num = torch.clamp(n_full + (draw["eps"] < frac).to(torch.int64),
                      min=min_masks, max=n_max)
    active = torch.arange(n_max, device=device)[None, :] < num  # [1, n_max]
    idx = torch.arange(length, device=device)[None, None, :]
    starts = draw["starts"][..., None]
    spans = (idx >= starts) & (idx < starts + mask_length)
    return (spans & active[..., None]).any(1)


def draw_spec_augment(
    gen: torch.Generator,
    shape,
    mask_time_prob: float = 0.05,
    mask_time_length: int = 10,
    mask_time_min_masks: int = 2,
    mask_feature_prob: float = 0.0,
    mask_feature_length: int = 10,
    mask_feature_min_masks: int = 0,
) -> dict:
    """`apply_spec_augment`'s draws for a [B, ch, T] batch: per active
    axis ("time" over T, "feature" over ch) the spans' ``starts`` and one
    ``eps``, time first."""
    b, ch, t = shape
    draws = {}
    if mask_time_prob > 0:
        draws["time"] = _draw_spans(gen, b, t, mask_time_prob,
                                    mask_time_length, mask_time_min_masks)
    if mask_feature_prob > 0:
        draws["feature"] = _draw_spans(gen, b, ch, mask_feature_prob,
                                       mask_feature_length,
                                       mask_feature_min_masks)
    return draws


def apply_spec_augment(
    batch: torch.Tensor,
    draws: dict,
    mask_time_prob: float = 0.05,
    mask_time_length: int = 10,
    mask_time_min_masks: int = 2,
    mask_feature_prob: float = 0.0,
    mask_feature_length: int = 10,
    mask_feature_min_masks: int = 0,
) -> torch.Tensor:
    """Feature-level SpecAugment on the [B, ch, T] input tensor — the
    operator the reference applies in `WhisperModel.forward`
    (`utils/load_model.py:801-842` → HF `_compute_mask_indices`): zero
    random time spans and/or feature (channel) spans, from
    `draw_spec_augment`'s draws. Defaults mirror HF whisper's config
    defaults; the reference ships it disabled (apply_spec_augment=False),
    so it is opt-in through the augment config's "spec_augment" section."""
    b, ch, t = batch.shape
    if mask_time_prob > 0:
        tm = _span_mask(draws["time"], b, t, mask_time_prob,
                        mask_time_length, mask_time_min_masks, batch.device)
        batch = batch.masked_fill(tm[:, None, :], 0.0)
    if mask_feature_prob > 0:
        fm = _span_mask(draws["feature"], b, ch, mask_feature_prob,
                        mask_feature_length, mask_feature_min_masks,
                        batch.device)
        batch = batch.masked_fill(fm[:, :, None], 0.0)
    return batch
