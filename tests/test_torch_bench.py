"""The port's bench (neuspeech1_tpu_torch/bench.py) against the JAX
package's root bench.py: the same analytic FLOP count, and the whole body
run on the CPU at the tiny config (its times are CPU times, so ``mfu``,
the card's utilisation, stays None there)."""

import dataclasses
import importlib.util
import os

import pytest
import torch

from neuspeech1_tpu.config import WhisperConfig as JaxWhisperConfig
from neuspeech1_tpu.config import tiny_config as jax_tiny_config
from neuspeech1_tpu_torch import bench
from neuspeech1_tpu_torch import config as tc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_bench():
    """The root bench.py as a module (its top level imports only json and
    time; its JAX imports sit inside main)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", ["base", "tiny"])
@pytest.mark.parametrize("label_len,in_channels", [(64, 208), (16, 8)])
def test_fwd_flops_per_sample_equals_root_bench(size, label_len, in_channels):
    if size == "base":
        jcfg, tcfg = JaxWhisperConfig(), tc.preset_config("base")
    else:
        jcfg, tcfg = jax_tiny_config(), tc.tiny_config()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert bench.fwd_flops_per_sample(tcfg, label_len, in_channels) == \
        _root_bench().fwd_flops_per_sample(jcfg, label_len, in_channels)


def test_bench_runs_on_cpu_at_tiny_size():
    config = tc.tiny_config()
    out = bench.run(config, tc.StemConfig("base", in_channels=8),
                    batch_size=2, steps=2, device="cpu")
    keys = {"metric", "value", "train_step_ms", "mfu",
            "fwd_gflops_per_sample", "remat", "decode_tokens_per_sec",
            "decode_e2e_tokens_per_sec", "decode_fp_tokens_per_sec",
            "vs_baseline", "device"}
    assert keys <= set(out)
    assert out["metric"] == "train_samples_per_sec_per_chip"
    assert out["remat"] is False
    assert out["device"] == "cpu" and out["mfu"] is None
    assert out["value"] > 0 and out["train_step_ms"] > 0
    assert out["fwd_gflops_per_sample"] == pytest.approx(
        bench.fwd_flops_per_sample(config, bench.LABEL_LEN, 8) / 1e9)
