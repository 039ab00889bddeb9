"""The decode kernels' A/B variants (neuspeech1_tpu_torch/perf/
decode_variants.py) still apply to the kernels' sources: each substitution
matches its source exactly once, and each plan change names a constant of
the wrapper, so a card run times what the variant says."""

import pytest

from neuspeech1_tpu_torch.ops import decode_cross as dc
from neuspeech1_tpu_torch.ops import decode_step as ds
from neuspeech1_tpu_torch.perf import decode_variants


@pytest.mark.parametrize("name", list(decode_variants.VARIANTS))
def test_variant_applies_to_source(name):
    source, subs, plan = decode_variants.VARIANTS[name]
    base = decode_variants.common.variant_source(source, "base", ())
    src = decode_variants.variant_source(name)
    assert (src == base) == (not subs)
    # the shared header is written in, so the variant builds on its own
    assert '#include "decode_sm90.cuh"' not in src and "mma16816" in src
    mod = dc if source == "decode_cross" else ds
    assert all(hasattr(mod, key) for key in plan)


def test_variant_rejects_a_stale_substitution(monkeypatch):
    monkeypatch.setitem(decode_variants.VARIANTS, "stale",
                        ("decode_cross", (("no such statement", ""),), {}))
    with pytest.raises(ValueError, match="matches 0 times"):
        decode_variants.variant_source("stale")
