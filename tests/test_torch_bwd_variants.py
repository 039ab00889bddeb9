"""The flash backward's A/B variants (neuspeech1_tpu_torch/perf/
bwd_variants.py) still apply to the kernel's source: each substitution
matches it exactly once, so a card run times what the variant says."""

import pytest

from neuspeech1_tpu_torch.perf import bwd_variants


@pytest.mark.parametrize("name", list(bwd_variants.VARIANTS))
def test_variant_applies_to_source(name):
    base = bwd_variants.variant_source("base")
    src = bwd_variants.variant_source(name)
    assert (src == base) == (name == "base")


def test_variant_rejects_a_stale_substitution(monkeypatch):
    monkeypatch.setitem(bwd_variants.VARIANTS, "stale",
                        (("no such statement", ""),))
    with pytest.raises(ValueError, match="matches 0 times"):
        bwd_variants.variant_source("stale")
