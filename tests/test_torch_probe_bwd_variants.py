"""The probes' attention backward's A/B variants (neuspeech1_tpu_torch/perf/
probe_bwd_variants.py) still apply to the kernel's source: each
substitution matches it exactly once, so a card run times what the variant
says."""

import pytest

from neuspeech1_tpu_torch.perf import probe_bwd_variants


@pytest.mark.parametrize("name", list(probe_bwd_variants.VARIANTS))
def test_variant_applies_to_source(name):
    base = probe_bwd_variants.variant_source("base")
    src = probe_bwd_variants.variant_source(name)
    assert (src == base) == (name == "base")
    # the shared header is written in, so the variant builds on its own
    assert '#include "flash_sm90.cuh"' not in src and "wgmma_rs" in src


def test_variant_rejects_a_stale_substitution(monkeypatch):
    monkeypatch.setitem(probe_bwd_variants.VARIANTS, "stale",
                        (("no such statement", ""),))
    with pytest.raises(ValueError, match="matches 0 times"):
        probe_bwd_variants.variant_source("stale")
