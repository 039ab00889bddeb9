"""FSDP and tensor parallelism beside GPipe in the port (the split linears
of parallel/sharding.py inside pipeline stages: FSDP's gathers and
reduce-scatters and tensor parallelism's sums in every tick) against the
JAX package's GSPMD placement beside its ``pipeline_scan``, jitted under
``set_mesh`` on its virtual 8-device mesh, in f32 on the CPU, the port's
ranks as LocalRing threads of the same grid: the teacher-forcing forward's
loss within rtol 1e-5 and every leaf's gradient (the split ones gathered
whole) within rtol / atol 2e-4, the same bits on every rank. Beside
sequence parallelism: tests/test_torch_composed_fsdp_seq.py (FSDP) and
tests/test_torch_composed_sp_pp.py (tensor, with GPipe). Helpers and
geometry: tests/test_torch_composed_sp_pp.py."""

import pytest

from tests.test_torch_composed_sp_pp import (check_grads, config, inputs,
                                             jax_gold, port_grads)

MESHES = [{"tensor": 2, "pipe": 2}, {"fsdp": 2, "tensor": 2, "pipe": 2}]


@pytest.fixture(scope="module")
def setup():
    cfg = config()
    return (cfg, *inputs(cfg))


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "_".join(a))
def test_forward_and_gradients_match_the_jax_composition(setup, axes):
    cfg, params, feats, dec_in = setup
    ref_loss, ref_grads = jax_gold(cfg, params, feats, dec_in, axes)
    check_grads(port_grads(cfg, params, feats, dec_in, axes), ref_loss,
                ref_grads)
