"""FSDP, alone and beside tensor parallelism, beside sequence parallelism
in the port (the split linears of parallel/sharding.py inside the ring's
layers, the rows split over fsdp, each shard's tokens over seq) against
the JAX package's GSPMD placement beside its ring under ``set_mesh`` on
its virtual 8-device mesh, in f32 on the CPU, the port's ranks as
LocalRing threads of the same grid: the teacher-forcing forward's loss
within rtol 1e-5 and every leaf's gradient (the split ones gathered whole)
within rtol / atol 2e-4, the same bits on every rank. The JAX composition
runs eagerly here: jitted, it departs from its own forward
(tests/test_torch_composed_sp_pp.py::jit_composes). Helpers and geometry:
tests/test_torch_composed_sp_pp.py."""

import pytest

from tests.test_torch_composed_sp_pp import (check_grads, config, inputs,
                                             jax_gold, jit_composes,
                                             port_grads)

MESHES = [{"fsdp": 2, "seq": 2}, {"fsdp": 2, "tensor": 2, "seq": 2}]


@pytest.fixture(scope="module")
def setup():
    cfg = config()
    return (cfg, *inputs(cfg))


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "_".join(a))
def test_forward_and_gradients_match_the_jax_composition(setup, axes):
    assert not jit_composes(axes)
    cfg, params, feats, dec_in = setup
    ref_loss, ref_grads = jax_gold(cfg, params, feats, dec_in, axes)
    check_grads(port_grads(cfg, params, feats, dec_in, axes), ref_loss,
                ref_grads)
