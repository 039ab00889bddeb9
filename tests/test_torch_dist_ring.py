"""The port's DistRing (neuspeech1_tpu_torch/parallel/ring_attention.py) over
gloo, two processes on the CPU, against LocalRing(2) on the same inputs.

This file imports neither JAX nor the JAX package, so that the processes
``torch.multiprocessing.spawn`` starts, which import it to find their
function, stay quick; the ring's agreement with the JAX package is in
tests/test_torch_ring_attention.py."""

import os
import sys

import numpy as np
import pytest
import torch

from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.pipeline import pipeline
from neuspeech1_tpu_torch.parallel.ring_attention import (
    LocalRing, ring_flash_attention)

torch.set_num_threads(1)

N = 2
KV_VALID_LEN = 200


def _inputs(b=2, t=256, h=2, d=64, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _ring(ring, q, k, v, do):
    """ring_flash_attention forward and backward on one rank; the output,
    the grads of q, k, v, and an all_reduce_sum of rank + 1."""
    qq, kk, vv = (torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v))
    o = ring_flash_attention(qq, kk, vv, ring, KV_VALID_LEN)
    o.backward(torch.from_numpy(do))
    total = ring.all_reduce_sum(torch.full((3,), float(ring.rank + 1)))
    return {"o": o.detach().numpy(), "dq": qq.grad.numpy(),
            "dk": kk.grad.numpy(), "dv": vv.grad.numpy(),
            "total": total.numpy()}


def _gloo_rank(rank, n, store_path, out_dir, q, k, v, do):
    """One process of the gloo ring: initialize_distributed, a DeviceMesh
    with a 'seq' dim, the ring's forward and backward."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", store=dist.FileStore(store_path, n),
                                 rank=rank, world_size=n)
    try:
        mesh = pmesh.make_mesh("cpu", seq=n)
        info = pmesh.local_mesh_info(mesh)
        assert info["axes"] == {"seq": n} and info["process_index"] == rank
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **_ring(pmesh.axis_ring("seq", mesh), q, k, v, do))
    finally:
        dist.destroy_process_group()


def test_dist_ring_over_gloo_equals_local_ring(tmp_path):
    """DistRing over gloo in two processes (torch.multiprocessing.spawn, a
    FileStore): the same outputs, grads and sums as LocalRing(2), bit for
    bit, with the second rank's keys all past kv_valid_len."""
    q, k, v, do = _inputs()
    torch.multiprocessing.spawn(
        _gloo_rank, args=(N, str(tmp_path / "store"), str(tmp_path), q, k, v,
                          do), nprocs=N)
    local = LocalRing.run(lambda ring: _ring(ring, q, k, v, do), N)
    for rank, ref in enumerate(local):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name, x in ref.items():
            np.testing.assert_array_equal(got[name], x, err_msg=name)
    np.testing.assert_array_equal(local[0]["total"], np.full(3, 3.0))
    assert np.isfinite(local[0]["o"]).all()


def _toy_pipeline(ring, seed=3, n_layers=4, b=8, d=16):
    """The pipelined toy stack (tanh(h W + b)) on one rank: output, the
    input's gradient, this stage's weight gradients; and the ring's other
    exchanges: the reverse hop, a broadcast from the last rank, the
    gathered objects."""
    rng = np.random.default_rng(seed)
    ws = torch.from_numpy(rng.standard_normal((n_layers, d, d))
                          .astype(np.float32)) * 0.3
    x = torch.from_numpy(rng.standard_normal((b, 5, d)).astype(np.float32))
    w = ws.clone().requires_grad_()
    h = x.clone().requires_grad_()
    o = pipeline(lambda h, xs: torch.tanh(h @ xs["w"]),
                 [{"w": w[i]} for i in range(n_layers)], h, ring)
    (o ** 2).sum().backward()
    (back,) = ring.permute_back(torch.full((2,), float(ring.rank)))
    ring.barrier()
    return {"o": o.detach().numpy(), "dh": h.grad.numpy(),
            "dw": w.grad.numpy(), "back": back.numpy(),
            "bcast": ring.broadcast(torch.full((2,), float(ring.rank)),
                                    ring.size - 1).numpy(),
            "objects": np.asarray(ring.gather_objects(ring.rank * 10))}


def _gloo_pipe_rank(rank, n, store_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", store=dist.FileStore(store_path, n),
                                 rank=rank, world_size=n)
    try:
        ring = pmesh.axis_ring("pipe", pmesh.make_mesh("cpu", data=1,
                                                       pipe=-1))
        np.savez(os.path.join(out_dir, f"pipe{rank}.npz"),
                 **_toy_pipeline(ring))
    finally:
        dist.destroy_process_group()


def test_dist_pipeline_over_gloo_equals_local_ring(tmp_path):
    """GPipe's autograd wrapper over a DistRing (gloo, two processes; the
    mesh's pipe axis from -1) against LocalRing(2): output, input and
    stage gradients, the reverse hop, the broadcast and the gathered
    objects bit for bit."""
    torch.multiprocessing.spawn(
        _gloo_pipe_rank, args=(N, str(tmp_path / "store"), str(tmp_path)),
        nprocs=N)
    local = LocalRing.run(_toy_pipeline, N)
    for rank, ref in enumerate(local):
        got = np.load(tmp_path / f"pipe{rank}.npz")
        for name, x in ref.items():
            np.testing.assert_array_equal(got[name], x, err_msg=name)
    np.testing.assert_array_equal(local[0]["back"], [1.0, 1.0])
    np.testing.assert_array_equal(local[1]["bcast"], [1.0, 1.0])
    np.testing.assert_array_equal(local[0]["objects"], [0, 10])


def test_local_ring_exchanges_under_thread_switching():
    """16 ranks (more threads than cores) with a short switch interval, 50
    rounds of permute, all_gather and all_reduce_sum: every rank receives
    rank - 1's tensor of the same round, every gather is in rank order and
    every sum is the same, so no exchange reads a slot of another round."""
    n, rounds = 16, 50

    def rank(ring):
        for r in range(rounds):
            mine = torch.tensor([float(ring.rank), float(r)])
            (got,) = ring.permute(mine)
            assert got.tolist() == [float((ring.rank - 1) % n), float(r)]
            gathered = ring.all_gather(mine[None], 0)
            assert gathered[:, 0].tolist() == [float(i) for i in range(n)]
            assert ring.all_reduce_sum(mine).tolist() == [n * (n - 1) / 2,
                                                          float(n * r)]
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert LocalRing.run(rank, n) == [True] * n
    finally:
        sys.setswitchinterval(interval)


def test_local_ring_raises_a_ranks_error_without_hanging():
    """A rank that raises before an exchange breaks the barrier: the other
    ranks stop, and the first rank's error reaches the caller."""
    def rank(ring):
        if ring.rank == 2:
            raise ValueError("rank 2 failed")
        ring.all_reduce_sum(torch.ones(1))

    with pytest.raises(ValueError, match="rank 2 failed"):
        LocalRing.run(rank, 4)
