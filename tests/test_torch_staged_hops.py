"""The hops of a DistRing (neuspeech1_tpu_torch/parallel/ring_attention.py)
over gloo, two processes on the CPU: the host staging that CUDA tensors
take over gloo (which sends and receives host tensors only) gives the
group's own send and receive, and is counted in the ``ring.staged_*``
counters (``train/profiling.py``); host tensors on gloo hop without it. This file imports neither JAX nor the JAX
package."""

import os

import numpy as np
import torch

from tests import torch_spawn

N = 2


def test_staged_hops_equal_the_group_hops(tmp_path):
    torch.multiprocessing.spawn(
        torch_spawn.staged_hop_rank,
        args=(N, str(tmp_path / "store"), str(tmp_path)), nprocs=N)
    for r in range(N):
        got = np.load(os.path.join(tmp_path, f"rank{r}.npz"))
        np.testing.assert_array_equal(got["staged"], got["plain"])
        # permute takes rank - 1's tensors, permute_back rank + 1's
        prev = (r - 1) % N
        np.testing.assert_array_equal(got["plain"][0],
                                      np.arange(4) + 10 * prev)
        # two hops of a [2, 3] f32 and a [4] int64 tensor, timed
        assert list(got["counts"]) == [2, 2 * (24 + 32), 1]
