"""The seeded inputs: one seed gives the same traffic twice, seeds give
different traffic, and every seed the same amount of work."""

import numpy as np
import pytest
import torch

from benchmark.lib import data, weights
from benchmark.tests import tiny

SEEDS = (3, 2 ** 31 + 11)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_pool_repeats(seed):
    c, t = tiny.config(), tiny.traffic("train_step")
    a = data.train_pool(c, t, seed, "cpu")
    b = data.train_pool(c, t, seed, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(data.train_order(t, seed, 1, "cpu"),
                       data.train_order(t, seed, 1, "cpu"))


def test_train_pool_differs_across_seeds():
    c, t = tiny.config(), tiny.traffic("train_step")
    a, b = (data.train_pool(c, t, s, "cpu") for s in SEEDS)
    assert not torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])
    assert not torch.equal(data.train_order(t, SEEDS[0], 0, "cpu"),
                           data.train_order(t, SEEDS[1], 0, "cpu"))


def test_train_labels_follow_the_collator():
    c, t = tiny.config(), tiny.traffic("train_step")
    feats, labels, dec_in = data.train_pool(c, t, 5, "cpu")
    m = c["model"]
    real = (labels != data.LABEL_IGNORE_ID).sum(1)
    assert real.min() >= t["real_tokens"][0]
    assert real.max() <= t["real_tokens"][1]
    assert (labels[:, :3] == torch.tensor(
        [m["first_language_id"], m["transcribe_id"],
         m["notimestamps_id"]])).all()
    assert (dec_in[:, 0] == m["sot_id"]).all()
    for i in range(labels.shape[0]):
        k = int(real[i])
        assert labels[i, k - 1] == m["eot_id"]
        assert torch.equal(dec_in[i, 1:k], labels[i, :k - 1])
    assert feats.dtype == torch.bfloat16


def test_every_seed_has_the_same_work():
    c, t = tiny.config(), tiny.traffic("decode")
    lengths = [np.sort(data.clip_lengths(t, t["pool_clips"], s))
               for s in SEEDS]
    assert np.array_equal(*lengths)
    pools = [data.decode_pool(c, t, s, "cpu") for s in SEEDS]
    for pool, seed in zip(pools, SEEDS):
        n = data.clip_lengths(t, t["pool_clips"], seed)
        nonzero = (pool != 0).any(axis=1)
        last = nonzero.shape[1] - np.argmax(nonzero[:, ::-1], axis=1)
        assert np.array_equal(last, n)
    assert not np.array_equal(pools[0], pools[1])


def test_weights_repeat_and_differ():
    c = tiny.config()
    a, b = (weights.param_tree(c, 9, "cpu") for _ in range(2))
    other = weights.param_tree(c, 10, "cpu")
    assert torch.equal(a["decoder"]["token_embed"], b["decoder"]["token_embed"])
    assert not torch.equal(a["decoder"]["token_embed"],
                           other["decoder"]["token_embed"])
    la = weights.adapter_tree(c, 9, "cpu")["encoder"]["layers"][1]["fc1"]
    lb = weights.adapter_tree(c, 9, "cpu")["encoder"]["layers"][1]["fc1"]
    assert all(torch.equal(la[k], lb[k]) for k in la)
