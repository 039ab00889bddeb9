"""Shard-rotating device cache: the port of
``neuspeech1_tpu/data/rotating_cache.py``, for corpora larger than the
cache budget.

The epoch is cut into shards sized so that two fit the budget. While the
train loop consumes batches gathered on the device from the resident
shard, the next shard is collated into pinned host memory on a worker
thread and copied to the device on a side CUDA stream; an event on that
stream is what the compute stream waits for before its first batch of the
new shard, so neither the host nor the device stops for the copy. Each
shard is trained ``shard_repeats`` passes while the next stages; a full
rotation over the shards is one epoch.

The shard order and each pass's batch order come from numpy's generator,
seeded ``seed + epoch`` and drawn in the JAX package's order, so they are
the JAX package's.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from neuspeech1_tpu_torch.data.device_cache import host_batch, to_device_batch


class _Shard:
    def __init__(self, indices: np.ndarray, batch: dict, ready=None):
        self.indices = indices
        self.features = batch["input_features"]
        self.labels = batch["labels"]
        self.decoder_input_ids = batch["decoder_input_ids"]
        self.ready = ready  # a CUDA event after the copies, or None


class RotatingDeviceCache:
    """Iterable loader (the Trainer's protocol) over shard-rotated device
    batches. ``shard_clips``: clips per shard (`shards_for_budget`)."""

    def __init__(self, dataset, collator, shard_clips: int, batch_size: int,
                 device="cuda", feature_dtype=torch.bfloat16, seed: int = 0,
                 shard_repeats: int = 1):
        if collator.max_label_len is None:
            raise ValueError("RotatingDeviceCache needs a static "
                             "max_label_len")
        if shard_clips < batch_size:
            raise ValueError(f"shard_clips {shard_clips} < batch_size "
                             f"{batch_size}")
        self.dataset = dataset
        self.collator = collator
        self.shard_clips = shard_clips
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.feature_dtype = feature_dtype
        self.seed = seed
        self.shard_repeats = max(1, shard_repeats)
        self.n = len(dataset)
        self.epoch = 0
        self.shards_staged = 0
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    @staticmethod
    def shards_for_budget(budget_bytes: int, bytes_per_clip: int) -> int:
        """Clips per shard with TWO shards resident (train + staging)."""
        return max(1, int(budget_bytes // 2) // max(1, bytes_per_clip))

    def __len__(self):
        per_shard = lambda m: (m // self.batch_size) * self.shard_repeats
        full, rem = divmod(self.n, self.shard_clips)
        return full * per_shard(self.shard_clips) + per_shard(rem)

    # ------------------------------------------------------------------
    def _collate(self, indices) -> dict:
        """Host side of staging (the worker thread): collate, convert and
        pin."""
        return host_batch(self.collator([self.dataset[int(i)]
                                         for i in indices]),
                          self.feature_dtype, pin=self._side is not None)

    def _upload(self, indices, host: dict) -> _Shard:
        """Device side of staging: the copies on the side stream, then an
        event there (on the CPU, plain copies)."""
        self.shards_staged += 1
        if self._side is None:
            return _Shard(np.asarray(indices), to_device_batch(
                host, self.device, self.feature_dtype))
        with torch.cuda.stream(self._side):
            batch = to_device_batch(host, self.device, self.feature_dtype)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return _Shard(np.asarray(indices), batch, ready)

    def _activate(self, shard: _Shard) -> None:
        """Make the compute stream wait for ``shard``'s copies, and tell the
        allocator its tensors are used there."""
        if shard.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(shard.ready)
        for t in (shard.features, shard.labels, shard.decoder_input_ids):
            t.record_stream(stream)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        perm = rng.permutation(self.n)
        shards = [perm[i:i + self.shard_clips]
                  for i in range(0, self.n, self.shard_clips)]
        with ThreadPoolExecutor(max_workers=1) as pool:
            cur = self._upload(shards[0], self._collate(shards[0]))
            for si in range(len(shards)):
                self._activate(cur)
                pending: Optional[Future] = None
                nxt: Optional[_Shard] = None
                if si + 1 < len(shards):
                    pending = pool.submit(self._collate, shards[si + 1])
                m = cur.features.shape[0]
                for _ in range(self.shard_repeats):
                    order = rng.permutation(m)
                    order_dev = torch.from_numpy(order)
                    if self._side is not None:
                        order_dev = order_dev.pin_memory()
                    order_dev = order_dev.to(self.device, non_blocking=True)
                    for bi in range(m // self.batch_size):
                        sl = slice(bi * self.batch_size,
                                   (bi + 1) * self.batch_size)
                        idx = order_dev[sl]
                        yield {
                            "input_features":
                                cur.features.index_select(0, idx),
                            "labels": cur.labels.index_select(0, idx),
                            "decoder_input_ids":
                                cur.decoder_input_ids.index_select(0, idx),
                            "_indices": cur.indices[order[sl]],
                        }
                        # the next shard's copies start as soon as its host
                        # side is ready
                        if pending is not None and pending.done():
                            nxt = self._upload(shards[si + 1],
                                               pending.result())
                            pending = None
                if pending is not None:
                    nxt = self._upload(shards[si + 1], pending.result())
                if nxt is not None:
                    cur = nxt
