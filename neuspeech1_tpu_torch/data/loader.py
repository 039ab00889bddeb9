"""Prefetching data loader: the port's copy of
``neuspeech1_tpu/data/loader.py``.

The reference leans on torch DataLoader with 16 worker processes
(`finetune.py:249`); per-item `np.load` in `__getitem__` would starve the
device. Here a thread loads and collates batches ahead of time into a
bounded queue; batches stay numpy, and the caller uploads them (the eval
CLI's `cli/common.py::upload_features`, pinned and asynchronous on CUDA).
With ``native_signals`` the signals of a batch come from the C++ clip
loader (`data/native_loader.py`), whose threads read the files in parallel.

Under data parallelism over several processes ``batch_size`` is the global
batch: process ``process_index`` of ``process_count`` takes the strided
rows ``[process_index::process_count]`` of every global batch, so every
process sees the same batch order and the processes' rows together are
each global batch once. A process's share of a short last batch
(``drop_last=False``) may hold no row: it comes as a batch of nothing but
an empty ``_indices``, so that every process sees the same number of
batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        collator: Callable,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int = 4,
        prefetch: int = 2,
        native_signals: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._native = None
        if native_signals:
            if not getattr(dataset, "supports_native_signals", lambda: False)():
                raise ValueError(
                    "dataset configuration not compatible with the native "
                    "signal loader (train-time augmentation active)"
                )
            from neuspeech1_tpu_torch.data.native_loader import NativeClipLoader

            self._native = NativeClipLoader(num_threads=self.num_threads)
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError("global batch_size must divide evenly across hosts")

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _batch_index_lists(self):
        idx = self._epoch_indices()
        nb = len(idx) // self.batch_size
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        if not self.drop_last and len(idx) % self.batch_size:
            batches.append(idx[nb * self.batch_size :])
        # this process's shard of each global batch
        if self.process_count > 1:
            batches = [b[self.process_index :: self.process_count]
                       for b in batches]
        return batches

    def _load_batch(self, index_list) -> dict:
        if len(index_list) == 0:
            return {"_indices": np.asarray(index_list)}
        if self._native is not None:
            ds = self.dataset
            paths = [ds.signal_path(int(i)) for i in index_list]
            signals = self._native.load_batch(
                paths, ds.modal_ch, ds.n_samples,
                channel_slice=ds.channel_slice,
            )
            samples = [
                {"input_features": signals[j],
                 "labels": ds.get_labels(int(i))}
                for j, i in enumerate(index_list)
            ]
        else:
            samples = [self.dataset[int(i)] for i in index_list]
        batch = self.collator(samples)
        batch["_indices"] = np.asarray(index_list)
        return batch

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_index_lists()
        self.epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._load_batch(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._load_batch(b))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def epochs(loader: DataLoader, n_epochs: Optional[int] = None):
    """Infinite (or n-epoch) stream of batches."""
    e = 0
    while n_epochs is None or e < n_epochs:
        yield from loader
        e += 1
