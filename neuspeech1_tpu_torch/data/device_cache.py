"""Device-resident dataset cache: the port of
``neuspeech1_tpu/data/device_cache.py``. The whole train set is collated
once and staged on the device (features in bf16), and batches are gathered
there by index, so the steady state moves no signal bytes from the host.

Batches are drawn with a ``torch.Generator`` on the cache's device, seeded
``seed + epoch`` for each epoch: every epoch is a permutation of the corpus,
but not the one ``jax.random`` draws in the JAX package, so the batch order
differs from it.

Usage:
    cache = DeviceCache.build(dataset, collator, device="cuda")
    for batch in cache.loader(batch_size=64, seed=0):
        ...                                   # every tensor on the device
"""

from __future__ import annotations

import torch


def host_batch(batch: dict, feature_dtype=torch.bfloat16,
               pin: bool = False) -> dict:
    """A collated batch as host tensors: features in ``feature_dtype``,
    labels and decoder inputs as int64 (the port's loss gathers with
    them); pinned with ``pin``, so that copies from them are
    asynchronous."""
    def put(x, dtype):
        t = torch.as_tensor(x).to(dtype)
        return t.pin_memory() if pin else t

    return {"input_features": put(batch["input_features"], feature_dtype),
            "labels": put(batch["labels"], torch.long),
            "decoder_input_ids": put(batch["decoder_input_ids"], torch.long)}


def to_device_batch(batch: dict, device, feature_dtype=torch.bfloat16
                    ) -> dict:
    """A collated batch on ``device`` (`host_batch`, then asynchronous
    copies from pinned memory to a CUDA device)."""
    host = host_batch(batch, feature_dtype,
                      pin=torch.device(device).type == "cuda")
    return {k: v.to(device, non_blocking=True) for k, v in host.items()}


class DeviceCache:
    def __init__(self, features, labels, decoder_input_ids):
        self.features = features
        self.labels = labels
        self.decoder_input_ids = decoder_input_ids
        self.n = features.shape[0]

    @staticmethod
    def build(dataset, collator, device="cuda",
              feature_dtype=torch.bfloat16) -> "DeviceCache":
        """Collate the dataset once (the only host -> device copy);
        ``collator.max_label_len`` must be set."""
        if collator.max_label_len is None:
            raise ValueError("DeviceCache needs a static max_label_len")
        batch = to_device_batch(collator([dataset[i]
                                          for i in range(len(dataset))]),
                                device, feature_dtype)
        return DeviceCache(batch["input_features"], batch["labels"],
                           batch["decoder_input_ids"])

    @property
    def device(self) -> torch.device:
        return self.features.device

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in
                   (self.features, self.labels, self.decoder_input_ids))

    def gather(self, idx: torch.Tensor) -> dict:
        """The rows ``idx`` (a device index tensor), and the indices."""
        return {"input_features": self.features.index_select(0, idx),
                "labels": self.labels.index_select(0, idx),
                "decoder_input_ids":
                    self.decoder_input_ids.index_select(0, idx),
                "_indices": idx}

    def make_sampler(self, batch_size: int):
        """``sample(generator) -> batch``: ``batch_size`` rows drawn
        uniformly with replacement, on the device, from an explicit
        ``torch.Generator`` on the cache's device (the JAX package's
        ``key -> batch`` sampler). The batch dict is `gather`'s without
        its indices."""
        def sample(generator: torch.Generator) -> dict:
            idx = torch.randint(0, self.n, (batch_size,),
                                generator=generator, device=self.device)
            batch = self.gather(idx)
            del batch["_indices"]
            return batch

        return sample

    def epoch_batches(self, generator: torch.Generator, batch_size: int):
        """One shuffled epoch of full batches, gathered on the device (no
        host sync: the permutation stays there)."""
        perm = torch.randperm(self.n, generator=generator, device=self.device)
        for i in range(self.n // batch_size):
            yield self.gather(perm[i * batch_size:(i + 1) * batch_size])

    def loader(self, batch_size: int, seed: int = 0):
        """The Trainer's loader protocol: each iteration is one epoch."""
        return _DeviceCacheLoader(self, batch_size, seed)


class _DeviceCacheLoader:
    def __init__(self, cache: DeviceCache, batch_size: int, seed: int = 0):
        self.cache = cache
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return self.cache.n // self.batch_size

    def __iter__(self):
        gen = torch.Generator(device=self.cache.device)
        gen.manual_seed(self.seed + self.epoch)
        self.epoch += 1
        yield from self.cache.epoch_batches(gen, self.batch_size)
