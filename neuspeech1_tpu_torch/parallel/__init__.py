"""Multi-device parallelism of the PyTorch port: the port of
``neuspeech1_tpu/parallel``.

- ``ring_attention``: sequence-parallel (ring) flash self-attention over a
  ``Ring`` of ranks, with two rings: ``DistRing`` over a
  ``torch.distributed`` process group, and ``LocalRing``, n ranks as n
  threads on one device (``LocalRing.run_mesh``: a grid of them, one ring
  per axis; for tests and ``chip_smoke.py``).
- ``mesh``: ``AXES``, ``make_mesh`` over ``torch.distributed``'s
  ``DeviceMesh``, ``initialize_distributed``, ``batch_sharding`` and
  ``replicated``, and the ambient mesh (``set_mesh``) whose axes a config's
  ``seq_parallel_axis`` and ``pipeline_axis`` name, and whose ``data`` axis
  the training step averages over.
- ``pipeline``: GPipe over a ring, for a config's ``pipeline_axis``.
- ``sharding``: FSDP and tensor parallelism over the mesh's ``fsdp`` and
  ``tensor`` axes: the weights' splits, ``shard_params`` and
  ``gather_params``, and the collectives of the split linears.

The axes compose as the JAX package's do: the ring inside pipeline
stages, the split linears inside either, and ``data`` beside all of them.
"""
