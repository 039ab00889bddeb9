"""Multi-device parallelism of the PyTorch port: the port of
``neuspeech1_tpu/parallel``.

- ``ring_attention``: sequence-parallel (ring) flash self-attention over a
  ``Ring`` of ranks, with two rings: ``DistRing`` over a
  ``torch.distributed`` process group, and ``LocalRing``, n ranks as n
  threads on one device (for tests and ``chip_smoke.py``).
- ``mesh``: ``make_mesh`` over ``torch.distributed``'s ``DeviceMesh``,
  ``initialize_distributed``, and the ambient mesh (``set_mesh``) that a
  config's ``seq_parallel_axis`` names an axis of.

Not ported yet (ROADMAP.md queue 1 item 8): data-parallel gradient
averaging, ``sharding.py`` as DTensor specs, ``pipeline.py``.
"""
