"""Perf tooling of the PyTorch port: the counterparts of the JAX package's
TPU tuning probes under ``perf/`` (``kernel_probe``, ``mxu_probe``,
``btc_probe``, ``bwd_probe``), each a module whose ``make_*`` functions
keep the probe's names and whose sweep runs under ``python -m
neuspeech1_tpu_torch.perf.<name>`` on the card. Their kernels live in
``ops/probe_fwd.py``, ``ops/probe_bwd.py`` and ``ops/probe_dot.py``."""
