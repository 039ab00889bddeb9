"""The benchmark of ``neuspeech1_tpu_torch`` on NVIDIA H100 cards: see
``benchmark/README.md``."""
