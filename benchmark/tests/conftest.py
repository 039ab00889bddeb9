"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``cuda`` need an NVIDIA card and skip without one; each
decides inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
