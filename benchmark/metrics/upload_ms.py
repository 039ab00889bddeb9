"""Host ms per request in ``cli/common.py::upload_features`` (the zero
tail's crop, the cast to bf16, the pin and the copy's enqueue), timed by
the host's clock around the call over every request of the window."""


def read(run):
    s = run.stats.get("upload_s")
    return None if s is None else s * 1e3
