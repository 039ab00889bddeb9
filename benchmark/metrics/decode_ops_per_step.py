"""Device operations (kernels, copies, sets) per decode step in the
profiled slice: the slice's device events over its requests' steps (one
per new token)."""


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    return len(p.ops) / (p.units * run.traffic["new_tokens"])
