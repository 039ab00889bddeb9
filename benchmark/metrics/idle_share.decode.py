"""The share of the profiled slice of beam requests in which no
operation ran on the device, in %: 1 minus the union of the device
intervals over the slice's length on the host's clock."""


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    return 100 * (1 - p.busy_s / p.window_s)
