"""``device.idle_pct.train``: The device's idle share of the profiled slice of a training window."""

from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx, "train")
