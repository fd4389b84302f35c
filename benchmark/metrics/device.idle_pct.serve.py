"""``device.idle_pct.serve``: The device's idle share of the profiled slice of a serving window."""

from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx, "serve")
