"""``model.mfu_pct.serve``: The serving window's model products (one forward a request, real points) over the peak."""

from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx, "serve")
