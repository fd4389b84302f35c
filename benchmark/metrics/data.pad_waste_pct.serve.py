"""``data.pad_waste_pct.serve``: The padded share of the server's capacity tokens, over its buckets."""

from benchmark import readers


def read(ctx):
    return readers.pad_waste_pct(ctx, "serve")
