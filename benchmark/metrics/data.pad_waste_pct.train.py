"""``data.pad_waste_pct.train``: The padded share of the node rows of the window's collated batches."""

from benchmark import readers


def read(ctx):
    return readers.pad_waste_pct(ctx, "train")
