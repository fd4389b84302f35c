"""``model.mfu_pct.train``: The training window's model products (three forwards a step, real points) over the peak."""

from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx, "train")
