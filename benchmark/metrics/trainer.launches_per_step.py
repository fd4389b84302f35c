"""``trainer.launches_per_step``: Kernel-launch calls on the host per training step in the slice."""

from benchmark import readers


def read(ctx):
    return readers.launches_per(ctx, "train")
