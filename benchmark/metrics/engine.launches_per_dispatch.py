"""``engine.launches_per_dispatch``: Kernel-launch calls on the host per serving dispatch in the slice."""

from benchmark import readers


def read(ctx):
    return readers.launches_per(ctx, "serve")
