"""``server.queue_ms_p50``: The median of the server's own queue_wait spans."""

from benchmark import readers


def read(ctx):
    return readers.queue_ms_p50(ctx)
