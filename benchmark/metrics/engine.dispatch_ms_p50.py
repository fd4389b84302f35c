"""``engine.dispatch_ms_p50``: The median host time of a dispatch, from the server's summary."""


def read(ctx):
    return ctx["summary"].get("dispatch_ms_p50") if ctx["kind"] == "serve" else None
