"""``server.rows_per_dispatch``: Requests completed per dispatch, from the server's summary."""


def _rows(ctx):
    if ctx["kind"] != "serve":
        return None
    s = ctx["summary"]
    return s["completed"] / s["dispatches"] if s.get("dispatches") else None


def read(ctx):
    return _rows(ctx)
