"""``fixture.steps``: the window's steps, a reader that only a test loads."""


def read(ctx):
    return ctx.get("steps")
