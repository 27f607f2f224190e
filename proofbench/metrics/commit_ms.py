"""commit_ms: the window's milliseconds over the commitments it holds, each
with its fresh polynomial drawn on the card."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.count if ctx.count else None
