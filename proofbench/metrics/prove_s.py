"""prove_s: the window's seconds over the proves it holds (whole proves; the
window ends with the last prove started before --seconds)."""


def read(ctx):
    return ctx.window_s / ctx.count if ctx.count else None
