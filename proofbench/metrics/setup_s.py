"""setup_s: seconds from the process's start to the window's (the library
load, the circuit and its witnesses, the SRS, preprocessing, the warm-up)."""


def read(ctx):
    return ctx.setup_s
