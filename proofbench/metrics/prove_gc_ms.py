"""prove_gc_ms: milliseconds of the interpreter's garbage collection a prove,
every generation: the seconds between the collector's start and stop
callbacks over the window (harness._GcClock), over the proves it holds.  The
benchmark's witness pool is frozen out of the collector's sight
(systems/hyperplonk.py), so this is what the program's own objects cost."""


def read(ctx):
    return 1e3 * ctx.gc_s / ctx.count if ctx.count else None
