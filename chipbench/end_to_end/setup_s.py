"""Process start to the window's start: imports, the card's start, the
weights' draw, loading (or at a checkout's first run building) the
program's kernels, and the cell's warm-up (the checked training steps, or
one prefill batch of every prompt length)."""


def read(run):
    return run.setup_s
