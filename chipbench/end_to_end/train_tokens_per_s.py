"""Every labelled token trained in the window over the window's wall time
(host clock, both ends at a synchronised step boundary of the program's
per-step hook); no step is left out."""


def read(run):
    return run.res.tokens / run.res.window_s if run.kind == "train" else None
