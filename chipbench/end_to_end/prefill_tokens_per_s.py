"""Every prompt token prefilled in the window over the window's wall time
(host clock, from the first batch's submission to the last one's return)."""


def read(run):
    if run.kind != "prefill":
        return None
    return run.mix["batch"] * sum(run.res.lengths) / run.res.window_s
