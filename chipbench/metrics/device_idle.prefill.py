"""The device's idle share of the traced prefill window: one less the union
of the device operations' intervals over the window's wall time."""


def read(ctx):
    if ctx["kind"] != "prefill":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
