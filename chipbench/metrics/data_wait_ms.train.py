"""Host time a training step in the program's ``train.data`` mark: the
batch from the data pipeline to the device (``launch/train.run``)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    spans = [e - s for name, s, e in ctx["host_ops"] if name == "train.data"]
    return 1e3 * sum(spans) / 1e9 / ctx["steps"] if spans else None
