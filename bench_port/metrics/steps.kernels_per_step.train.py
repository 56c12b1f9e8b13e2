"""Device operations (kernels, copies, memsets) in the traced window over
the train steps launched in it."""


def read(data, ctx):
    steps = data.counters.get("steps")
    if not steps or not data.kernels:
        return None
    return data.kernels / steps
