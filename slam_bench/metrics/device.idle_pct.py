"""device.idle_pct: the share of the window in which the card runs no
kernel, copy or set, over the union of every session's profiler trace.
Layer: device. Moves: fps."""


def read(run):
    dev = run["device"]
    if dev is None or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
