"""host.call_ms: the mean host time of one `System.track_*` call in the
window, every call of every session (the benchmark's span around the
call). Layer: API / host tracker. Moves: fps."""


def read(run):
    n = sum(len(x["t0"]) for x in run["sessions"])
    if not n:
        return None
    return sum(float((x["t1"] - x["t0"]).sum()) for x in run["sessions"]) / n / 1e6
