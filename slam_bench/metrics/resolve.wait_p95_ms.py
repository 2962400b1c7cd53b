"""resolve.wait_p95_ms: the 95th percentile over every frame of the wait
between a `track_*` call's return and its pose being readable, in a
session that reads every pose. Layer: async pipeline, read side. Moves:
frame_p95_ms."""

import numpy as np


def read(run):
    waits = [x["t2"] - x["t1"] for x in run["sessions"] if x["t2"] is not None]
    if not waits:
        return None
    return float(np.percentile(np.concatenate(waits) / 1e6, 95.0))
