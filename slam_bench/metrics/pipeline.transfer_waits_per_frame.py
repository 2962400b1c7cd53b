"""pipeline.transfer_waits_per_frame: waits on a transfer that had not
landed (the port's `tracking.transfer_waits`, which torch's sync debug
mode does not see), per frame handed in. Layer: async pipeline. Moves:
fps."""


def read(run):
    if not run["frames"]:
        return None
    return sum(x["transfer_waits"] for x in run["sessions"]) / run["frames"]
