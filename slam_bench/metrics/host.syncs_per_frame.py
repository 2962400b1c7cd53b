"""host.syncs_per_frame: host syncs that torch's sync debug mode reports
in the window, per frame handed in. Layer: API / host tracker. Moves: fps."""


def read(run):
    syncs = [x["syncs"] for x in run["sessions"]]
    if any(s is None for s in syncs) or not run["frames"]:
        return None
    return sum(syncs) / run["frames"]
