"""mapper.kf_per_100_frames: keyframes the window's frames created (the
`created_kf` of their outputs, through the tracker's keyframe callbacks),
per 100 frames: the mapper's work, so that a faster fps from fewer
keyframes shows. Layer: mapper. Moves: fps."""


def read(run):
    if not run["frames"]:
        return None
    return 100.0 * sum(x["kf_created"] for x in run["sessions"]) / run["frames"]
