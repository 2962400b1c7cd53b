"""K3_roofline: the share of its roofline that kernel K3 (motion-only LM,
csrc/pose_lm.cu) reaches in the window: each launch's least time from its
poses and valid edges (slam_bench/roofline.py), summed, over the summed
device time by name in the profiler's trace. Layer: kernels. Moves: fps."""

NAME = "pose_lm_kernel"


def read(run):
    dev = run["device"]
    if dev is None or not dev["k3_bound_s"]:
        return None
    secs = sum(v[0] for n, v in dev["names"].items() if NAME in n)
    if secs <= 0:
        return None
    return 100.0 * dev["k3_bound_s"] / secs
