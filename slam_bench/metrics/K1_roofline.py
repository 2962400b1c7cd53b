"""K1_roofline: the share of its roofline that kernel K1 (FAST score and
NMS over a level stack, csrc/fast_nms.cu) reaches in the window: the
launches' summed least time (slam_bench/roofline.py) over their summed
device time by name in the profiler's trace. Layer: kernels. Moves: fps."""

NAME = "fast_nms_levels_kernel"


def read(run):
    dev = run["device"]
    if dev is None or not dev["k1_bound_s"]:
        return None
    secs = sum(v[0] for n, v in dev["names"].items() if NAME in n)
    count = sum(v[1] for n, v in dev["names"].items() if NAME in n)
    if not count or secs <= 0:
        return None
    return 100.0 * count * dev["k1_bound_s"] / secs
