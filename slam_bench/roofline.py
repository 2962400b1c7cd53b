"""The table of peaks and the operations and bytes of the port's kernels
K1 (FAST score + NMS over a frame's level stack, `csrc/fast_nms.cu`) and
K3 (motion-only LM, `csrc/pose_lm.cu`): the least time the card could
take for a launch, against which a kernel's measured device time is its
roofline share.

A frozen copy of `chip_smoke.py`'s bound arithmetic (`bound`,
`minmax_rate`, `K1_SLOTS_PER_PX`, `K3_OPS_PER_EDGE_ITER`, `k3_bound`).
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 minimum and maximum issue at 64 results per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, the arithmetic-instruction
# throughput table: "compare, minimum, maximum").
MINMAX_PER_SM_CLOCK = 64
EDGE_THRESHOLD = 19

# K1 per pixel inside the mask, in f32 min/max issue slots: the doubling
# over 2, 4 and 8 ring elements for both polarities (2 x 3 x 16),
# min9/max9 (2 x 16), the extrema over the 16 arcs (2 x 15) and their max,
# the mask select, the 8 NMS compares and the keep select; the 16 ring
# differences issue at twice that rate (8 slots).
K1_SLOTS_PER_PX = 2 * 3 * 16 + 2 * 16 + 2 * 15 + 1 + 1 + 8 + 1 + 16 // 2
# K3 per edge and LM iteration: at the current pose, transform (18),
# projection and residuals (12), chi2 (8), Huber weight (4), Jacobian rows
# (20), the 21 + 6 normal-equation sums (27 x 8); at the candidate pose
# transform, projection, residuals, chi2, robust cost and its sum (45).
K3_OPS_PER_EDGE_ITER = 18 + 12 + 8 + 4 + 20 + 27 * 8 + 45
K3_ITERS = 4 * 10


def minmax_rate(sms: int, max_sm_clock_mhz: float) -> float:
    """f32 min/max the card can issue per second: every SM at the card's
    maximum SM clock."""
    return sms * MINMAX_PER_SM_CLOCK * max_sm_clock_mhz * 1e6


def bound_s(nbytes: float, nops: float, rate: float = PEAK_F32_FLOPS) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over their rate."""
    return max(nbytes / PEAK_BYTES_PER_S, nops / rate)


def k1_bound_s(level_sizes, rate: float) -> float:
    """One K1 launch over a level stack of these (h, w) levels: each
    level's pixels read and its scores written once (f32), and the slots
    of every pixel inside the border mask."""
    px = sum(h * w for h, w in level_sizes)
    m = 2 * EDGE_THRESHOLD
    inside = sum((h - m) * (w - m) for h, w in level_sizes)
    return bound_s(2 * 4 * px, K1_SLOTS_PER_PX * inside, rate)


def k3_bound_s(B: int, n: int, n_valid: int) -> float:
    """One K3 launch of B poses over n edge slots, n_valid of them valid:
    points and observations (12 B each), octave (4), the two flags (1
    each) per slot, the start pose and level table in, pose, inlier mask
    and count out; 40 LM iterations over the valid edges."""
    nbytes = B * (30 * n + 64 + 32 + 64 + n + 4)
    return bound_s(nbytes, K3_OPS_PER_EDGE_ITER * K3_ITERS * n_valid)
