"""Tensor helpers: JAX's gather/scatter/top_k semantics, reproduced
deterministically on CPU and CUDA, and device constants made without a
host sync.

- `top_k`: `jax.lax.top_k` breaks ties toward the lower index; a stable
  descending sort does the same, `torch.topk` does not promise it.
- `scatter_set`: `x.at[idx].set(v)` on XLA:CPU applies updates in order,
  so where an index repeats the LAST update wins; out-of-range indices are
  dropped. `Tensor.index_put_` leaves repeated indices undefined on CUDA.
- `segment_sum`: a float scatter-add without atomics (CUDA `index_add_`
  on floats sums in a run-dependent order).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor made once per (values, dtype, device). A
    host-to-device copy from pageable memory synchronizes the stream, so a
    constant rebuilt per call would stall the host each time. Callers must
    not modify the result."""
    return _const(values, dtype, str(device))


def scalar(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """0-d tensor of a host scalar on like's device, filled on the device
    (no host-to-device copy); tensors pass through."""
    if isinstance(v, torch.Tensor):
        return v if dtype is None else v.to(dtype)
    return torch.full((), v, dtype=dtype or like.dtype, device=like.device)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (lax.top_k semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Functional `dst.at[idx].set(val)` along dim 0 with last-update-wins
    on repeated indices and out-of-range indices dropped."""
    n = dst.shape[0]
    idx = idx.reshape(-1).long()
    m = idx.shape[0]
    val = scalar(val, dst, dst.dtype)
    shape = (m,) + tuple(dst.shape[1:])
    val = val.expand(shape) if val.dim() == 0 else val.reshape(shape)
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, n)
    pos = torch.arange(m, device=dst.device)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device)
    win = win.scatter_reduce(0, tgt, pos, reduce="amax")
    keep = ok & (win[tgt] == pos)
    tgt = torch.where(keep, tgt, n)
    out = torch.cat([dst, dst[:1]], dim=0)
    # repeated targets remain only at the dump row n, which is cut away
    out.index_put_((tgt,), val)
    return out[:n]


class SegmentPlan:
    """A segment-sum over fixed segment ids, sorted once and applied to
    many value arrays (the global BA sums over the same observation-to-
    point map dozens of times per iteration)."""

    def __init__(self, seg: torch.Tensor, n_seg: int):
        seg = seg.reshape(-1).long()
        ok = (seg >= 0) & (seg < n_seg)
        seg = torch.where(ok, seg, n_seg)
        self.n_seg = n_seg
        self.order = torch.sort(seg, stable=True).indices
        # integer index_add_ is exact in any order (bincount would sync on CUDA)
        counts = torch.zeros(n_seg + 1, dtype=torch.long, device=seg.device)
        counts = counts.index_add_(0, seg, torch.ones_like(seg))[:n_seg]
        self.ends = torch.cumsum(counts, dim=0)
        self.starts = self.ends - counts

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        # scan along the last (contiguous) axis: an outer-axis scan is ~100x
        # slower on CUDA
        v = vals.reshape((self.order.shape[0], -1))[self.order].double().T.contiguous()
        csum = torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v, dim=1)], dim=1)
        out = (csum[:, self.ends] - csum[:, self.starts]).T
        return out.to(vals.dtype).reshape((self.n_seg,) + vals.shape[1:])


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """out[s] = sum of vals[i] with seg[i] == s, for s in [0, n_seg);
    entries with seg outside that range are dropped. Deterministic on
    CUDA: a stable sort by segment, an f64 prefix sum, differences at the
    segment boundaries."""
    return SegmentPlan(seg, n_seg).sum(vals)
