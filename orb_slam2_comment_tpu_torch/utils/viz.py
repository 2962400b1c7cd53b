"""Visualization — the port of `orb_slam2_comment_tpu/utils/viz.py`: the
reference's Viewer/FrameDrawer/MapDrawer (src/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc) as offline renderers over the port's `MapState` (tensors on
any device; each view copies what it draws to the host).

- annotate_frame: tracked/untracked keypoints over the image + status text
  (FrameDrawer::DrawFrame/DrawTextInfo, src/FrameDrawer.cc:38-166)
- plot_map: map points, keyframe frusta, covisibility graph, spanning
  tree, loop edges, current camera (MapDrawer, src/MapDrawer.cc:44-227)
- Viewer: snapshots of both views every `period` frames of a running
  System (Viewer::Run, src/Viewer.cc:58-141); frames are written through
  utils/pngio.py.

PIL (the status bar's text) and matplotlib (plot_map) are imported only
when used, as in the reference; without PIL the status bar is left out.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.utils import pngio

_STATE_TEXT = {
    -1: "WAITING FOR IMAGES", 0: "TRYING TO INITIALIZE",
    1: "SLAM MODE", 2: "TRACK LOST (trying to relocalize)",
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def annotate_frame(image, feats, assoc=None, state: int = 1, n_kfs: int = 0, n_pts: int = 0,
                   n_matches: int = None) -> np.ndarray:
    """RGB uint8 image with keypoint overlays (green = tracked map point,
    blue = detected feature without association) and a status bar
    (FrameDrawer::DrawTextInfo, src/FrameDrawer.cc:129-166)."""
    img = _np(image)
    rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
    xy = _np(feats.xy)
    valid = _np(feats.valid)
    a = _np(assoc) if assoc is not None else np.full(len(xy), -1)
    h, w = img.shape
    for i in np.where(valid)[0]:
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (2 <= x < w - 2 and 2 <= y < h - 2):
            continue
        color = (0, 220, 0) if a[i] >= 0 else (80, 80, 255)
        rgb[y - 2:y + 3, x - 2, :] = color
        rgb[y - 2:y + 3, x + 2, :] = color
        rgb[y - 2, x - 2:x + 3, :] = color
        rgb[y + 2, x - 2:x + 3, :] = color
    if n_matches is None:
        n_matches = int((a >= 0).sum())
    text = (f"{_STATE_TEXT.get(state, '?')} | KFs: {n_kfs}, "
            f"MPs: {n_pts}, Matches: {n_matches}")
    try:
        from PIL import Image, ImageDraw

        bar = Image.new("RGB", (w, 18), (0, 0, 0))
        ImageDraw.Draw(bar).text((4, 3), text, fill=(255, 255, 255))
        rgb = np.concatenate([rgb, np.asarray(bar)], axis=0)
    except ImportError:  # pragma: no cover
        pass
    return rgb


def _camera_centers(kf_pose, idx):
    out = [-kf_pose[i, :3, :3].T @ kf_pose[i, :3, 3] for i in idx]
    return np.stack(out) if out else np.zeros((0, 3))


def covisibility_edges(map_state, min_weight: int = 100):
    """Host-side covisibility edge list [(i, j, w)] with weight >=
    min_weight (the reference draws the graph at th=100,
    src/MapDrawer.cc:116-130)."""
    m = map_state
    kf_obs = _np(m.kf_obs)
    kv = _np(m.kf_valid)
    pv = _np(m.pt_valid)
    pmax = len(pv)
    kfs = np.where(kv)[0]
    sets = {}
    for i in kfs:
        o = kf_obs[i]
        o = o[(o >= 0) & (o < pmax)]
        sets[i] = set(o[pv[o]].tolist())
    edges = []
    for ai, i in enumerate(kfs):
        for j in kfs[ai + 1:]:
            wgt = len(sets[i] & sets[j])
            if wgt >= min_weight:
                edges.append((int(i), int(j), wgt))
    return edges


def plot_map(map_state, trajectory=None, out_path: str = "map.png", title: str = "",
             current_Tcw=None, loop_edges=(), show_graph: bool = True,
             min_covis_weight: int = 100):
    """Top-down (x-z) view: map points, keyframe frusta, covisibility
    graph + spanning tree + loop edges, trajectory, current camera."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = map_state
    pts = _np(m.pt_pos)
    pv = _np(m.pt_valid)
    kf = _np(m.kf_pose)
    kv = _np(m.kf_valid)
    parent = _np(m.kf_parent)

    fig, ax = plt.subplots(figsize=(8, 8))
    if pv.any():
        ax.scatter(pts[pv, 0], pts[pv, 2], s=1, c="k", alpha=0.35,
                   label=f"{int(pv.sum())} map points")
    kfs = np.where(kv)[0]
    centers = _camera_centers(kf, kfs)
    cidx = {int(i): n for n, i in enumerate(kfs)}
    if len(centers):
        # keyframe frusta as little direction wedges (DrawKeyFrames)
        for n, i in enumerate(kfs):
            fwd = kf[i, :3, :3].T @ np.array([0, 0, 1.0])
            c = centers[n]
            ax.plot([c[0], c[0] + 0.25 * fwd[0]], [c[2], c[2] + 0.25 * fwd[2]],
                    "b-", lw=0.6, alpha=0.8)
        ax.plot(centers[:, 0], centers[:, 2], "b.", ms=4, label=f"{len(centers)} keyframes")
    if show_graph and len(centers):
        # spanning tree (green) + covisibility graph (gray) + loops (red)
        for i in kfs:
            p = int(parent[i])
            if p >= 0 and p in cidx:
                a, b = centers[cidx[int(i)]], centers[cidx[p]]
                ax.plot([a[0], b[0]], [a[2], b[2]], "g-", lw=0.5, alpha=0.7)
        for i, j, _w in covisibility_edges(m, min_covis_weight):
            if i in cidx and j in cidx:
                a, b = centers[cidx[i]], centers[cidx[j]]
                ax.plot([a[0], b[0]], [a[2], b[2]], "-", c="0.6", lw=0.4, alpha=0.5)
        for i, j in loop_edges:
            if i in cidx and j in cidx:
                a, b = centers[cidx[int(i)]], centers[cidx[int(j)]]
                ax.plot([a[0], b[0]], [a[2], b[2]], "r-", lw=1.2, alpha=0.9)
    if trajectory is not None and len(trajectory):
        tr = np.stack([-_np(T)[:3, :3].T @ _np(T)[:3, 3] for T in trajectory])
        ax.plot(tr[:, 0], tr[:, 2], "g-", lw=0.6, alpha=0.7, label="trajectory")
    if current_Tcw is not None:
        T = _np(current_Tcw)
        c = -T[:3, :3].T @ T[:3, 3]
        ax.plot([c[0]], [c[2]], "r^", ms=9, label="current camera")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


class Viewer:
    """Offline stand-in for the reference's Pangolin Viewer thread
    (src/Viewer.cc): attach to a System, call update() per frame, and it
    writes frame/map snapshots every `period` frames."""

    def __init__(self, system, out_dir: str = "viewer_out", period: int = 10):
        self.system = system
        self.out_dir = out_dir
        self.period = max(1, int(period))
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, image, feats=None, assoc=None, Tcw=None):
        """Per-frame hook (FrameDrawer::Update, src/FrameDrawer.cc:167)."""
        self.n += 1
        if self.n % self.period:
            return None
        trk = self.system.tracker
        m = trk.map
        paths = []
        if feats is not None:
            img = annotate_frame(image, feats, assoc, state=trk.state, n_kfs=trk.n_kfs,
                                 n_pts=int(_np(m.pt_valid).sum()))
            p = os.path.join(self.out_dir, f"frame_{self.n:05d}.png")
            pngio.write(p, img)
            paths.append(p)
        p = os.path.join(self.out_dir, f"map_{self.n:05d}.png")
        plot_map(m, out_path=p, current_Tcw=Tcw, title=f"frame {self.n}")
        paths.append(p)
        return paths
