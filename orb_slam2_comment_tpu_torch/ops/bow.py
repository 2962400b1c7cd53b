"""Bag-of-binary-words place recognition — the port of
`orb_slam2_comment_tpu/ops/bow.py`: the vocabulary tree as flat arrays,
the batched descent (`transform`, `group_ids`), dense L1-normalized TF-IDF
vectors with DBoW2's L1 score, and the sparse inverted file the keyframe
database switches to for large vocabularies. Vocabulary training and the
text-vocabulary parser are not ported (the port reads the reference's
.npz vocabularies).

Float scatter-adds of the reference become integer counts times a weight
or `segment_sum`, so CUDA runs are deterministic."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.ops.orb import unpack_descriptors_signed
from orb_slam2_comment_tpu_torch.ops.scatter import scatter_set, segment_sum


@dataclass
class Vocabulary:
    """Flat-array vocabulary tree, nodes breadth-first, node 0 the root."""

    children: torch.Tensor    # [n_nodes, k] int32 child ids (-1 none)
    node_desc: torch.Tensor   # [n_nodes, 8] int32 centroid bit patterns
    node_word: torch.Tensor   # [n_nodes] int32 word id if leaf else -1
    word_weight: torch.Tensor  # [n_words] f32 IDF weights
    group_depth: int
    depth: int
    k: int

    @property
    def n_words(self):
        return self.word_weight.shape[0]

    @property
    def n_nodes(self):
        return self.children.shape[0]


def load_vocabulary(path: str, device="cpu") -> Vocabulary:
    """Read a vocabulary saved by the reference's `save_vocabulary`."""
    z = np.load(path)
    g, d, k = (int(x) for x in z["meta"])
    return Vocabulary(
        children=torch.from_numpy(z["children"].astype(np.int32)).to(device),
        node_desc=torch.from_numpy(z["node_desc"].astype(np.uint32).view(np.int32)).to(device),
        node_word=torch.from_numpy(z["node_word"].astype(np.int32)).to(device),
        word_weight=torch.from_numpy(z["word_weight"].astype(np.float32)).to(device),
        group_depth=g,
        depth=d,
        k=k,
    )


def gate_arrays(voc: "Vocabulary | None", device="cpu", k: int = 10):
    """(children int32, node_desc_signed f32 +-1) for the tracking node
    gate; a 1-node dummy tree (gate is a no-op) without a vocabulary."""
    if voc is None:
        return (torch.full((1, k), -1, dtype=torch.int32, device=device),
                torch.zeros((1, 256), dtype=torch.float32, device=device))
    return (voc.children.to(device).clone(),
            unpack_descriptors_signed(voc.node_desc.to(device)))


def group_ids(children, node_desc_signed, desc, valid, levels: int):
    """Descend `levels` levels -> FeatureVector group-node ids [N] (-1 for
    invalid features); with the 1-node dummy tree every feature lands in
    group 0 and the node gate is a no-op."""
    node, _ = _descend(children, node_desc_signed, unpack_descriptors_signed(desc), levels)
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def _descend(children, node_desc_signed, sbits, levels: int, group_depth: int = -1):
    """`levels` steps down the tree from the root for every descriptor;
    returns (leaf-side node ids, node ids at group_depth). Child distances
    are exact integers in f32; argmin takes the first minimum."""
    n = sbits.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=sbits.device)
    group = node
    nmax = node_desc_signed.shape[0]
    for d in range(levels):
        ch = children[node]
        has = ch >= 0
        chc = torch.clamp(ch, 0, nmax - 1).long()
        dots = (node_desc_signed[chc] @ sbits[:, :, None])[..., 0]     # [N, k]
        dch = torch.where(has, (256.0 - dots) * 0.5, torch.full_like(dots, 1e9))
        nxt = torch.gather(chc, 1, torch.argmin(dch, dim=1)[:, None])[:, 0]
        node = torch.where(torch.any(has, dim=1), nxt, node)
        if d + 1 == group_depth:
            group = node
    return node, group


def transform(voc: Vocabulary, desc, valid):
    """descriptors -> (word ids [N], group node ids [N], dense BoW [W]);
    the group ids are DBoW2's FeatureVector keys (Frame::ComputeBoW)."""
    signed = unpack_descriptors_signed(voc.node_desc.to(desc.device))
    node, group = _descend(voc.children, signed, unpack_descriptors_signed(desc), voc.depth,
                           voc.group_depth)
    words = torch.where(valid, voc.node_word[node], -1).to(torch.int32)
    group = torch.where(valid, group, -1).to(torch.int32)
    return words, group, bow_vector(voc, words)


def bow_vector(voc: Vocabulary, words):
    """L1-normalized TF-IDF vector (BowVector::addWeight + normalize):
    per-word counts times the word's IDF weight."""
    W = voc.n_words
    ok = words >= 0
    wid = torch.where(ok, words.long(), W)
    cnt = torch.zeros(W + 1, dtype=torch.int64, device=words.device).index_add_(
        0, wid, torch.ones_like(wid))[:W]
    v = cnt.to(torch.float32) * voc.word_weight
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def l1_score(a, b):
    """DBoW2 L1 similarity 1 - 0.5 |a - b|_1 (ScoringObject L1Scoring),
    batched over leading dimensions."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def sparse_bow(word_weight, words):
    """Per-feature word ids [N] -> sorted unique (word, weight) pairs,
    L1-normalized TF-IDF, padded with word = W and weight 0."""
    N = words.shape[0]
    W = word_weight.shape[0]
    dev = words.device
    sw = torch.sort(torch.where(words >= 0, words.long(), W)).values
    valid = sw < W
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sw[1:] != sw[:-1]]) & valid
    pos = torch.cumsum(is_first.to(torch.int64), 0) - 1
    uw = scatter_set(torch.full((N,), W, dtype=torch.int64, device=dev),
                     torch.where(is_first, pos, N), sw)
    cnt = torch.zeros(N + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(valid, pos, N), torch.ones_like(pos))[:N]
    w = cnt.to(torch.float32) * word_weight[torch.clamp(uw, 0, W - 1)]
    w = torch.where(uw < W, w, torch.zeros_like(w))
    return uw.to(torch.int32), w / torch.clamp(torch.sum(w), min=1e-9)


def inverted_file_query(post_word, post_kf, post_w, q_words, q_w, kmax: int, L: int = 96):
    """Inverted-file query: walk each query word's posting list (capped at
    L entries) and accumulate per-KF L1 scores and shared-word counts.
    Returns (scores [kmax], common [kmax], n_dropped)."""
    P = post_word.shape[0]
    pw = post_word.contiguous()
    qw_ = q_words.to(pw.dtype).contiguous()
    starts = torch.searchsorted(pw, qw_, right=False)
    ends = torch.searchsorted(pw, qw_, right=True)
    span = starts[:, None] + torch.arange(L, device=pw.device)[None, :]
    ok = (span < ends[:, None]) & (q_w > 0)[:, None]
    idx = torch.clamp(span, 0, P - 1)
    kfid = torch.clamp(post_kf[idx].long(), 0, kmax - 1)
    vw = post_w[idx]
    qw = q_w[:, None]
    contrib = torch.where(ok, qw + vw - torch.abs(qw - vw), torch.zeros_like(vw))
    both = torch.stack([contrib.reshape(-1), ok.reshape(-1).to(torch.float32)], dim=-1)
    acc = segment_sum(both, torch.where(ok.reshape(-1), kfid.reshape(-1), kmax), kmax)
    n_dropped = torch.sum(torch.where(q_w > 0, torch.clamp(ends - starts - L, min=0),
                                      torch.zeros_like(ends)))
    return 0.5 * acc[:, 0], acc[:, 1].to(torch.int32), n_dropped


def build_postings(kf_words, kf_w, kf_valid):
    """[Kmax, N] per-KF sparse vectors -> one postings array sorted by word
    (invalid KFs' entries pushed to the end)."""
    Kmax, N = kf_words.shape
    flat_w = torch.where(kf_valid[:, None], kf_words, 2 ** 30).reshape(-1)
    order = torch.sort(flat_w, stable=True).indices
    kf_of = torch.arange(Kmax, dtype=torch.int32, device=kf_words.device).repeat_interleave(N)
    return flat_w[order], kf_of[order], kf_w.reshape(-1)[order]
