"""Bag-of-words vocabulary — the part of `orb_slam2_comment_tpu/ops/bow.py`
the RGB-D main path needs: loading the tree and the FeatureVector group ids
that gate reference-keyframe matching (SearchByBoW). Place recognition
(transform, BoW vectors, inverted files) is outside this port's slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam2_comment_tpu_torch.ops.orb import unpack_descriptors_signed


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
    invalid features). Child distances are exact integer dot products of
    +-1 vectors; argmin takes the first minimum, as jnp.argmin."""
    n = desc.shape[0]
    sbits = unpack_descriptors_signed(desc)
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    nmax = node_desc_signed.shape[0]
    for _ in range(levels):
        ch = children[node]
        has = ch >= 0
        chc = torch.clamp(ch, 0, nmax - 1).long()
        cent = node_desc_signed[chc]                          # [N, k, 256]
        dots = (cent @ sbits[:, :, None])[..., 0]             # [N, k]
        dch = torch.where(has, -dots, torch.full_like(dots, 1e9))
        best = torch.argmin(dch, dim=1)
        nxt = torch.gather(chc, 1, best[:, None])[:, 0]
        node = torch.where(torch.any(has, dim=1), nxt, node)
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)
