"""Bag-of-binary-words place recognition — the port of
`orb_slam2_comment_tpu/ops/bow.py`: the vocabulary tree as flat arrays,
the batched descent (`transform`, `group_ids`), dense L1-normalized TF-IDF
vectors with DBoW2's L1 score, and the sparse inverted file the keyframe
database switches to for large vocabularies. The host-side tools are numpy
copies of the reference's: binary k-medians training (`train_vocabulary`,
the same `default_rng` draws), the .npz and ORBvoc.txt writers, and the
ORBvoc.txt reader, whose tokenizer is vectorized numpy in place of the
reference's native one (same whitespace-stream format).

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


def _vocabulary(children, node_desc_u32, node_word, word_weight, group_depth: int,
                depth: int, k: int, device) -> Vocabulary:
    """A Vocabulary from numpy arrays in the reference's dtypes."""
    return Vocabulary(
        children=torch.from_numpy(np.asarray(children).astype(np.int32)).to(device),
        node_desc=torch.from_numpy(
            np.ascontiguousarray(np.asarray(node_desc_u32).astype(np.uint32)).view(np.int32)
        ).to(device),
        node_word=torch.from_numpy(np.asarray(node_word).astype(np.int32)).to(device),
        word_weight=torch.from_numpy(np.asarray(word_weight).astype(np.float32)).to(device),
        group_depth=group_depth, depth=depth, k=k)


def _desc_u32(voc: Vocabulary) -> np.ndarray:
    return np.ascontiguousarray(voc.node_desc.cpu().numpy()).view(np.uint32)


# ---------------------------------------------------------------------------
# host-side vocabulary tools (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def np_unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[..., 8] uint32 -> [..., 256] uint8, LSB-first per word — the same
    bit order as ops.orb.pack_bits / unpack_descriptors_signed (np.packbits
    would be MSB-first and silently permute bits)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (desc[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(desc.shape[:-1] + (256,)).astype(np.uint8)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., 256] -> [..., 8] uint32, inverse of np_unpack_bits."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts).sum(axis=-1).astype(np.uint32)


def _majority(bits: np.ndarray) -> np.ndarray:
    """Bitwise majority of [N, 256] -> [256] uint8."""
    return (bits.sum(axis=0) * 2 >= bits.shape[0]).astype(np.uint8)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """[N,256]x[M,256] unpacked-bit Hamming via packed popcount (40x less
    memory than broadcasting the unpacked bits; np>=2.0 bitwise_count)."""
    ap = np_pack_bits(a_bits)
    bp = np_pack_bits(b_bits)
    return np.bitwise_count(ap[:, None, :] ^ bp[None, :, :]).sum(
        -1, dtype=np.int32)


def train_vocabulary(
    descriptors: np.ndarray,  # [N, 8] uint32 packed (int32 bit patterns accepted)
    k: int = 10,
    depth: int = 3,
    levels_up: int = 1,
    seed: int = 0,
    iters: int = 8,
    device="cpu",
) -> Vocabulary:
    """Binary k-medians tree (the DBoW2 create() analogue,
    TemplatedVocabulary.h HKmeansStep). Host-side numpy; the IDF pass
    descends the corpus with `transform` on `device`."""
    r = np.random.default_rng(seed)
    desc_np = np.ascontiguousarray(np.asarray(descriptors)).view(np.uint32)
    bits = np_unpack_bits(desc_np)  # [N, 256]

    children_rows = [np.full(k, -1, np.int64)]  # root placeholder row
    node_descs = [np.zeros(256, np.uint8)]      # root has no centroid
    node_parent = [-1]
    node_depth = [0]

    packed_all = np_pack_bits(bits)

    def _dists_argmin(pdata, cents):
        # chunked over rows: the full [N, k, 8] broadcast is ~50 GB at
        # the 100k-word trainer's 1.7M-descriptor corpus
        pc = np_pack_bits(cents)[None, :, :]
        out = np.empty(len(pdata), np.int64)
        CH = 1 << 17
        for lo in range(0, len(pdata), CH):
            d = np.bitwise_count(
                pdata[lo:lo + CH, None, :] ^ pc).sum(-1, dtype=np.int32)
            out[lo:lo + CH] = d.argmin(1)
        return out

    def split(node_id, idx, d):
        nonlocal children_rows, node_descs
        if d >= depth or len(idx) < k:
            return
        data = bits[idx]
        pdata = packed_all[idx]
        # k-medians init: random distinct samples
        sel = r.choice(len(idx), size=min(k, len(idx)), replace=False)
        cents = data[sel].copy()
        for _ in range(iters):
            assign = _dists_argmin(pdata, cents)
            for c in range(len(cents)):
                members = data[assign == c]
                if len(members):
                    cents[c] = _majority(members)
        assign = _dists_argmin(pdata, cents)
        row = np.full(k, -1, np.int64)
        for c in range(len(cents)):
            members = idx[assign == c]
            if len(members) == 0:
                continue
            child_id = len(node_descs)
            node_descs.append(cents[c])
            node_parent.append(node_id)
            node_depth.append(d + 1)
            children_rows.append(np.full(k, -1, np.int64))
            row[c] = child_id
            split(child_id, members, d + 1)
        children_rows[node_id] = row

    split(0, np.arange(len(bits)), 0)

    n_nodes = len(node_descs)
    children = np.stack(children_rows)[:n_nodes]
    is_leaf = (children < 0).all(axis=1)
    is_leaf[0] = False
    node_word = np.full(n_nodes, -1, np.int64)
    leaves = np.where(is_leaf)[0]
    node_word[leaves] = np.arange(len(leaves))

    # IDF weights from the training corpus (TemplatedVocabulary::setNodeWeights)
    packed = np_pack_bits(np.stack(node_descs))
    voc = _vocabulary(children, packed, node_word, np.ones(len(leaves), np.float32),
                      max(depth - levels_up, 1), depth, k, device)
    # compute IDF by transforming the corpus in chunks
    counts = np.zeros(len(leaves), np.int64)
    CH = 1 << 16
    for lo in range(0, len(desc_np), CH):
        ch = torch.from_numpy(desc_np[lo:lo + CH].view(np.int32)).to(device)
        words, _, _ = transform(voc, ch, torch.ones(len(ch), dtype=torch.bool, device=device))
        w = words.cpu().numpy()
        w = w[w >= 0]
        np.add.at(counts, w, 1)
    n = max(len(bits), 1)
    idf = np.log(n / np.maximum(counts, 1)).astype(np.float32)
    idf[counts == 0] = 0.0
    voc.word_weight = torch.from_numpy(idf).to(device)
    return voc


def save_vocabulary(path: str, voc: Vocabulary):
    """The reference's .npz vocabulary (its dtypes: uint32 centroids)."""
    np.savez_compressed(
        path,
        children=voc.children.cpu().numpy(),
        node_desc=_desc_u32(voc),
        node_word=voc.node_word.cpu().numpy(),
        word_weight=voc.word_weight.cpu().numpy(),
        meta=np.asarray([voc.group_depth, voc.depth, voc.k]),
    )


def save_orb_vocab_text(path: str, voc: Vocabulary):
    """Write the upstream ORBvoc.txt format so vocabularies trained here
    are loadable by the reference implementation. Node ids are emitted in
    BFS order with parent links, matching
    TemplatedVocabulary::saveToTextFile."""
    children = voc.children.cpu().numpy()
    node_desc = _desc_u32(voc).view(np.uint8).reshape(-1, 32)
    node_word = voc.node_word.cpu().numpy()
    weights = np.zeros(children.shape[0], np.float32)
    ww = voc.word_weight.cpu().numpy()
    weights[node_word >= 0] = ww[node_word[node_word >= 0]]
    n = children.shape[0]
    parent_of = np.zeros(n, np.int64)
    rows = np.repeat(np.arange(n), children.shape[1])
    flat = children.reshape(-1)
    ok = flat > 0
    parent_of[flat[ok]] = rows[ok]
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")  # k L TF_IDF L1_NORM
        # DBoW2 convention (TemplatedVocabulary::saveToTextFile): file line
        # i-1 holds node id i; the parent field is the raw node id with
        # root = 0. Our internal row ids use the same numbering, so parents
        # are written unshifted.
        for nid in range(1, n):
            is_leaf = int(node_word[nid] >= 0)
            d = " ".join(str(int(v)) for v in node_desc[nid])
            f.write(f"{parent_of[nid]} {is_leaf} {d} {weights[nid]:.6f}\n")


def _n_tokens(text: str) -> int:
    """Whitespace-separated tokens in `text`."""
    b = np.frombuffer(text.encode(), np.uint8)
    ws = np.isin(b, np.frombuffer(b" \t\n\r\v\f", np.uint8))
    return int(np.count_nonzero(~ws[1:] & ws[:-1])) + int(b.size > 0 and not ws[0])


def _parse_orb_vocab(path: str):
    """Vectorized tokenizer of the ORBvoc.txt format: the header line, then
    the rest as one whitespace-separated number stream of 35 per node
    ('parent is_leaf d0..d31 weight'), as the reference's native parser
    (csrc/slamio.cc) reads it; weights go through f64 to f32 like its
    `%lf` and cast."""
    with open(path) as f:
        header = f.readline().split()
        body = f.read()
    k, L = int(header[0]), int(header[1])
    vals = np.fromstring(body, dtype=np.float64, sep=" ") if body.strip() else np.zeros(0)
    # fromstring stops quietly at a token it cannot read: every token of
    # the body must have become a number, 35 to a node
    if vals.size != _n_tokens(body) or vals.size % 35:
        raise ValueError(f"{path}: malformed vocabulary node line")
    rows = vals.reshape(-1, 35)
    return (
        k, L,
        rows[:, 0].astype(np.int32),
        (rows[:, 1] != 0).astype(np.uint8),
        rows[:, 2:34].astype(np.uint8),
        rows[:, 34].astype(np.float32),
    )


def load_orb_vocab(path: str, levels_up: int = 4, device="cpu") -> Vocabulary:
    """Parse the upstream ORBvoc.txt format (TemplatedVocabulary::
    loadFromTextFile, header:241): first line 'k L s1 s2', then one node
    per line: 'parent is_leaf d0..d31 weight'."""
    k, L, parents, leaf_flags, descs, weights = _parse_orb_vocab(path)

    n = len(parents) + 1  # + root
    # vectorized tree assembly: children of each parent in file order.
    # File parent ids are raw DBoW2 node ids (root = 0, line i-1 <-> id i,
    # TemplatedVocabulary::loadFromTextFile:1389), identical to our row ids.
    par = np.clip(parents, 0, None).astype(np.int64)
    order = np.argsort(par, kind="stable")
    sorted_par = par[order]
    counts = np.bincount(sorted_par, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot_in_parent = np.arange(len(par)) - first[sorted_par]
    children = np.full((n, k), -1, np.int64)
    children[sorted_par, slot_in_parent % k] = order + 1
    node_desc = np.zeros((n, 32), np.uint8)
    node_desc[1:] = descs
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = leaf_flags.astype(bool)
    w = np.zeros(n, np.float32)
    w[1:] = weights
    node_word = np.full(n, -1, np.int64)
    leaves = np.where(is_leaf)[0]
    node_word[leaves] = np.arange(len(leaves))
    return _vocabulary(children, node_desc.view(np.uint32), node_word, w[leaves],
                       max(L - levels_up, 1), L, k, device)


def load_vocabulary(path: str, device="cpu") -> Vocabulary:
    """Read a vocabulary saved by the reference's `save_vocabulary`."""
    z = np.load(path)
    g, d, k = (int(x) for x in z["meta"])
    return _vocabulary(z["children"], z["node_desc"], z["node_word"], z["word_weight"],
                       g, d, k, device)


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
