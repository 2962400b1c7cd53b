"""Place-recognition database — the port of
`orb_slam2_comment_tpu/models/keyframe_database.py` (the reference's
KeyFrameDatabase, src/KeyFrameDatabase.cc) over dense BoW matrices, or an
inverted file above SPARSE_W_THRESHOLD words.

Scores are computed on the device; candidate gating and ranking run on the
host in numpy with the reference's very calls (the unstable default
`np.argsort`, `sorted` over a set), so ties break the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_comment_tpu_torch import constants as C
from orb_slam2_comment_tpu_torch.models import map_state as ms
from orb_slam2_comment_tpu_torch.ops import bow
from orb_slam2_comment_tpu_torch.utils.config import resolve_device

# vocabularies beyond this word count use the inverted file (the
# reference's design point; its ORBvoc has ~1M words)
SPARSE_W_THRESHOLD = 16384

_FIELDS = ("bow", "sp_word", "sp_w", "groups", "words", "valid")


def scores_dense(db_bow, db_valid, query):
    """(L1 scores [Kmax], shared-word counts [Kmax]) of a dense query."""
    scores = bow.l1_score(db_bow, query[None, :])
    common = torch.sum((db_bow > 0) & (query[None, :] > 0), dim=1).to(torch.int32)
    return (torch.where(db_valid, scores, torch.full_like(scores, -1.0)),
            torch.where(db_valid, common, torch.zeros_like(common)))


class KeyFrameDatabase:
    """Per-KF BoW vectors (dense or sparse) plus feature word/group tables."""

    def __init__(self, voc: bow.Vocabulary, max_kfs: int, n_feat: int, device=None):
        self.voc = voc
        self.device = resolve_device(device, "KeyFrameDatabase")
        kw = dict(device=self.device)
        self.sparse = voc.n_words > SPARSE_W_THRESHOLD
        if self.sparse:
            self.bow = None
            self.sp_word = torch.full((max_kfs, n_feat), voc.n_words, dtype=torch.int32, **kw)
            self.sp_w = torch.zeros((max_kfs, n_feat), dtype=torch.float32, **kw)
        else:
            self.bow = torch.zeros((max_kfs, voc.n_words), dtype=torch.float32, **kw)
            self.sp_word = self.sp_w = None
        self.groups = torch.full((max_kfs, n_feat), -1, dtype=torch.int32, **kw)
        self.words = torch.full((max_kfs, n_feat), -1, dtype=torch.int32, **kw)
        self.valid = torch.zeros(max_kfs, dtype=torch.bool, **kw)
        self._postings = None

    # -- state carried across packages ----------------------------------------
    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in _FIELDS
                if getattr(self, f) is not None}

    @classmethod
    def from_numpy(cls, voc: bow.Vocabulary, arrays, device=None) -> "KeyFrameDatabase":
        """From the reference database's arrays (`bow` or `sp_word`/`sp_w`,
        `groups`, `words`, `valid`)."""
        groups = np.asarray(arrays["groups"])
        db = cls(voc, groups.shape[0], groups.shape[1], device)
        for f in _FIELDS:
            if f in arrays and getattr(db, f) is not None:
                setattr(db, f, ms.tensor_from_numpy(np.asarray(arrays[f]), db.device))
        return db

    # -- indexing --------------------------------------------------------------
    def add(self, kf_id: int, desc, feat_valid):
        """Transform a keyframe's descriptors and index it
        (KeyFrameDatabase::add)."""
        words, groups, vec = bow.transform(self.voc, desc, feat_valid)
        if not 0 <= kf_id < self.valid.shape[0]:
            # a slot past this database's tier: dropped, as the reference's
            # out-of-bounds scatter drops it (a map loaded from a larger tier)
            return vec
        if self.sparse:
            uw, ww = bow.sparse_bow(self.voc.word_weight, words)
            self.sp_word[kf_id] = uw
            self.sp_w[kf_id] = ww
            self._postings = None
        else:
            self.bow[kf_id] = vec
        self.groups[kf_id] = groups
        self.words[kf_id] = words
        self.valid[kf_id] = True
        return vec

    def erase(self, kf_id: int):
        """Drop a keyframe from the index (KeyFrameDatabase::erase)."""
        self.valid[kf_id] = False
        self._postings = None

    def grow(self, new_max_kfs: int):
        """Widen to a larger keyframe tier (see map_state.grow_map), the new
        rows filled as the constructor fills them; the inverted file is
        rebuilt on its next query."""
        dk = new_max_kfs - self.valid.shape[0]
        if dk <= 0:
            return
        tail = KeyFrameDatabase(self.voc, dk, self.groups.shape[1], self.device)
        for f in _FIELDS:
            if getattr(self, f) is not None:
                setattr(self, f, torch.cat([getattr(self, f), getattr(tail, f)]))
        self._postings = None

    def postings(self):
        """Lazy inverted file, rebuilt after database edits."""
        if self._postings is None:
            self._postings = bow.build_postings(self.sp_word, self.sp_w, self.valid)
        return self._postings

    def scores_device(self, q_words_feat=None, kf_id=None):
        """(scores [Kmax], common [Kmax]) on the device for a stored
        keyframe (kf_id) or per-feature word ids (q_words_feat)."""
        kmax = self.valid.shape[0]
        if self.sparse:
            if kf_id is not None:
                qw, qweight = self.sp_word[kf_id], self.sp_w[kf_id]
            else:
                qw, qweight = bow.sparse_bow(self.voc.word_weight, q_words_feat)
            pw, pk, pv = self.postings()
            scores, common, _ = bow.inverted_file_query(pw, pk, pv, qw, qweight, kmax=kmax)
            return (torch.where(self.valid, scores, torch.full_like(scores, -1.0)),
                    torch.where(self.valid, common, torch.zeros_like(common)))
        query = self.bow[kf_id] if kf_id is not None else bow.bow_vector(self.voc, q_words_feat)
        return scores_dense(self.bow, self.valid, query)

    # -- candidate detection (host) -------------------------------------------
    def _candidates(self, query_vec, exclude_mask, min_score, query_words=None):
        if self.sparse:
            scores, common = self.scores_device(q_words_feat=query_words)
        else:
            scores, common = scores_dense(self.bow, self.valid, query_vec)
        scores = scores.cpu().numpy().copy()
        common = common.cpu().numpy().copy()
        scores[exclude_mask] = -1.0
        common[exclude_mask] = 0
        if common.max() == 0:
            return np.empty(0, np.int64), scores
        min_common = 0.8 * common.max()  # BOW_COMMON_WORD_RATIO
        cand = np.where((common >= min_common) & (scores >= min_score))[0]
        return cand, scores

    @staticmethod
    def _accumulate(cand, scores, W, max_out):
        """Score accumulation over each candidate's top-10 covisibility
        group; keep the best KF of every group above 0.75 * best."""
        cand_set = set(int(c) for c in cand)
        acc = []
        for c in cand:
            cw = W[int(c)]
            group = list(np.argsort(-cw)[: C.BOW_COVIS_GROUP])
            group = [g for g in group if cw[g] > 0] + [int(c)]
            acc_score = sum(scores[g] for g in group if g in cand_set)
            best_in_group = max((g for g in group if g in cand_set), key=lambda g: scores[g])
            acc.append((acc_score, best_in_group))
        best_acc = max(a for a, _ in acc)
        keep = sorted({b for a, b in acc if a > C.BOW_ACC_SCORE_RATIO * best_acc},
                      key=lambda b: -scores[b])
        return keep[:max_out]

    def detect_loop_candidates(self, m: ms.MapState, kf_id: int, min_score: float,
                               max_out: int = 8, W=None, scores_common=None, kf_valid=None):
        """DetectLoopCandidates (src/KeyFrameDatabase.cc:76-197). W and
        scores_common are optional host arrays already read (the all-pairs
        covisibility; (scores, common) against the whole database)."""
        if W is None:
            W = ms.covisibility_matrix(m).cpu().numpy()
        exclude = W[kf_id] >= C.COVIS_MIN_WEIGHT
        exclude[kf_id] = True
        exclude |= ~np.asarray(m.kf_valid.cpu().numpy() if kf_valid is None else kf_valid)
        if scores_common is None:
            cand, scores = self._candidates(
                None if self.sparse else self.bow[kf_id], exclude, min_score,
                query_words=self.words[kf_id] if self.sparse else None)
        else:
            scores = np.array(scores_common[0], copy=True)
            common = np.array(scores_common[1], copy=True)
            scores[exclude] = -1.0
            common[exclude] = 0
            if common.max() == 0:
                cand = np.empty(0, np.int64)
            else:
                cand = np.where((common >= 0.8 * common.max()) & (scores >= min_score))[0]
        if len(cand) == 0:
            return []
        return self._accumulate(cand, scores, W, max_out)

    def detect_reloc_candidates(self, query_vec, m: ms.MapState, max_out: int = 5,
                                valid_mask=None, query_words=None):
        """DetectRelocalizationCandidates (src/KeyFrameDatabase.cc:199-311):
        the loop path's gating without minScore or covisibility exclusion."""
        exclude = np.zeros(self.valid.shape[0], bool)
        if valid_mask is not None:
            exclude |= ~valid_mask.cpu().numpy()
        cand, scores = self._candidates(query_vec, exclude, min_score=-1.0,
                                        query_words=query_words)
        if len(cand) == 0:
            return []
        return self._accumulate(cand, scores, ms.covisibility_matrix(m).cpu().numpy(), max_out)
