"""Loop-closure retrieval: brute-force descriptor-set scoring.

PyTorch counterpart of `vins_tpu/loop/retrieval.py`, the replacement for
DBoW2 (pose_graph/src/ThirdParty/DBoW): every stored keyframe is scored by
the share of the query's descriptors whose best match in it lies below the
Hamming threshold, one ±1 matmul over the occupied slots.  The store is an
int8 tensor on the device, [capacity, points, 256]; at capacity it halves
(every other slot kept, compacted to the front) and the slot → keyframe
index map follows.  The JAX package pads the scored prefix to a power of
two of 32-slot chunks to bound its compiles; the port scores exactly the
occupied slots, which gives the same scores and order (the slots past them
score −1 in both).

Scores rank as DBoW2's L1 score does in detectLoop (pose_graph.cpp:304-386),
with the acceptance re-tuned to this score's scale (`pick_loop_candidate`).
"""
from __future__ import annotations

import numpy as np
import torch

from .brief import BRIEF_BITS


def score_slots(query: torch.Tensor, qvalid: torch.Tensor, db: torch.Tensor,
                dbvalid: torch.Tensor, match_thresh: float) -> torch.Tensor:
    """query [P,256] ±1, db [K,P',256] int8 ±1 → scores [K]: the share of
    valid query descriptors whose nearest valid descriptor of slot k is
    closer than `match_thresh` bits."""
    nq = torch.clamp(torch.sum(qvalid).to(torch.float32), min=1.0)
    dots = torch.einsum("pb,kqb->pkq", query.to(torch.float32), db.to(torch.float32))
    dist = torch.where(dbvalid[None], 0.5 * (BRIEF_BITS - dots), torch.inf)
    best = torch.amin(dist, dim=2)  # [P,K]
    hits = (best < match_thresh) & qvalid[:, None]
    return torch.sum(hits, dim=0) / nq


class KeyframeDB:
    """Fixed-capacity descriptor store on the device + host metadata."""

    def __init__(self, capacity: int = 2048, pts_per_kf: int = 256,
                 match_thresh: float = 60.0, device="cuda"):
        self.cap = capacity
        self.P = pts_per_kf
        self.match_thresh = match_thresh
        self.device = torch.device(device)
        self.desc = torch.zeros((capacity, pts_per_kf, BRIEF_BITS), dtype=torch.int8,
                                device=self.device)
        self.valid = torch.zeros((capacity, pts_per_kf), dtype=torch.bool, device=self.device)
        # slot → external keyframe index: eviction compacts the slots, so
        # slot and keyframe index part after the first halving
        self.kf_index = np.full(capacity, -1, np.int64)
        self.count = 0
        self.n_evicted = 0

    def add(self, desc: torch.Tensor, valid: torch.Tensor, kf_index: int | None = None) -> int:
        """Store one keyframe's descriptors under external id `kf_index`
        (default: the running count); returns its slot.  At capacity every
        other stored keyframe is dropped first (the reference caps its map
        at ~2000 keyframes instead, tro p.11)."""
        if self.count >= self.cap:
            n = self.cap // 2
            self.n_evicted += self.cap - n
            self.desc[:n] = self.desc[0::2].clone()
            self.valid[:n] = self.valid[0::2].clone()
            self.valid[n:] = False
            self.kf_index[:n] = self.kf_index[0::2].copy()
            self.kf_index[n:] = -1
            self.count = n
        i = self.count
        self.desc[i] = desc.to(torch.int8)
        self.valid[i] = valid
        self.kf_index[i] = self.count if kf_index is None else int(kf_index)
        self.count += 1
        return i

    def query(self, desc: torch.Tensor, valid: torch.Tensor, exclude_last: int = 50,
              top_k: int = 4, newest_kf: int | None = None):
        """detectLoop's query (pose_graph.cpp:304-386): score the stored
        keyframes except those within `exclude_last` keyframe indices of
        `newest_kf` (default: the newest stored id); returns (keyframe
        indices, scores) of the top-k, one host fetch."""
        if self.count == 0:
            return np.zeros(0, np.int64), np.zeros(0)
        n = self.count
        scores = np.full(self.cap, -1.0, np.float32)
        scores[:n] = score_slots(desc, valid, self.desc[:n], self.valid[:n],
                                 self.match_thresh).cpu().numpy()
        ids = self.kf_index
        if newest_kf is None:
            newest_kf = int(ids[:n].max())
        scores[:n][ids[:n] > newest_kf - exclude_last] = -1.0
        order = np.argsort(-scores)[:top_k]
        return ids[order], scores[order]


def pick_loop_candidate(idx: np.ndarray, scores: np.ndarray, accept: float = 0.35,
                        second: float = 0.22, strong: float = 0.6):
    """The reference's acceptance (pose_graph.cpp:348-382): best above
    `accept` and another candidate above `second`, or a single match of at
    least `strong`; returns the earliest qualifying keyframe index (the
    oldest loop), or None."""
    if len(scores) == 0 or scores[0] < accept:
        return None
    others = scores[1:]
    if scores[0] < strong and not (others > second).any():
        return None
    qual = [int(i) for i, s in zip(idx, scores) if s > second]
    if scores[0] >= strong:
        qual.append(int(idx[0]))
    return min(qual) if qual else None
