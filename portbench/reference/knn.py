#
# Plain reference of exact k-nearest-neighbour search (euclidean), in
# PyTorch.
#
# The truth: float64 squared distances of the sampled query rows to every
# item, from the run's host rows, in blocks of items; the exact k smallest
# distances of each row and the distance of every item.  Items are the
# rows of the item frame, whose ids are their row numbers (the port's
# generated id column).  An answer row is judged by two numbers:
#   dist_rel_err  the widest gap, over ranks, between the distance it
#                 returns at a rank and the true distance at that rank,
#                 relative to the true one;
#   rows_off_band rows whose returned ids are not a true k nearest: an id
#                 twice, an id whose true distance lies beyond the k-th true
#                 distance by more than tie_rtol, or an item nearer than the
#                 k-th by more than tie_rtol left out (items within tie_rtol
#                 of the k-th distance are near-ties either side may take).
# The control is the same search as the port's answer in float32 with
# TF32 products (a lower precision than the configuration's float32).
#

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .kmeans import matmul_precision

ITEM_BLOCK = 50_000


class Truth:
    """float64 distances (S, n) of S query rows to every item, and the true
    k smallest of each row."""

    def __init__(self, items: np.ndarray, queries: np.ndarray, k: int, device):
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(device).double()
        n = items.shape[0]
        self.d = torch.empty((q.shape[0], n), dtype=torch.float64, device=device)
        qn = (q * q).sum(dim=1)
        for lo in range(0, n, ITEM_BLOCK):
            x = torch.from_numpy(items[lo : lo + ITEM_BLOCK]).to(device).double()
            self.d[:, lo : lo + ITEM_BLOCK] = (qn[:, None] - 2.0 * (q @ x.T)) + (x * x).sum(dim=1)[None, :]
        self.d.clamp_(min=0.0).sqrt_()
        self.top = torch.topk(self.d, k, dim=1, largest=False, sorted=True).values

    def judge(self, rows: torch.Tensor, ids: np.ndarray, dist: np.ndarray, tie_rtol: float) -> Dict[str, float]:
        """The numbers of the answer (ids, dist) (len(rows), k) of the truth's
        rows `rows`."""
        dev = self.d.device
        d = self.d[rows]
        top = self.top[rows]
        kth = top[:, -1:]
        got_d = torch.from_numpy(np.asarray(dist, np.float64)).to(dev)
        dist_err = float(((got_d - top).abs() / top.clamp_min(1e-300)).max())
        got_ids = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
        in_range = (got_ids >= 0) & (got_ids < d.shape[1])
        got_true = d.gather(1, got_ids.clamp(0, d.shape[1] - 1))
        dup = (torch.sort(got_ids, dim=1).values.diff(dim=1) == 0).any(dim=1)
        beyond = (got_true > kth * (1 + tie_rtol)).any(dim=1) | ~in_range.all(dim=1)
        below = (d < kth * (1 - tie_rtol)).sum(dim=1)
        got_below = (got_true < kth * (1 - tie_rtol)).sum(dim=1)
        off = dup | beyond | (below != got_below)
        return {"dist_rel_err": dist_err, "rows_off_band": float(off.sum())}


def search(items: np.ndarray, queries: np.ndarray, k: int, device, tf32: bool) -> Dict[str, np.ndarray]:
    """The control's answer: exact search in float32, TF32 products when
    tf32 (the port's answer format: ids ascending by distance)."""
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    qn = (q * q).sum(dim=1)
    best_d, best_i = [], []
    with matmul_precision(tf32):
        for lo in range(0, items.shape[0], ITEM_BLOCK):
            x = torch.from_numpy(items[lo : lo + ITEM_BLOCK]).to(device)
            d2 = (qn[:, None] - 2.0 * (q @ x.T)) + (x * x).sum(dim=1)[None, :]
            v, i = torch.topk(d2, min(k, x.shape[0]), dim=1, largest=False)
            best_d.append(v)
            best_i.append(i + lo)
    v, pick = torch.topk(torch.cat(best_d, dim=1), k, dim=1, largest=False, sorted=True)
    ids = torch.cat(best_i, dim=1).gather(1, pick)
    return {"indices": ids.cpu().numpy(), "distances": v.clamp_min(0.0).sqrt().float().cpu().numpy()}


def check(cfg: Dict[str, Any], mix: Dict[str, Any], inputs: Dict[str, Any], answers: List[Dict[str, Any]],
          seed: int, device) -> Dict[str, tuple]:
    """Every call's sampled rows against the truth: each number's worst
    reading with its limit."""
    if not answers:
        return {"answers_missing": (1, 0)}
    from ..entries.kneighbors import sample_rows

    sample = sample_rows(mix, seed)
    rows_per_call = int(mix["rows_per_call"])
    frames = sorted({a["frame"] for a in answers})
    queries = np.concatenate([inputs["queries"][f * rows_per_call + sample] for f in frames])
    truth = Truth(inputs["items"], queries, int(cfg["params"]["k"]), device)
    base = {f: j * len(sample) for j, f in enumerate(frames)}
    limits = cfg["limits"]
    worst: Dict[str, float] = {}
    judged = set()
    for a in answers:
        # a frame's calls that answered alike are judged once
        key = (a["frame"], a["indices"].tobytes(), a["distances"].tobytes())
        if key in judged:
            continue
        judged.add(key)
        rows = torch.arange(base[a["frame"]], base[a["frame"]] + len(sample), device=truth.d.device)
        for name, value in truth.judge(rows, a["indices"], a["distances"], cfg["tie_rtol"]).items():
            worst[name] = max(worst.get(name, 0.0), value)
    return {name: (value, limits[name]) for name, value in worst.items()}
