#
# Entry "kneighbors": one caller asks a fitted model for the k nearest
# items of a block of query rows, over and over, in a closed loop, through
# the port's public API.
#
# Set-up makes the items and `frames` query frames of `rows_per_call` rows
# each (in `partitions_per_call` partitions) from the seed (data.py), fits the
# estimator on the items, and warms with a call on each of the first two
# frames (the first stages the items on the device).  Call i takes frame
# i % frames: the model caches a query partition's upload by the identity
# of its host rows, so with two or more frames every call uploads its
# queries.  Of each frame, `check_rows_per_frame` rows drawn from the seed
# are kept from every call for the check.
#

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .. import data


def make_inputs(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    rows = int(mix["rows_per_call"]) * int(mix["frames"])
    return {
        "items": data.make(cfg["data"], seed, 1, device),
        "queries": data.make(cfg["queries"], seed, 3, device, rows=rows),
    }


def sample_rows(mix: Dict[str, Any], seed: int) -> np.ndarray:
    """The rows of each frame that the check judges, drawn from the seed."""
    rows, take = int(mix["rows_per_call"]), int(mix["check_rows_per_frame"])
    return np.sort(np.random.default_rng(data.derive(seed, 4)).choice(rows, min(take, rows), replace=False))


def prepare(port, cfg: Dict[str, Any], mix: Dict[str, Any], inputs: Dict[str, Any], seed: int) -> Dict[str, Any]:
    items, queries = inputs["items"], inputs["queries"]
    rows = int(mix["rows_per_call"])
    item_df = port.DataFrame.from_numpy(items, num_partitions=cfg["data"]["partitions"])
    model = getattr(port, cfg["estimator"])(**cfg["params"]).fit(item_df)
    frames = [port.DataFrame.from_numpy(queries[f * rows : (f + 1) * rows], num_partitions=int(mix["partitions_per_call"]))
              for f in range(int(mix["frames"]))]
    state = {
        "model": model,
        "frames": frames,
        "rows": rows,
        "sample": sample_rows(mix, seed),
        "answers": [],
    }
    for f in range(min(2, len(frames))):
        model.kneighbors(frames[f])
    return state


def call(state: Dict[str, Any], i: int):
    """One timed call: (its record, the answer frame)."""
    _, _, knn = state["model"].kneighbors(state["frames"][i % len(state["frames"])])
    return {"rows": state["rows"]}, knn


def keep(state: Dict[str, Any], i: int, knn) -> None:
    """The sampled rows of call i's answer, kept for the check (after the
    call's time is taken)."""
    parts = knn.partitions
    sizes = np.array([len(p["indices"]) for p in parts])
    if int(sizes.sum()) != state["rows"]:
        raise RuntimeError(f"kneighbors answered {int(sizes.sum())} of {state['rows']} rows")
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows = state["sample"]
    owner = np.searchsorted(starts, rows, side="right") - 1
    k = parts[0]["indices"].shape[1]
    idx = np.empty((len(rows), k), np.int64)
    dist = np.empty((len(rows), k), np.float32)
    for p in np.unique(owner):
        sel = owner == p
        idx[sel] = parts[p]["indices"][rows[sel] - starts[p]]
        dist[sel] = parts[p]["distances"][rows[sel] - starts[p]]
    state["answers"].append({"call": i, "frame": i % len(state["frames"]), "indices": idx, "distances": dist})


def window_checks(state: Dict[str, Any], run) -> Dict[str, tuple]:
    return {}


def answers(state: Dict[str, Any]):
    return state["answers"]


def release(state: Dict[str, Any]) -> None:
    state["frames"].clear()
    state["model"] = None
