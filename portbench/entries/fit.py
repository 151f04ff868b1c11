#
# Entry "fit": one caller fits the configuration's estimator over and over,
# in a closed loop, through the port's public API.
#
# Set-up makes the rows (data.py) and builds `frames` DataFrames over the
# same host rows (views, no copy); fit i takes frame i % frames, so with
# two or more frames every fit stages its rows as a Spark fit does (the
# port's fit-input cache holds one dataset).  Every fit takes the
# configuration's parameters and the estimator seed drawn from the run's
# seed (data.estimator_seed).  The warm-up
# fit takes the last frame, so the window's first fit stages too, and the
# mix's `warm_params` over the parameters (fewer iterations of the same
# shapes).  Each fit's model is kept for the check.
#

from __future__ import annotations

from typing import Any, Dict

from .. import data


def make_inputs(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return {"X": data.make(cfg["data"], seed, 1, device)}


def prepare(port, cfg: Dict[str, Any], mix: Dict[str, Any], inputs: Dict[str, Any], seed: int) -> Dict[str, Any]:
    X = inputs["X"]
    state = {
        "port": port,
        "estimator": getattr(port, cfg["estimator"]),
        "params": {**cfg["params"], "seed": data.estimator_seed(seed)},
        "frames": [port.DataFrame.from_numpy(X, num_partitions=cfg["data"]["partitions"])
                   for _ in range(int(mix["frames"]))],
        "n_frames": int(mix["frames"]),
        "rows": int(X.shape[0]),
        "answers": [],
    }
    # the warm-up takes the window's shapes: the mix may cut its iterations
    state["estimator"](**{**state["params"], **mix.get("warm_params", {})}).fit(state["frames"][-1])
    return state


def call(state: Dict[str, Any], i: int):
    """One timed fit: (its record, the model)."""
    model = state["estimator"](**state["params"]).fit(state["frames"][i % len(state["frames"])])
    return {"fits": 1, "rows": state["rows"], "n_iter": int(getattr(model, "n_iter_", 0))}, model


def keep(state: Dict[str, Any], i: int, model) -> None:
    state["answers"].append({"call": i, "model": model})


def window_checks(state: Dict[str, Any], run) -> Dict[str, tuple]:
    """The window's fits each staged their rows: (value, limit) pairs."""
    if state["n_frames"] < 2:
        return {}
    fits = sum(c["fits"] for c in run.calls if c["ok"])
    return {
        "ingest_cache_hits": (run.counters.get("ingest.cache_hit", 0), 0),
        "fits_not_staged": (fits - run.counters.get("ingest.staged", 0), 0),
    }


def answers(state: Dict[str, Any]):
    return state["answers"]


def release(state: Dict[str, Any]) -> None:
    state["frames"].clear()
    state["port"].clear_fit_cache()
