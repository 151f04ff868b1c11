#
# Mergeable streaming-fit state (srml-stream).
#
# Counterpart of spark_rapids_ml_tpu/stream/state.py (this package's own
# copy, numpy only).  Every streaming engine's accumulated knowledge is one
# StreamState: a kind tag and named float64 host arrays (counts, weighted
# sums, Gram and scatter moments, count-weighted coefficient sums) whose
# merge is field-wise addition, associative and commutative.  A few fields
# are identity anchors rather than statistics (the kmeans init centers, the
# logreg class set): those merge under the "equal" reducer, both sides
# carrying the same bits, since two streams that disagree on their anchor
# are a user error, not algebra.
#
# The wire form is the JAX package's byte for byte: the schema tag
# srml-stream/v1, the kinds, and to_dict's sorted field layout, so a state
# dict written by one package loads in the other and the two merge.
#
# float64 on the host: chunk partials come from the card in the fit dtype
# (exact float32 sums on the integer data families), and the float64 fold
# keeps each partial exactly, so merge order cannot change the finalized
# model on those data.  The engines fold in place (add_), with the same
# float64 additions as the JAX package's out-of-place fold.
#

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

WIRE_SCHEMA = "srml-stream/v1"

# per-kind identity anchors; every other field merges by addition
_EQUAL_FIELDS = {
    "kmeans": ("init_centers",),
    "logreg": ("classes",),
}

# the known kinds, one per streaming engine; decoding rejects the others
KINDS = ("kmeans", "pca", "linreg", "logreg")


class StreamState:
    """One engine's mergeable accumulator: a kind tag and named float64
    arrays.  merge() is pure (a new state); engines hold a private copy and
    fold chunk partials in place with add_()."""

    __slots__ = ("kind", "arrays")

    def __init__(self, kind: str, arrays: Dict[str, Any]):
        if kind not in KINDS:
            raise ValueError(f"unknown stream state kind {kind!r}; one of {KINDS}")
        self.kind = str(kind)
        self.arrays = {name: np.asarray(a, np.float64) for name, a in arrays.items()}

    def _check_compatible(self, other: "StreamState") -> None:
        if self.kind != other.kind:
            raise ValueError(f"cannot merge stream states of kind {self.kind!r} and {other.kind!r}")
        if set(self.arrays) != set(other.arrays):
            raise ValueError(f"stream state field mismatch: {sorted(self.arrays)} vs {sorted(other.arrays)}")
        for name, a in self.arrays.items():
            b = other.arrays[name]
            if a.shape != b.shape:
                raise ValueError(
                    f"stream state field {name!r} shape mismatch: {a.shape} vs {b.shape} (different k/D streams?)"
                )

    def add_(self, partials: Dict[str, Any]) -> "StreamState":
        """Fold one chunk's partials into this state in place (additive
        fields only)."""
        equal = _EQUAL_FIELDS.get(self.kind, ())
        for name, v in partials.items():
            if name in equal:
                raise ValueError(f"field {name!r} is an identity anchor, not additive")
            # float32 partials widen element by element inside the ufunc:
            # the same float64 sums as a + float64(v), with no temporary
            np.add(self.arrays[name], np.asarray(v), out=self.arrays[name])
        return self

    def merge(self, other: "StreamState") -> "StreamState":
        """Associative, commutative combine of two streams' states: additive
        fields sum; identity anchors must agree bit for bit."""
        self._check_compatible(other)
        equal = _EQUAL_FIELDS.get(self.kind, ())
        out = {}
        for name, a in self.arrays.items():
            b = other.arrays[name]
            if name in equal:
                if not np.array_equal(a, b):
                    raise ValueError(
                        f"cannot merge {self.kind} streams with different {name!r} anchors (streams must share "
                        "their seed / init)"
                    )
                out[name] = a.copy()
            else:
                out[name] = a + b
        return StreamState(self.kind, out)

    def copy(self) -> "StreamState":
        return StreamState(self.kind, {n: a.copy() for n, a in self.arrays.items()})

    # -- wire format (the control plane's allGather payload) ---------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": WIRE_SCHEMA,
            "kind": self.kind,
            "arrays": {
                name: {"shape": list(a.shape), "data": a.ravel().tolist()}
                for name, a in sorted(self.arrays.items())
            },
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StreamState":
        if d.get("schema") != WIRE_SCHEMA:
            raise ValueError(f"unknown stream state schema {d.get('schema')!r}; expected {WIRE_SCHEMA}")
        arrays = {
            name: np.asarray(spec["data"], np.float64).reshape(spec["shape"]) for name, spec in d["arrays"].items()
        }
        return cls(d["kind"], arrays)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, StreamState)
            and self.kind == other.kind
            and set(self.arrays) == set(other.arrays)
            and all(np.array_equal(a, other.arrays[n]) for n, a in self.arrays.items())
        )

    def __repr__(self) -> str:
        fields = ", ".join(f"{n}{list(a.shape)}" for n, a in sorted(self.arrays.items()))
        return f"StreamState({self.kind}: {fields})"


def merge_all(states: List[StreamState]) -> StreamState:
    """Left fold of merge() over a non-empty list, in rank order (the fold
    every rank applies to an allGathered list)."""
    if not states:
        raise ValueError("merge_all of zero states")
    out = states[0]
    for s in states[1:]:
        out = out.merge(s)
    return out


def allgather_merge(control_plane: Any, state: StreamState) -> StreamState:
    """Reduce this rank's state with every peer's through a control plane:
    allGather the JSON wire form (rank-indexed) and fold it in rank order,
    so every rank computes the same merged state.  `control_plane` is
    anything with allGather(str) -> [str, ...] in rank order."""
    msgs = control_plane.allGather(json.dumps(state.to_dict()))
    return merge_all([StreamState.from_dict(json.loads(m)) for m in msgs])
