#
# Partition metadata of a fit.
#
# Counterpart of spark_rapids_ml_tpu/parallel/partition.py (this package's
# own copy).  Single-controller fits build it locally (one rank owns every
# partition); multi-process fits (parallel/runner.py) use `gather`, which
# exchanges every rank's partition sizes over the job's control plane.
#

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class PartitionDescriptor:
    """m: total rows, n: cols, rank: this worker, parts_rank_size: flat list of
    (rank, size) for every partition in rank order."""

    m: int
    n: int
    rank: int
    parts_rank_size: List[tuple] = field(default_factory=list)
    extras: List[dict] = field(default_factory=list)

    @classmethod
    def build(cls, partition_rows: List[int], total_cols: int, rank: int = 0) -> "PartitionDescriptor":
        """Single-controller constructor: each partition is tagged with its
        own index."""
        parts = [(r, size) for r, size in enumerate(partition_rows)]
        return cls(
            m=sum(partition_rows), n=total_cols, rank=rank, parts_rank_size=parts
        )

    @classmethod
    def gather(
        cls,
        partition_rows: List[int],
        n_cols: int,
        rank: int,
        nranks: int,
        control_plane: Any,
        extra: Optional[dict] = None,
    ) -> "PartitionDescriptor":
        """Multi-process constructor: allGather every rank's partition sizes
        and column count over the control plane.  A rank with no data
        reports n_cols=0; the global column count is the consensus of the
        data-bearing ranks (disagreement raises).  `extra` is a JSON-safe
        dict gathered alongside, per rank in `.extras`."""
        msg = json.dumps(
            {
                "rank": rank,
                "rows": partition_rows,
                "n_cols": n_cols,
                "extra": extra or {},
            }
        )
        gathered = sorted(
            (json.loads(m) for m in control_plane.allGather(msg)),
            key=lambda g: g["rank"],
        )
        if [g["rank"] for g in gathered] != list(range(nranks)):
            raise RuntimeError(
                f"partition allGather returned ranks "
                f"{[g['rank'] for g in gathered]}, expected 0..{nranks - 1}"
            )
        widths = {g["n_cols"] for g in gathered if g["n_cols"] > 0}
        if len(widths) > 1:
            raise ValueError(f"ranks disagree on feature width: {sorted(widths)}")
        parts = [(g["rank"], size) for g in gathered for size in g["rows"]]
        return cls(
            m=sum(s for _, s in parts),
            n=widths.pop() if widths else 0,
            rank=rank,
            parts_rank_size=parts,
            extras=[g.get("extra", {}) for g in gathered],
        )

    def rank_rows(self, rank: int) -> int:
        """Total rows held by `rank` across its partitions."""
        return sum(s for r, s in self.parts_rank_size if r == rank)
