#
# The batched sweep's fold ids.
#
# Counterpart of spark_rapids_ml_tpu/ops/sweep.py's stage_fold_ids.  A
# CrossValidator sweep of m candidates x k folds runs over one staged
# dataset: fold f trains on the rows' weights times (fold_id != f), so no
# fold is staged again.  The fold of a row is random_split_ids, the same
# assignment DataFrame.randomSplit materialises for scoring, so the masked
# folds and the scored folds never disagree.  On a mesh the ids are
# row-sharded as the features are, by global row.
# The JAX package's dispatch, warm and replicated_aval serve its AOT
# executable cache and have no counterpart, by design: the port compiles
# nothing per shape (ops/precompile.py's header), so the sweep's solvers are
# called directly.
#

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..dataframe import random_split_ids
from ..parallel.mesh import Mesh, shard_row_count, shard_rows


def stage_fold_ids(n_rows: int, n_pad: int, n_folds: int, seed: int, device: Any) -> Any:
    """(n_pad,) int32 fold ids: row r is in fold random_split_ids(n_rows,
    n_folds, seed)[r]; padded rows carry -1 (their weight is already 0).
    `device` is one device (one tensor on it) or a Mesh (the ids
    row-sharded over it as mesh.shard_rows shards the features, a list of
    per-shard tensors)."""
    if isinstance(device, Mesh):
        # the mesh's own padding (to its shard count) is fold -1 as well
        n_pad = shard_row_count(n_pad, device.size) * device.size
    fid = np.full(n_pad, -1, dtype=np.int32)
    fid[:n_rows] = random_split_ids(n_rows, n_folds, seed)
    if isinstance(device, Mesh):
        return shard_rows(fid, device)[0]
    return torch.from_numpy(fid).to(device)
