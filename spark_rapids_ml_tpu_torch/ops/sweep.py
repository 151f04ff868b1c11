#
# The batched sweep's fold ids.
#
# Counterpart of spark_rapids_ml_tpu/ops/sweep.py's stage_fold_ids.  A
# CrossValidator sweep of m candidates x k folds runs over one staged
# dataset: fold f trains on the rows' weights times (fold_id != f), so no
# fold is staged again.  The fold of a row is random_split_ids, the same
# assignment DataFrame.randomSplit materialises for scoring, so the masked
# folds and the scored folds never disagree.
# The JAX package's dispatch, warm and replicated_aval serve its AOT
# executable cache and have no counterpart, by design: the port compiles
# nothing per shape (ops/precompile.py's header), so the sweep's solvers are
# called directly.
#

from __future__ import annotations

import numpy as np
import torch

from ..dataframe import random_split_ids


def stage_fold_ids(n_rows: int, n_pad: int, n_folds: int, seed: int, device: torch.device) -> torch.Tensor:
    """(n_pad,) int32 fold ids on `device`: row r is in fold
    random_split_ids(n_rows, n_folds, seed)[r]; padded rows carry -1 (their
    weight is already 0)."""
    fid = np.full(n_pad, -1, dtype=np.int32)
    fid[:n_rows] = random_split_ids(n_rows, n_folds, seed)
    return torch.from_numpy(fid).to(device)
