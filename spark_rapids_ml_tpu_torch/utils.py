#
# Shared utilities: logging, feature-block materialisation, row chunking.
#
# Counterpart of spark_rapids_ml_tpu/utils.py (this package's own copy).
# Ingest copies each partition's block straight into its rows of one device
# tensor (core._TpuCaller._build_fit_inputs) and every row loop takes a
# ragged last chunk, so the JAX package's host concat (_concat_and_free) and
# row padding (pad_rows) have no caller here.
#

from __future__ import annotations

import logging
import sys
from typing import Any, Iterator, List, Optional, Union

import numpy as np


def get_logger(cls: Union[type, str], level: int = logging.INFO) -> logging.Logger:
    """Per-class stderr logger with a standard format."""
    name = cls if isinstance(cls, str) else f"spark_rapids_ml_tpu_torch.{cls.__name__}"
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def stack_feature_cells(cells: Any, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Sequence of equal-length array-like cells (the Spark array<float>
    layout) -> one contiguous 2-D array."""
    if len(cells) == 0:
        return np.zeros((0, 0), dtype=dtype or np.float64)
    try:
        out = np.stack([np.asarray(c) for c in cells])
    except ValueError as e:
        raise ValueError(
            "feature column cells must all be arrays of the same length"
        ) from e
    return np.ascontiguousarray(out, dtype=dtype)


def materialize_feature_block(
    part: Any,
    input_col: Optional[str],
    input_cols: Optional[List[str]],
    dtype: np.dtype,
    densify_sparse: bool = True,
) -> Any:
    """One partition's (rows, D) feature matrix in `dtype`: the vector
    column's block itself (no copy when it already has that dtype), or the
    scalar columns of `input_cols` stacked side by side.  A sparse CSR block
    stays CSR (in `dtype`) when densify_sparse is False."""
    if input_col is not None:
        block = part[input_col]
        if hasattr(block, "tocsr"):
            if not densify_sparse:
                return block.tocsr().astype(dtype, copy=False)
            return np.ascontiguousarray(block.toarray(), dtype=dtype)
        if block.ndim != 2:
            raise ValueError(
                f"column '{input_col}' holds scalars, not feature vectors; "
                "set featuresCols for the multi_cols layout"
            )
        return np.ascontiguousarray(block, dtype=dtype)
    assert input_cols is not None
    return np.ascontiguousarray(
        np.column_stack([part[c] for c in input_cols]), dtype=dtype
    )


def chunk_iter(n: int, chunk: int) -> Iterator[slice]:
    for start in range(0, n, chunk):
        yield slice(start, min(start + chunk, n))
