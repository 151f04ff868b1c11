#
# Partitioned columnar DataFrame facade.
#
# Counterpart of spark_rapids_ml_tpu/dataframe.py with the same API
# (from_numpy, from_device, from_pandas, partitions, toPandas, count,
# columns) but without pandas on the main path: a partition is an ordered
# {column: numpy array} mapping.  A vector column is a 2-D array — the
# contiguous feature block itself, which ingest and transform read without a
# copy (the role the JAX package's FEATURE_BLOCK_ATTR stash plays beside its
# pandas object column).  pandas is imported only by from_pandas/toPandas.
#
# Feature layouts, as in the JAX package:
#   - "array" / "vector": one column of fixed-length vectors (a 2-D block)
#   - "multi_cols":       D scalar columns
#
# Instances are immutable by convention: transform returns new partitions
# that share the input's arrays.
#

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from .utils import stack_feature_cells


class Partition:
    """One row partition: an ordered {column name: numpy array} mapping whose
    arrays all have the same number of rows."""

    __slots__ = ("_cols", "_n")

    def __init__(self, cols: Mapping[str, np.ndarray]) -> None:
        self._cols: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in cols.items()}
        rows = [len(v) for v in self._cols.values()]
        if rows and any(r != rows[0] for r in rows):
            raise ValueError(f"partition columns differ in length: {rows}")
        self._n = rows[0] if rows else 0

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def with_columns(self, new: Mapping[str, np.ndarray]) -> "Partition":
        """A partition with `new` columns added (or replaced); the existing
        arrays are shared, not copied."""
        return Partition({**self._cols, **new})


class DataFrame:
    """An ordered collection of row partitions with Spark-flavoured methods."""

    def __init__(self, partitions: Sequence[Union[Partition, Mapping[str, np.ndarray]]]):
        parts = [p if isinstance(p, Partition) else Partition(p) for p in partitions]
        if not parts:
            parts = [Partition({})]
        cols = parts[0].columns
        for p in parts[1:]:
            if p.columns != cols:
                raise ValueError("All partitions must share the same columns")
        self._partitions: List[Partition] = parts
        # set by from_device: (X_dev, n_rows, n_cols, featuresCol) — a
        # device-resident feature tensor that fits consume directly
        self._device_features: Optional[tuple] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        X: np.ndarray,
        y: Optional[np.ndarray] = None,
        feature_layout: str = "array",
        featuresCol: Union[str, List[str]] = "features",
        labelCol: str = "label",
        num_partitions: int = 1,
        weight: Optional[np.ndarray] = None,
        weightCol: str = "weight",
    ) -> "DataFrame":
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        if feature_layout in ("array", "vector"):
            col = featuresCol if isinstance(featuresCol, str) else featuresCol[0]

            def features(lo: int, hi: int) -> Dict[str, np.ndarray]:
                # a row slice of a C-contiguous X is itself contiguous: no copy
                return {col: np.ascontiguousarray(X[lo:hi])}

        elif feature_layout == "multi_cols":
            names = (
                featuresCol
                if isinstance(featuresCol, list)
                else [f"{featuresCol}_{i}" for i in range(X.shape[1])]
            )

            def features(lo: int, hi: int) -> Dict[str, np.ndarray]:
                return {name: X[lo:hi, i].copy() for i, name in enumerate(names)}

        else:
            raise ValueError(f"Unknown feature_layout: {feature_layout}")
        bounds = np.linspace(0, X.shape[0], max(1, num_partitions) + 1, dtype=int)
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            cols = features(lo, hi)
            if y is not None:
                cols[labelCol] = np.asarray(y)[lo:hi]
            if weight is not None:
                cols[weightCol] = np.asarray(weight)[lo:hi]
            parts.append(Partition(cols))
        return cls(parts)

    @classmethod
    def from_device(
        cls,
        X: Any,                     # torch.Tensor (N_pad, D) on the device
        y: Optional[Any] = None,    # (n_rows,) numpy or tensor
        weight: Optional[Any] = None,
        featuresCol: str = "features",
        labelCol: str = "label",
        weightCol: str = "weight",
        n_rows: Optional[int] = None,
    ) -> "DataFrame":
        """Facade backed by a device-resident feature tensor: estimator fits
        consume `X` directly, with no host copy and no upload.  Pass
        `n_rows` when trailing rows are padding (they get weight 0).

        Fit input only: transform raises on such a frame."""
        n_valid = int(n_rows if n_rows is not None else X.shape[0])
        # the features column is a placeholder (readers must go through the
        # device tensor); keep it 1 byte/row
        cols: Dict[str, Any] = {featuresCol: np.zeros(n_valid, np.int8)}
        if y is not None:
            cols[labelCol] = _host(y)[:n_valid]
        if weight is not None:
            cols[weightCol] = _host(weight)[:n_valid]
        df = cls([Partition(cols)])
        df._device_features = (X, n_valid, int(X.shape[1]), featuresCol)
        return df

    @classmethod
    def from_pandas(cls, pdf: Any, num_partitions: int = 1) -> "DataFrame":
        """Split a pandas DataFrame into row partitions; object columns of
        equal-length vectors become 2-D feature blocks."""
        cols: Dict[str, np.ndarray] = {}
        for name in pdf.columns:
            values = pdf[name].to_numpy()
            if values.dtype == object:
                values = stack_feature_cells(list(values))
            cols[str(name)] = values
        n = len(pdf)
        bounds = np.linspace(0, n, max(1, num_partitions) + 1, dtype=int)
        return cls(
            [
                Partition({k: v[lo:hi] for k, v in cols.items()})
                for lo, hi in zip(bounds[:-1], bounds[1:])
            ]
        )

    # -- metadata ----------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return self._partitions[0].columns

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    @property
    def partitions(self) -> List[Partition]:
        return self._partitions

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def with_row_id(self, col: str = "unique_id") -> "DataFrame":
        """New partitions with an int64 column of globally unique,
        increasing row ids (0, 1, ... in partition order)."""
        out, offset = [], 0
        for p in self._partitions:
            out.append(p.with_columns({col: np.arange(offset, offset + len(p), dtype=np.int64)}))
            offset += len(p)
        return DataFrame(out)

    # -- execution ---------------------------------------------------------
    def toPandas(self) -> Any:
        """One pandas DataFrame; a 2-D vector column becomes an object column
        of per-row arrays (the Spark array<float> layout)."""
        import pandas as pd

        data: Dict[str, Any] = {}
        for name in self.columns:
            values = np.concatenate([p[name] for p in self._partitions])
            data[name] = list(values) if values.ndim == 2 else values
        return pd.DataFrame(data)

    def __repr__(self) -> str:
        return f"DataFrame[{', '.join(self.columns)}] ({self.num_partitions} partitions)"


def _host(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def as_dataframe(dataset: Any) -> DataFrame:
    """Coerce a supported input (this package's DataFrame or a pandas
    DataFrame) into the facade."""
    if isinstance(dataset, DataFrame):
        return dataset
    if (type(dataset).__module__ or "").startswith("pandas"):
        return DataFrame.from_pandas(dataset)
    raise TypeError(f"Unsupported dataset type: {type(dataset)}")
