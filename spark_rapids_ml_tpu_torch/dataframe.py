#
# Partitioned columnar DataFrame facade.
#
# Counterpart of spark_rapids_ml_tpu/dataframe.py with the same API (the
# constructors from_numpy, from_device, from_pandas and from_arrow;
# columns, dtypes, schema_of, num_partitions, partitions, count, isEmpty;
# repartition, coalesce; select, drop, withColumnRenamed, filter, union,
# with_row_id, randomSplit; mapInPandas, toPandas, to_arrow, collect,
# first, cache, unpersist; and Row) but without pandas on the main path: a
# partition is an ordered {column: numpy array} mapping.  A vector column is a 2-D array — the
# contiguous feature block itself, which ingest and transform read without a
# copy (the role the JAX package's FEATURE_BLOCK_ATTR stash plays beside its
# pandas object column), or a scipy CSR block when from_numpy is given a
# sparse matrix (kept sparse, as the JAX package's from_numpy keeps it).
# pandas is imported only by from_pandas, toPandas, to_arrow and
# mapInPandas.  dtypes reads a column as its pandas form would: a vector or
# text column is "object".  A filter predicate gets the partition and
# returns a boolean row mask, so p["label"] > 0 reads in both packages.  as_dataframe also takes
# a pyarrow Table (from_arrow; pyarrow imported only when one arrives) and a
# live pyspark DataFrame, collected to the driver (spark/adapter.
# spark_to_facade: the SRML_SPARK_COLLECT=1 route).  partition_of reads one
# mapInPandas batch (a pandas frame) as a Partition.
#
# Feature layouts, as in the JAX package:
#   - "array" / "vector": one column of fixed-length vectors (a 2-D block)
#   - "multi_cols":       D scalar columns
#
# Instances are immutable by convention: transform returns new partitions
# that share the input's arrays.
#
# randomSplit assigns rows to splits by random_split_ids, the JAX package's
# seeded permutation (numpy's default_rng(seed).permutation, cut at the
# weights' fractions), so fold membership equals the JAX package's row for
# row; it gathers each split's rows straight from the partitions' arrays,
# a thread a partition (one copy of the rows, no pandas round trip), and
# cuts them into as many partitions as the frame has.  stream_chunk_ids
# cuts the same permutation into the chunks of a streamed replay.
#

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from .utils import stack_feature_cells


def _is_sparse(v: Any) -> bool:
    return hasattr(v, "tocsr") and hasattr(v, "toarray")


class Partition:
    """One row partition: an ordered {column name: numpy array} mapping whose
    arrays all have the same number of rows.  A vector column may also be a
    scipy CSR block (DataFrame.from_numpy of a sparse matrix)."""

    __slots__ = ("_cols", "_n")

    def __init__(self, cols: Mapping[str, Any]) -> None:
        self._cols: Dict[str, Any] = {k: v if _is_sparse(v) else np.asarray(v) for k, v in cols.items()}
        rows = [v.shape[0] for v in self._cols.values()]
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


class Row:
    """Attribute and item access to one row (a pyspark.sql.Row stand-in)."""

    __slots__ = ("_data",)

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, key: Union[str, int]) -> Any:
        if isinstance(key, int):
            return list(self._data.values())[key]
        return self._data[key]

    def asDict(self) -> Dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._data.items())
        return f"Row({inner})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Row) and self._data == other._data


def _dtype_name(values: Any) -> str:
    """A column's dtype as its pandas column would name it."""
    if _is_sparse(values) or values.ndim != 1 or values.dtype.kind in "OSU":
        return "object"
    return str(values.dtype)


def _row_values(values: Any) -> List[Any]:
    """A column's cells as pandas' to_dict("records") gives them: Python
    scalars, or one array a row of a vector column."""
    if _is_sparse(values):
        values = values.toarray()
    return list(values) if values.ndim != 1 else values.tolist()


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
        X: Any,
        y: Optional[np.ndarray] = None,
        feature_layout: str = "array",
        featuresCol: Union[str, List[str]] = "features",
        labelCol: str = "label",
        num_partitions: int = 1,
        weight: Optional[np.ndarray] = None,
        weightCol: str = "weight",
    ) -> "DataFrame":
        sparse = _is_sparse(X)
        X = X.tocsr() if sparse else np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        if feature_layout in ("array", "vector"):
            col = featuresCol if isinstance(featuresCol, str) else featuresCol[0]

            def features(lo: int, hi: int) -> Dict[str, Any]:
                # a row slice of a C-contiguous X is itself contiguous: no
                # copy.  A sparse X stays sparse: each partition's vector
                # column is a CSR block, which the GLMs fit and transform
                # through the ELL layout and the other estimators densify.
                return {col: X[lo:hi] if sparse else np.ascontiguousarray(X[lo:hi])}

        elif sparse:
            raise ValueError("sparse X requires feature_layout='array'/'vector'")
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
        cols = _pandas_columns(pdf)
        n = len(pdf)
        bounds = np.linspace(0, n, max(1, num_partitions) + 1, dtype=int)
        return cls(
            [
                Partition({k: v[lo:hi] for k, v in cols.items()})
                for lo, hi in zip(bounds[:-1], bounds[1:])
            ]
        )

    @classmethod
    def from_arrow(cls, table: Any, num_partitions: int = 1) -> "DataFrame":
        """A pyarrow Table, through its pandas form (as the JAX package)."""
        return cls.from_pandas(table.to_pandas(), num_partitions)

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

    @property
    def dtypes(self) -> List[tuple]:
        p = self._partitions[0]
        return [(c, _dtype_name(p[c])) for c in p.columns]

    def schema_of(self, col: str) -> str:
        return _dtype_name(self._partitions[0][col])

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def isEmpty(self) -> bool:
        return self.count() == 0

    # -- layout ------------------------------------------------------------
    def _concat(self) -> Dict[str, Any]:
        """Every column over all partitions, in row order."""
        out = {}
        for name in self.columns:
            blocks = [p[name] for p in self._partitions]
            if _is_sparse(blocks[0]):
                import scipy.sparse as sp

                out[name] = sp.vstack(blocks, format="csr")
            else:
                out[name] = np.concatenate(blocks)
        return out

    def repartition(self, n: int) -> "DataFrame":
        """The rows cut into max(1, n) partitions as np.array_split cuts
        them (one partition when there are none)."""
        cols = self._concat()
        rows = self.count()
        if rows == 0:
            return DataFrame([Partition(cols)])
        k = max(1, int(n))
        bounds = np.cumsum([0] + [rows // k + (j < rows % k) for j in range(k)])
        return DataFrame([
            Partition({name: v[lo:hi] for name, v in cols.items()})
            for lo, hi in zip(bounds[:-1], bounds[1:])
        ])

    def coalesce(self, n: int) -> "DataFrame":
        if n >= len(self._partitions):
            return self
        return self.repartition(n)

    # -- relational ops ----------------------------------------------------
    def select(self, *cols: str) -> "DataFrame":
        names = list(cols[0]) if len(cols) == 1 and isinstance(cols[0], (list, tuple)) else list(cols)
        return DataFrame([Partition({c: p[c] for c in names}) for p in self._partitions])

    def drop(self, *cols: str) -> "DataFrame":
        return DataFrame([Partition({c: p[c] for c in p.columns if c not in cols}) for p in self._partitions])

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame([Partition({new if c == old else c: p[c] for c in p.columns}) for p in self._partitions])

    def filter(self, predicate: Any) -> "DataFrame":
        """The rows where predicate(partition), a boolean row mask, holds."""
        out = []
        for p in self._partitions:
            keep = np.flatnonzero(np.asarray(predicate(p), dtype=bool))
            out.append(Partition({c: p[c][keep] for c in p.columns}))
        return DataFrame(out)

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._partitions + other._partitions)

    def randomSplit(self, weights: List[float], seed: int = 0) -> List["DataFrame"]:
        """Split the rows by random_split_ids(count, weights, seed): row r of
        the concatenated frame lands in split random_split_ids(...)[r].  Each
        split keeps the rows' order and is cut into as many partitions as
        this frame has, as np.array_split cuts."""
        if self._device_features is not None:
            raise NotImplementedError("randomSplit of a DataFrame.from_device frame: split the host rows")
        split_id = random_split_ids(self.count(), weights, seed)
        offsets = np.cumsum([0] + [len(p) for p in self._partitions])
        nparts = max(1, len(self._partitions))
        out = []
        for i in range(len(weights)):
            # the split's rows of each partition, in row order
            local = [
                np.flatnonzero(split_id[lo:hi] == i) for lo, hi in zip(offsets[:-1], offsets[1:])
            ]
            n = sum(len(ix) for ix in local)
            cols = {name: _gather_rows([p[name] for p in self._partitions], local) for name in self.columns}
            # np.array_split's cut, as the JAX package partitions a split
            sizes = [n // nparts + (j < n % nparts) for j in range(nparts)]
            bounds = np.cumsum([0] + sizes)
            out.append(DataFrame([
                Partition({name: v[lo:hi] for name, v in cols.items()})
                for lo, hi in zip(bounds[:-1], bounds[1:])
            ]))
        return out

    def unpersist(self) -> "DataFrame":
        """Release the device-resident fit-input cache (core.clear_fit_cache),
        the state a Spark unpersist would drop."""
        from .core import clear_fit_cache

        clear_fit_cache()
        return self

    def with_row_id(self, col: str = "unique_id") -> "DataFrame":
        """New partitions with an int64 column of globally unique,
        increasing row ids (0, 1, ... in partition order)."""
        out, offset = [], 0
        for p in self._partitions:
            out.append(p.with_columns({col: np.arange(offset, offset + len(p), dtype=np.int64)}))
            offset += len(p)
        return DataFrame(out)

    # -- execution ---------------------------------------------------------
    def mapInPandas(self, fn: Any, schema: Any = None) -> "DataFrame":
        """pyspark's mapInPandas contract, a partition at a time: fn takes
        an iterator of pandas batches and yields pandas batches, which
        become one partition.  A partition with no output batch gets the
        first non-empty one's columns and no rows."""
        import pandas as pd

        out: List[Optional[Partition]] = []
        for p in self._partitions:
            frames = list(fn(iter([DataFrame([p]).toPandas()])))
            out.append(partition_of(pd.concat(frames, ignore_index=True)) if frames else None)
        template = next((o for o in out if o is not None), Partition({}))
        return DataFrame([o if o is not None else Partition({c: template[c][:0] for c in template.columns})
                          for o in out])

    def to_arrow(self) -> Any:
        import pyarrow as pa

        return pa.Table.from_pandas(self.toPandas(), preserve_index=False)

    def collect(self) -> List[Row]:
        out = []
        for p in self._partitions:
            cells = [_row_values(p[c]) for c in p.columns]
            out.extend(Row(dict(zip(p.columns, row))) for row in zip(*cells))
        return out

    def first(self) -> Optional[Row]:
        for p in self._partitions:
            if len(p):
                return Row({c: p[c][0:1].toarray()[0] if _is_sparse(p[c]) else p[c][0] for c in p.columns})
        return None

    def cache(self) -> "DataFrame":
        return self

    def toPandas(self) -> Any:
        """One pandas DataFrame; a 2-D vector column becomes an object column
        of per-row arrays (the Spark array<float> layout)."""
        import pandas as pd

        data: Dict[str, Any] = {}
        for name in self.columns:
            blocks = [p[name] for p in self._partitions]
            if _is_sparse(blocks[0]):
                blocks = [b.toarray() for b in blocks]
            values = np.concatenate(blocks)
            data[name] = list(values) if values.ndim == 2 else values
        return pd.DataFrame(data)

    def __repr__(self) -> str:
        return f"DataFrame[{', '.join(self.columns)}] ({self.num_partitions} partitions)"


def _gather_rows(blocks: List[Any], local: List[np.ndarray]) -> Any:
    """The rows `local[j]` of each block j, stacked in block order: one
    copy into a new array (a CSR block stays CSR).  The blocks are gathered
    on a thread each: numpy's copy loops run without the GIL, and one
    thread's copy, the first touch of the new pages included, was most of
    a cross validation's time at 1M x 3000 rows."""
    if _is_sparse(blocks[0]):
        import scipy.sparse as sp

        return sp.vstack([b.tocsr()[ix] for b, ix in zip(blocks, local)], format="csr")
    first = np.asarray(blocks[0])
    out = np.empty((sum(len(ix) for ix in local),) + first.shape[1:], dtype=first.dtype)
    at = np.cumsum([0] + [len(ix) for ix in local])

    def gather(j: int) -> None:
        np.take(np.asarray(blocks[j]), local[j], axis=0, out=out[at[j] : at[j + 1]])

    if len(blocks) == 1 or out.nbytes < (64 << 20):
        for j in range(len(blocks)):
            gather(j)
    else:
        with ThreadPoolExecutor(min(len(blocks), os.cpu_count() or 1)) as pool:
            list(pool.map(gather, range(len(blocks))))
    return out


def random_split_ids(n: int, weights: Union[int, List[float]], seed: int = 0) -> np.ndarray:
    """Per-row split assignment of randomSplit(weights, seed): row r of the
    concatenated frame lands in split random_split_ids(...)[r].  The one
    definition of the split, shared by DataFrame.randomSplit and the batched
    sweep's fold ids (ops/sweep.stage_fold_ids), so the two never disagree
    on fold membership.  `weights` may be an int k, k equal folds.  The JAX
    package's function, copied."""
    if isinstance(weights, int):
        weights = [1.0] * weights
    total = float(sum(weights))
    bounds = np.cumsum([w / total for w in weights])[:-1]
    cut = (bounds * n).astype(int)
    return _permutation_split(n, cut, seed)


def _permutation_split(n: int, cuts: np.ndarray, seed: int) -> np.ndarray:
    """Permute the rows with default_rng(seed), cut the permutation at
    `cuts` and label each row with its segment."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    split_id = np.empty(n, dtype=np.int32)
    for i, g in enumerate(np.split(perm, cuts)):
        split_id[g] = i
    return split_id


def stream_chunk_ids(n: int, chunk_rows: int, seed: int = 0) -> np.ndarray:
    """Per-row chunk of a streamed replay of an n-row dataset: row r belongs
    to chunk stream_chunk_ids(...)[r], chunks 0 .. ceil(n / chunk_rows) - 1
    of exactly chunk_rows rows but a short tail (exact integer cuts of the
    seeded permutation random_split_ids rides, so a replay at the same
    (n, chunk_rows, seed) has the same chunks).  The JAX package's
    function, copied."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    cuts = np.arange(chunk_rows, n, chunk_rows, dtype=np.int64)
    return _permutation_split(n, cuts, seed)


def _pandas_columns(pdf: Any) -> Dict[str, np.ndarray]:
    """A pandas frame's columns as arrays; an object column of equal-length
    vectors becomes one 2-D block (one copy)."""
    cols: Dict[str, np.ndarray] = {}
    for name in pdf.columns:
        values = pdf[name].to_numpy()
        if values.dtype == object:
            values = stack_feature_cells(list(values))
        cols[str(name)] = values
    return cols


def partition_of(batch: Any, columns: Optional[Sequence[str]] = None) -> Partition:
    """One mapInPandas batch (or its `columns` only) as a Partition: a
    Partition's own arrays, a pandas frame's through _pandas_columns."""
    if isinstance(batch, Partition):
        return batch if columns is None else Partition({c: batch[c] for c in columns})
    return Partition(_pandas_columns(batch if columns is None else batch[list(columns)]))


def _host(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def as_dataframe(dataset: Any) -> DataFrame:
    """Coerce a supported input (this package's DataFrame, a pandas
    DataFrame, a pyarrow Table, or a live pyspark DataFrame, collected to
    the driver) into the facade.  Each foreign type is recognised by its
    module, so neither pandas, pyarrow nor pyspark is imported for the
    check."""
    if isinstance(dataset, DataFrame):
        return dataset
    module = type(dataset).__module__ or ""
    if module.startswith("pandas"):
        return DataFrame.from_pandas(dataset)
    if module.startswith("pyarrow"):
        import pyarrow as pa

        if isinstance(dataset, pa.Table):
            return DataFrame.from_arrow(dataset)
    if module.startswith("pyspark.sql"):
        from .spark.adapter import spark_to_facade

        return spark_to_facade(dataset)
    raise TypeError(f"Unsupported dataset type: {type(dataset)}")
