#
# ApproximateNearestNeighbors estimator/model (IVF-Flat and IVF-PQ).
#
# Counterpart of spark_rapids_ml_tpu/models/approximate_nn.py: the same params (algorithm 'ivfflat' | 'ivfpq'; algoParams {'nlist',
# 'nprobe', 'hot_fraction'} plus, for ivfpq, {'M', 'n_bits', 'refine_ratio',
# 'opq', 'usePrecomputedTables'}; a key outside these is an error), the same
# model attributes and persistence (a JAX-saved model loads here), and
# kneighbors on three routes: the probed flat search, the probed PQ search
# with the host refine, and exactSearch=True, which runs the exact kNN engine
# (ops/knn: prepare_items + knn_search_prepared) over the same packed items
# and shares their ids.  fit trains the coarse quantizer (and, for ivfpq, the
# codebooks) with the port's k-means on one device, as the JAX package trains
# on a one-device submesh (the packed payload does not depend on the mesh);
# its draws differ from the JAX package's, so a fresh fit gives other
# centroids there.
#
# Searching runs on the mesh get_mesh(num_workers) (num_workers None: every
# device of the entry points' list, use_device([...])): the staging caches
# are keyed by (mesh, hot_fraction), the indexes are list-sharded over it
# (ann/ivfflat.py) and the exact route is row-sharded (ops/knn).  One device
# is the one-shard mesh.
#
# mutable_index() stages the IVF-Flat payload as a live index on the mesh
# (ann/mutable.MutableIVFIndex: add / delete / repack); from then on
# kneighbors searches the holder's snapshot, exactSearch is refused (it reads
# the persisted payload, which mutations reach only at freeze), and
# freeze_mutations() folds the live rows back into the payload.
#
# _serving_entry serves each padded batch as ONE probed search (flat or PQ) on
# the slice's mesh, its query block padded to at least 64 rows
# (models/knn.serve_padded).  The
# flat entry reads the staged index again for every batch, so with a live
# holder it searches the latest snapshot: adds, deletes and repacks show in
# served results without re-registering the model.
#
# A live pyspark frame is refused at fit and at kneighbors with the JAX
# package's errors: the index is built and searched in-process (collect the
# frame with SRML_SPARK_COLLECT=1).
#
# Not carried over: the warm hooks (XLA ahead-of-time compiles; the serving
# engine warms by dispatching) and the SRML_ANN_HOT_FRACTION environment
# default.
#

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .. import device as _device
from ..ann.ivfflat import (
    PackedIVF,
    build_ivfflat_packed,
    default_nlist,
    default_nprobe,
    index_from_packed,
    ivfflat_search_prepared,
    tiered_index_from_packed,
)
from ..ann.pq import (
    DEFAULT_N_BITS,
    DEFAULT_REFINE_RATIO,
    PackedPQ,
    build_ivfpq_packed,
    default_m_sub,
    index_from_packed_pq,
    ivfpq_search_prepared,
    tiered_index_from_packed_pq,
)
from ..core import _TpuEstimatorSupervised, _TpuModel, _validate_input_columns
from ..dataframe import DataFrame, as_dataframe
from ..parallel.mesh import get_mesh
from ..params import HasFeaturesCol, HasFeaturesCols, Param, TypeConverters, _dummy, _TpuParams
from ..utils import materialize_feature_block

# per-algorithm algoParams surfaces; the PQ keys follow the upstream cuML
# names.  'hot_fraction' (both tiers) opts into the tiered residency
# (ann/tier.py); 'opq' (pq) trains a rotation before the subspace split.
_ALGO_PARAM_KEYS = {
    "ivfflat": {"nlist", "nprobe", "hot_fraction"},
    "ivfpq": {
        "nlist", "nprobe", "M", "n_bits", "usePrecomputedTables",
        "refine_ratio", "opq", "hot_fraction",
    },
}


class ApproximateNearestNeighborsClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors", "algorithm": "algorithm"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5, "verbose": False, "algorithm": "ivfflat", "metric": "euclidean"}


class _ApproximateNearestNeighborsParams(ApproximateNearestNeighborsClass, HasFeaturesCol, HasFeaturesCols):
    k = Param(_dummy(), "k", "the number of nearest neighbors to retrieve (> 0)", TypeConverters.toInt)
    idCol = Param(_dummy(), "idCol", "id column name; if unset a monotonically increasing id column is generated",
                  TypeConverters.toString)
    algorithm = Param(_dummy(), "algorithm",
                      "the ANN algorithm: 'ivfflat' (raw f32 lists) or 'ivfpq' (product-quantized lists)",
                      TypeConverters.toString)
    algoParams = Param(
        _dummy(), "algoParams",
        "algorithm parameters: {'nlist', 'nprobe', 'hot_fraction': device-resident list fraction} (both tiers) "
        "plus, for ivfpq, {'M': subspaces, 'n_bits': bits per code (4 packs two codes/byte and takes the "
        "fast-scan kernel), 'refine_ratio': f32 re-score factor (1 = ADC only), 'opq': train a learned rotation "
        "before the subspace split, 'usePrecomputedTables': ignored}",
        TypeConverters.identity,
    )
    exactSearch = Param(_dummy(), "exactSearch",
                        "route kneighbors through the exact brute-force engine over the indexed items "
                        "(recall escape hatch)", TypeConverters.toBoolean)

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(k=5, algorithm="ivfflat", exactSearch=False)

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setK(self, value: int):
        return self._set_params(k=value)

    def getIdCol(self) -> str:
        return self.getOrDefault("idCol") if self.isDefined("idCol") else "unique_id"

    def setIdCol(self, value: str):
        self.set(self.getParam("idCol"), value)
        return self

    def getAlgorithm(self) -> str:
        return self.getOrDefault("algorithm")

    def setAlgorithm(self, value: str):
        return self._set_params(algorithm=value)

    def getAlgoParams(self) -> Optional[Dict[str, Any]]:
        return self.getOrDefault("algoParams") if self.isDefined("algoParams") else None

    def setAlgoParams(self, value: Dict[str, Any]):
        self.set(self.getParam("algoParams"), value)
        return self

    def getExactSearch(self) -> bool:
        return self.getOrDefault("exactSearch")

    def setExactSearch(self, value: bool):
        self.set(self.getParam("exactSearch"), value)
        return self

    def setInputCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def _validated_algo_params(self) -> Dict[str, Any]:
        algo = self.getAlgorithm()
        ap = dict(self.getAlgoParams() or {})
        known = _ALGO_PARAM_KEYS[algo]
        unknown = set(ap) - known
        if unknown:
            raise ValueError(f"unknown algoParams {sorted(unknown)} for algorithm {algo!r}; supported: {sorted(known)}")
        return ap

    def _resolved_algo_params(self, n_items: int, n_lists: Optional[int] = None) -> Tuple[int, int]:
        """(nlist, nprobe), the defaults (default_nlist / default_nprobe)
        filling unset keys."""
        ap = self._validated_algo_params()
        nlist = int(ap.get("nlist", n_lists or default_nlist(n_items)))
        nprobe = int(ap.get("nprobe", default_nprobe(nlist)))
        if nlist < 1 or nprobe < 1:
            raise ValueError(f"nlist ({nlist}) and nprobe ({nprobe}) must be >= 1")
        return nlist, nprobe

    def _resolved_pq_params(self, dim: int, warn: bool = False) -> Tuple[int, int, int, bool]:
        """(M, n_bits, refine_ratio, opq) for algorithm='ivfpq' with the
        defaults (default_m_sub, 8 bits, refine x4, no rotation).
        refine_ratio 1 means ADC only; >= 2 re-scores the top
        k * refine_ratio candidates; below 1 is an error.
        usePrecomputedTables is accepted and ignored with a warning (the ADC
        formulation folds the list-dependent term into the item scalar)."""
        ap = self._validated_algo_params()
        if warn and "usePrecomputedTables" in ap:
            warnings.warn(
                "algoParams['usePrecomputedTables'] is ignored: the IVF-PQ engine always folds the "
                "list-dependent ADC term into the packed per-item scalar",
                stacklevel=3,
            )
        m = int(ap.get("M", default_m_sub(dim)))
        n_bits = int(ap.get("n_bits", DEFAULT_N_BITS))
        ratio = int(ap.get("refine_ratio", DEFAULT_REFINE_RATIO))
        opq = bool(ap.get("opq", False))
        if m < 1:
            raise ValueError(f"M ({m}) must be >= 1")
        if not 1 <= n_bits <= 8:
            raise ValueError(f"n_bits ({n_bits}) must be in [1, 8]")
        if ratio < 1:
            raise ValueError(
                f"refine_ratio ({ratio}) must be >= 1 (1 = ADC only, no f32 refine pass; >= 2 re-scores top "
                "k*ratio candidates)"
            )
        return m, n_bits, ratio, opq

    def _resolved_hot_fraction(self) -> float:
        """The fraction of the lists pinned on the device (ann/tier.py pages
        the rest from host memory); 1.0, everything resident, by default."""
        hf = float(self._validated_algo_params().get("hot_fraction", 1.0))
        if not 0.0 <= hf <= 1.0:
            raise ValueError(f"hot_fraction ({hf}) must be in [0, 1] (1 = fully device-resident, the default)")
        return hf

    def _check_algorithm(self) -> None:
        if self.getAlgorithm() not in _ALGO_PARAM_KEYS:
            raise ValueError(
                f"algorithm={self.getAlgorithm()!r} is not supported; implemented tiers: {sorted(_ALGO_PARAM_KEYS)}"
            )


class ApproximateNearestNeighbors(_ApproximateNearestNeighborsParams, _TpuEstimatorSupervised):
    """IVF-Flat / IVF-PQ approximate kNN: the port's k-means trains the
    quantizer on one device, the nearest-center kernel assigns the lists
    (and encodes the PQ codes), and the probed search runs the lookup-table
    kernels (PQ) and the fused merge kernel on every shard of the mesh."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _fit(self, dataset: Any) -> "ApproximateNearestNeighborsModel":
        from ..core import _use_executor_path

        self._check_algorithm()
        if getattr(dataset, "_device_features", None) is not None:
            raise NotImplementedError(
                "ApproximateNearestNeighbors.fit does not take DataFrame.from_device frames (their features "
                "column is a placeholder); fit a host frame instead"
            )
        if _use_executor_path(dataset):
            raise NotImplementedError(
                "ApproximateNearestNeighbors builds its index in-process; "
                "collect the pyspark item dataframe (SRML_SPARK_COLLECT=1) "
                "before fitting"
            )
        df = as_dataframe(dataset)
        id_col = self.getIdCol()
        if id_col not in df.columns:
            df = df.with_row_id(id_col)
        _validate_input_columns(self, df)
        input_col, input_cols = self._get_input_columns()
        parts = [p for p in df.partitions if len(p)]
        if not parts:
            raise RuntimeError("Dataset is empty; cannot build an IVF index")
        feats = [materialize_feature_block(p, input_col, input_cols, np.dtype(np.float32)) for p in parts]
        X = np.concatenate(feats) if len(feats) > 1 else feats[0]
        item_ids = np.concatenate([np.asarray(p[id_col], np.int64) for p in parts])
        nlist, _nprobe = self._resolved_algo_params(X.shape[0])
        self._resolved_hot_fraction()  # fail fast on an out-of-range knob
        dev = _device.resolve()
        common = dict(n_cols=int(X.shape[1]), dtype="float32")
        if self.getAlgorithm() == "ivfpq":
            m_sub, n_bits, _ratio, opq = self._resolved_pq_params(int(X.shape[1]), warn=True)
            pq = build_ivfpq_packed(X, item_ids, nlist, m_sub=m_sub, n_bits=n_bits, seed=0, opq=opq, device=dev)
            model = ApproximateNearestNeighborsModel(
                centroids_=pq.centroids, packed_items_=pq.items, packed_ids_=pq.ids, list_counts_=pq.counts,
                n_lists=pq.n_lists, n_items=pq.n_items, pq_codes_=pq.codes, pq_scalars_=pq.scalars,
                pq_codebooks_=pq.codebooks, pq_n_bits=pq.n_bits, pq_rotation_=pq.rotation, **common,
            )
        else:
            packed = build_ivfflat_packed(X, item_ids, nlist, seed=0, device=dev)
            model = ApproximateNearestNeighborsModel(
                centroids_=packed.centroids, packed_items_=packed.items, packed_ids_=packed.ids,
                list_counts_=packed.counts, n_lists=packed.n_lists, n_items=packed.n_items, **common,
            )
        self._copyValues(model)
        model._tpu_params.update(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        model._item_df = df
        return model

    def fit(self, dataset: Any, params: Optional[Dict] = None) -> "ApproximateNearestNeighborsModel":
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def _get_tpu_fit_func(self, dataset):  # pragma: no cover
        raise NotImplementedError("ApproximateNearestNeighbors overrides _fit")

    def _create_model(self, result):  # pragma: no cover
        raise NotImplementedError("ApproximateNearestNeighbors overrides _fit")


class ApproximateNearestNeighborsModel(_ApproximateNearestNeighborsParams, _TpuModel):
    """A fitted IVF-Flat / IVF-PQ index.  Persistable (the packed payload is
    what is saved; staging expands it on the device that loads it); a loaded
    model answers kneighbors without the item frame."""

    def __init__(
        self,
        centroids_: np.ndarray,
        packed_items_: np.ndarray,
        packed_ids_: np.ndarray,
        list_counts_: np.ndarray,
        n_lists: int,
        n_items: int,
        n_cols: int,
        dtype: str = "float32",
        pq_codes_: Optional[np.ndarray] = None,
        pq_scalars_: Optional[np.ndarray] = None,
        pq_codebooks_: Optional[np.ndarray] = None,
        pq_n_bits: Optional[int] = None,
        pq_rotation_: Optional[np.ndarray] = None,
    ) -> None:
        def arr(v, dt):
            return None if v is None else np.asarray(v, dt)

        attrs = dict(
            centroids_=arr(centroids_, np.float32),
            packed_items_=arr(packed_items_, np.float32),
            packed_ids_=arr(packed_ids_, np.int64),
            list_counts_=arr(list_counts_, np.int64),
            n_lists=int(n_lists),
            n_items=int(n_items),
            n_cols=int(n_cols),
            dtype=str(dtype),
            # the PQ tier's payload (None on an ivfflat model): codes, ADC
            # scalars, codebooks and the OPQ rotation (codes encode rotated
            # residuals, so the rotation persists with them)
            pq_codes_=arr(pq_codes_, np.uint8),
            pq_scalars_=arr(pq_scalars_, np.float32),
            pq_codebooks_=arr(pq_codebooks_, np.float32),
            pq_n_bits=None if pq_n_bits is None else int(pq_n_bits),
            pq_rotation_=arr(pq_rotation_, np.float32),
        )
        super().__init__(**attrs)
        for name, value in attrs.items():
            setattr(self, name, value)
        self._item_df: Optional[DataFrame] = None
        # staging caches keyed by (mesh, hot_fraction); they die with the
        # model: the probed index (flat or pq) and the exactSearch item set
        self._staged_index: Optional[Tuple[Any, Any]] = None
        self._staged_pq: Optional[Tuple[Any, Any]] = None
        self._staged_exact: Optional[Tuple[Any, Any]] = None
        # the live-mutation holder, keyed like the staged index; once it
        # exists it owns the flat index's staging
        self._mutable: Optional[Tuple[Any, Any]] = None

    def _packed(self) -> PackedIVF:
        return PackedIVF(self.packed_items_, self.packed_ids_, self.list_counts_, self.centroids_, self.n_lists,
                         self.n_items)

    def _packed_pq(self) -> PackedPQ:
        if self.pq_codes_ is None:
            raise ValueError(
                "this model was fit with algorithm='ivfflat'; it carries no PQ payload — refit with "
                "algorithm='ivfpq'"
            )
        return PackedPQ(
            self.pq_codes_, self.pq_scalars_, self.packed_ids_, self.packed_items_, self.list_counts_,
            self.centroids_, self.pq_codebooks_, self.n_lists, self.n_items, self.n_cols, self.pq_codes_.shape[1],
            self.pq_n_bits, rotation=self.pq_rotation_,
        )

    def _search_mesh(self, mesh: Any = None):
        """The mesh a search runs on: `mesh`, or get_mesh(num_workers)."""
        return mesh if mesh is not None else get_mesh(self.num_workers)

    def _ensure_staged_index(self, mesh):
        hf = self._resolved_hot_fraction()
        key = (mesh, hf)
        if self._mutable is not None:
            if self._mutable[0] != key:
                raise ValueError(
                    "this model's index is live-mutable on a different mesh; mutation is per-mesh — "
                    "freeze_mutations() before staging elsewhere"
                )
            return self._mutable[1].index
        if self._staged_index is None or self._staged_index[0] != key:
            self._staged_index = None  # the old index leaves the devices first
            if hf < 1.0:
                staged = tiered_index_from_packed(self._packed(), hf, mesh)
            else:
                staged = index_from_packed(self._packed(), mesh)
            self._staged_index = (key, staged)
        return self._staged_index[1]

    def _ensure_staged_pq(self, mesh):
        hf = self._resolved_hot_fraction()
        key = (mesh, hf)
        if self._staged_pq is None or self._staged_pq[0] != key:
            self._staged_pq = None
            if hf < 1.0:
                staged = tiered_index_from_packed_pq(self._packed_pq(), hf, mesh)
            else:
                staged = index_from_packed_pq(self._packed_pq(), mesh)
            self._staged_pq = (key, staged)
        return self._staged_pq[1]

    def _ensure_staged_exact(self, mesh):
        from ..ops.knn import prepare_items

        if self._mutable is not None:
            # the exact route stages the persisted payload, which mutations
            # reach only at freeze: it would return deleted ids and miss
            # the added ones
            raise ValueError(
                "exactSearch is unavailable while the index is live-mutable (the exact route reads the persisted "
                "payload, which mutations update only at freeze_mutations()); freeze first"
            )
        if self._staged_exact is None or self._staged_exact[0] != mesh:
            self._staged_exact = None
            self._staged_exact = (mesh, prepare_items(self.packed_items_, self.packed_ids_, mesh))
        return self._staged_exact[1]

    def mutable_index(self, mesh: Any = None):
        """The live-mutation holder of this model's IVF-Flat index
        (ann/mutable.MutableIVFIndex), staged on `mesh` (default
        get_mesh(num_workers)) at the first call and returned after.  Once it
        exists, kneighbors and the serving entry search its snapshot, so
        add_items / delete_items / repack show at once.  IVF-Flat only: PQ
        codes are not incrementally mutable."""
        self._check_algorithm()
        if self.getAlgorithm() == "ivfpq":
            raise ValueError(
                "live mutation is IVF-Flat-only; the PQ tier requires codebook-consistent codes (refit to mutate "
                "an ivfpq model)"
            )
        from ..ann.mutable import MutableIVFIndex

        mesh = self._search_mesh(mesh)
        hf = self._resolved_hot_fraction()
        key = (mesh, hf)
        if self._mutable is None:
            self._staged_index = None  # the holder owns the staging now
            self._mutable = (key, MutableIVFIndex(self._packed(), mesh, hot_fraction=hf))
        elif self._mutable[0] != key:
            raise ValueError(
                "mutable index already staged on a different mesh; freeze_mutations() and re-create to move meshes"
            )
        return self._mutable[1]

    def freeze_mutations(self) -> "ApproximateNearestNeighborsModel":
        """Fold the live holder's rows back into the persisted payload
        (compacted) and drop the holder: save() and staging then behave as
        for an index built over the mutated item set."""
        if self._mutable is None:
            return self
        packed = self._mutable[1].to_packed()
        for name, value in (("packed_items_", packed.items), ("packed_ids_", packed.ids),
                            ("list_counts_", packed.counts), ("centroids_", packed.centroids),
                            ("n_items", packed.n_items)):
            setattr(self, name, value)
            self._model_attributes[name] = value
        self._mutable = None
        self._staged_index = None
        self._staged_exact = None
        return self

    def kneighbors(self, query_df: Any) -> Tuple[Optional[DataFrame], DataFrame, DataFrame]:
        """Probed approximate k nearest items of every query row (float32
        euclidean): (item_df -- None on a loaded model --, query_df with the
        id column, knn_df with query_<idCol>, indices (rows, k) int64 and
        distances (rows, k) float32 in the query frame's partitioning).
        exactSearch=True runs the exact engine over the same indexed
        items.  Runs on get_mesh(num_workers)."""
        from ..core import _is_pyspark_dataframe

        self._check_algorithm()
        if _is_pyspark_dataframe(query_df):
            raise NotImplementedError(
                "ApproximateNearestNeighborsModel serves in-process query "
                "frames; collect the pyspark frame (SRML_SPARK_COLLECT=1) "
                "first"
            )
        mesh = self._search_mesh()
        qdf = as_dataframe(query_df)
        id_col = self.getIdCol()
        if id_col not in qdf.columns:
            qdf = qdf.with_row_id(id_col)
        input_col, input_cols = self._get_input_columns()
        k = self.getK()
        _nlist, nprobe = self._resolved_algo_params(self.n_items, n_lists=self.n_lists)
        exact = self.getExactSearch()
        pq = not exact and self.getAlgorithm() == "ivfpq"
        if exact:
            from ..ops.knn import knn_search_prepared

            prepared = self._ensure_staged_exact(mesh)
        elif pq:
            index = self._ensure_staged_pq(mesh)
            refine_ratio = self._resolved_pq_params(self.n_cols)[2]
        else:
            index = self._ensure_staged_index(mesh)
        k_eff = min(k, self.n_items if self._mutable is None else self._mutable[1].n_items)
        out_parts = []
        for part in qdf.partitions:
            if len(part) == 0:
                dists, ids = np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)
            else:
                feats = materialize_feature_block(part, input_col, input_cols, np.dtype(np.float32))
                if exact:
                    dists, ids = knn_search_prepared(prepared, feats, k)
                elif pq:
                    dists, ids = ivfpq_search_prepared(
                        index, feats, k, nprobe,
                        refine_items=self.packed_items_ if refine_ratio > 1 else None, refine_ratio=refine_ratio,
                    )
                else:
                    dists, ids = ivfflat_search_prepared(index, feats, k, nprobe)
            out_parts.append({
                f"query_{id_col}": np.asarray(part[id_col], np.int64) if len(part) else np.zeros(0, np.int64),
                "indices": np.asarray(ids, np.int64),
                "distances": np.asarray(dists, np.float32),
            })
        return self._item_df, qdf, DataFrame(out_parts)

    def _get_tpu_transform_func(self, dataset):  # pragma: no cover
        raise NotImplementedError("ApproximateNearestNeighborsModel has no transform; use kneighbors instead.")

    def _serving_entry(self, mesh: Any = None):
        """Online ANN hook (serving/): each padded batch is one probed
        search, IVF-Flat or IVF-PQ (with its host refine) by the algorithm
        param, on the slice's mesh (get_mesh(num_workers) without one)."""
        from ..ops import precompile
        from ..serving.entry import ServingEntry
        from .knn import SERVE_MIN_QUERIES, serve_padded

        self._check_algorithm()
        mesh = self._search_mesh(mesh)
        dev = mesh.devices[0]
        pq = self.getAlgorithm() == "ivfpq"
        k = self.getK()
        _nlist, nprobe = self._resolved_algo_params(self.n_items, n_lists=self.n_lists)
        dtype = np.dtype(np.float32)
        info = {"k": int(min(k, self.n_items)), "n_items": int(self.n_items), "nlist": int(self.n_lists),
                "nprobe": int(nprobe), "algorithm": self.getAlgorithm()}
        if pq:
            index = self._ensure_staged_pq(mesh)
            refine_ratio = self._resolved_pq_params(self.n_cols)[2]
            refine_items = self.packed_items_ if refine_ratio > 1 else None
            info.update(m_sub=int(self.pq_codes_.shape[1]), n_bits=int(self.pq_n_bits), refine_ratio=int(refine_ratio))

            def search(queries: np.ndarray):
                return ivfpq_search_prepared(index, queries, k, nprobe, refine_items=refine_items,
                                             refine_ratio=refine_ratio)
        else:
            self._ensure_staged_index(mesh)  # stage now (or check the live holder's mesh)

            def search(queries: np.ndarray):
                return ivfflat_search_prepared(self._ensure_staged_index(mesh), queries, k, nprobe)

        def key(rows: int):
            return precompile.warm_key("serve.ann", max(rows, SERVE_MIN_QUERIES), dtype, dev)

        def call(batch: np.ndarray) -> Dict[str, np.ndarray]:
            precompile.dispatch(key(batch.shape[0]))
            dists, ids = search(serve_padded(np.ascontiguousarray(batch, np.float32)))
            n = batch.shape[0]
            return {"indices": np.asarray(ids[:n], np.int64), "distances": np.asarray(dists[:n], np.float32)}

        return ServingEntry(
            name="serve.ann",
            n_cols=int(self.n_cols),
            dtype=dtype,
            out_cols=["indices", "distances"],
            call=call,
            warm=lambda buckets: [key(b) for b in buckets],
            info=info,
            device=dev,
        )

    def index_bytes_per_item(self) -> float:
        """Device-resident index bytes per indexed item (host payloads -- ids,
        the PQ refine vectors -- excluded: device memory is what the PQ tier
        saves)."""
        self._check_algorithm()
        mesh = self._search_mesh()
        index = self._ensure_staged_pq(mesh) if self.getAlgorithm() == "ivfpq" else self._ensure_staged_index(mesh)
        return index.device_bytes() / max(self.n_items, 1)

    def index_residency(self, hbm_budget_bytes: int = 16 << 30) -> Dict[str, float]:
        """Where each indexed item's bytes live: device bytes per item (the
        whole index, or the hot lists and the pool of a tiered split), host
        bytes per item (the tier's host planes and the payloads always kept
        on the host: ids and, for ivfpq, the refine vectors), and the items
        one device's budget of hbm_budget_bytes admits at this layout (the
        index staged on get_mesh(num_workers))."""
        self._check_algorithm()
        mesh = self._search_mesh()
        if self.getAlgorithm() == "ivfpq":
            index = self._ensure_staged_pq(mesh)
            host_extra = self.packed_items_.nbytes + self.packed_ids_.nbytes
        else:
            index = self._ensure_staged_index(mesh)
            host_extra = self.packed_ids_.nbytes
        n = max(self.n_items, 1)
        hbm_bpi = index.device_bytes() / n
        host_bpi = (getattr(index, "host_bytes", lambda: 0)() + host_extra) / n
        return {
            "hbm_bytes_per_item": float(hbm_bpi),
            "host_bytes_per_item": float(host_bpi),
            "items_per_device": float(np.floor(hbm_budget_bytes / max(hbm_bpi, 1e-12))),
        }
