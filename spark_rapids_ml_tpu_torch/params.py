#
# Spark-ML-compatible parameter system + solver param translation layer.
#
# Counterpart of spark_rapids_ml_tpu/params.py, kept as this package's own
# copy so the port never imports the JAX package: Param/Params/TypeConverters
# reproduce the public behaviour of pyspark.ml.param, and _TpuParams keeps
# the Spark param space and the solver param dict (`tpu_params`, the name the
# JAX package uses, so a reader finds each counterpart) in sync.  The default
# num_workers is the length of the entry points' device list
# (device.devices()), as the JAX package's is its device count.
#

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, TypeVar, Union

import numpy as np

P = TypeVar("P", bound="Params")

_uid_lock = threading.Lock()
_uid_counters: Dict[str, int] = {}


def _gen_uid(cls_name: str) -> str:
    with _uid_lock:
        n = _uid_counters.get(cls_name, 0)
        _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


class Param:
    """A named parameter with a doc string and optional type converter.

    Params are class-level singletons on each Params subclass; identity-based
    dict keys (param maps) therefore work across instances of the same class.
    """

    __slots__ = ("parent", "name", "doc", "typeConverter")

    def __init__(
        self,
        parent: Any,
        name: str,
        doc: str,
        typeConverter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda x: x)

    def __repr__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Param) and self.name == other.name


class TypeConverters:
    """Type conversion helpers mirroring pyspark.ml.param.TypeConverters."""

    @staticmethod
    def toInt(value: Any) -> int:
        import numbers

        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value} to int")
        if isinstance(value, numbers.Number) and float(value) == int(value):
            return int(value)
        raise TypeError(f"Could not convert {value} to int")

    @staticmethod
    def toFloat(value: Any) -> float:
        import numbers

        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value} to float")
        if isinstance(value, numbers.Number):
            return float(value)
        raise TypeError(f"Could not convert {value} to float")

    @staticmethod
    def toString(value: Any) -> str:
        if isinstance(value, str):
            return value
        raise TypeError(f"Could not convert {value} to string")

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"Could not convert {value} to boolean")

    @staticmethod
    def toList(value: Any) -> list:
        if isinstance(value, (list, tuple)):
            return list(value)
        if isinstance(value, np.ndarray):
            return value.tolist()
        raise TypeError(f"Could not convert {value} to list")

    @staticmethod
    def toListFloat(value: Any) -> List[float]:
        return [TypeConverters.toFloat(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListInt(value: Any) -> List[int]:
        return [TypeConverters.toInt(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListString(value: Any) -> List[str]:
        return [TypeConverters.toString(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def identity(value: Any) -> Any:
        return value


class Params:
    """Base class holding params, user-set values, and defaults.

    Public surface matches pyspark.ml.param.Params: params, hasParam, getParam,
    isSet, isDefined, getOrDefault, set, clear, extractParamMap, copy,
    explainParam(s), hasDefault.
    """

    def __init__(self) -> None:
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}

    # -- param discovery ---------------------------------------------------
    @property
    def params(self) -> List[Param]:
        seen = {}
        for klass in reversed(type(self).__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    seen[attr.name] = attr
        return sorted(seen.values(), key=lambda p: p.name)

    def hasParam(self, paramName: str) -> bool:
        return any(p.name == paramName for p in self.params)

    def getParam(self, paramName: str) -> Param:
        for p in self.params:
            if p.name == paramName:
                return p
        raise AttributeError(f"{type(self).__name__} has no param '{paramName}'")

    def _resolveParam(self, param: Union[str, Param]) -> Param:
        return self.getParam(param) if isinstance(param, str) else self.getParam(param.name)

    # -- get/set -----------------------------------------------------------
    def isSet(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param: Union[str, Param]) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param: Union[str, Param]) -> Any:
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(f"Param '{param.name}' is not set and has no default")

    def set(self, param: Union[str, Param], value: Any) -> "Params":
        param = self._resolveParam(param)
        self._paramMap[param] = param.typeConverter(value)
        return self

    def clear(self, param: Union[str, Param]) -> None:
        self._paramMap.pop(self._resolveParam(param), None)

    def _setDefault(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            self._defaultParamMap[self.getParam(name)] = value
        return self

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        paramMap = dict(self._defaultParamMap)
        paramMap.update(self._paramMap)
        if extra:
            paramMap.update(extra)
        return paramMap

    def explainParam(self, param: Union[str, Param]) -> str:
        param = self._resolveParam(param)
        values = []
        if self.hasDefault(param):
            values.append(f"default: {self._defaultParamMap[param]}")
        if self.isSet(param):
            values.append(f"current: {self._paramMap[param]}")
        return f"{param.name}: {param.doc} ({', '.join(values) if values else 'undefined'})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self: P, extra: Optional[Dict[Param, Any]] = None) -> P:
        import copy as _copy

        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for k, v in extra.items():
                that.set(k, v)
        return that

    def _copyValues(self, to: "Params", extra: Optional[Dict[Param, Any]] = None) -> "Params":
        paramMap = dict(self._paramMap)
        if extra:
            paramMap.update(extra)
        for p, v in self._defaultParamMap.items():
            if to.hasParam(p.name):
                to._defaultParamMap[to.getParam(p.name)] = v
        for p, v in paramMap.items():
            if to.hasParam(p.name):
                to._paramMap[to.getParam(p.name)] = v
        return to


def _dummy() -> Any:
    class _Dummy:
        uid = "undefined"

    return _Dummy()


# ---------------------------------------------------------------------------
# Shared param mixins (the subset the ported estimators use)
# ---------------------------------------------------------------------------


class HasFeaturesCol(Params):
    featuresCol = Param(
        _dummy(), "featuresCol", "features column name", TypeConverters.toString
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(featuresCol="features")

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)


class HasFeaturesCols(Params):
    """Param for a list of scalar feature column names (multi-column input)."""

    featuresCols = Param(
        _dummy(),
        "featuresCols",
        "features column names for multi-column input",
        TypeConverters.toListString,
    )

    def getFeaturesCols(self) -> List[str]:
        return self.getOrDefault(self.featuresCols)


class HasPredictionCol(Params):
    predictionCol = Param(
        _dummy(), "predictionCol", "prediction column name", TypeConverters.toString
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(predictionCol="prediction")

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)


class HasLabelCol(Params):
    labelCol = Param(_dummy(), "labelCol", "label column name", TypeConverters.toString)

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(labelCol="label")

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)


class HasProbabilityCol(Params):
    probabilityCol = Param(
        _dummy(),
        "probabilityCol",
        "column name for predicted class conditional probabilities",
        TypeConverters.toString,
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(probabilityCol="probability")

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)


class HasRawPredictionCol(Params):
    rawPredictionCol = Param(
        _dummy(),
        "rawPredictionCol",
        "raw prediction (confidence) column name",
        TypeConverters.toString,
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(rawPredictionCol="rawPrediction")

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault(self.rawPredictionCol)


class HasWeightCol(Params):
    weightCol = Param(
        _dummy(), "weightCol", "weight column name", TypeConverters.toString
    )

    def getWeightCol(self) -> str:
        return self.getOrDefault(self.weightCol)


class HasMaxIter(Params):
    maxIter = Param(
        _dummy(), "maxIter", "max number of iterations (>= 0)", TypeConverters.toInt
    )

    def getMaxIter(self) -> int:
        return self.getOrDefault(self.maxIter)


class HasTol(Params):
    tol = Param(
        _dummy(),
        "tol",
        "the convergence tolerance for iterative algorithms (>= 0)",
        TypeConverters.toFloat,
    )

    def getTol(self) -> float:
        return self.getOrDefault(self.tol)


class HasInputCol(Params):
    inputCol = Param(_dummy(), "inputCol", "input column name", TypeConverters.toString)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)


class HasInputCols(Params):
    inputCols = Param(
        _dummy(), "inputCols", "input column names", TypeConverters.toListString
    )

    def getInputCols(self) -> List[str]:
        return self.getOrDefault(self.inputCols)


class HasOutputCol(Params):
    outputCol = Param(
        _dummy(), "outputCol", "output column name", TypeConverters.toString
    )

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)


class HasRegParam(Params):
    regParam = Param(
        _dummy(), "regParam", "regularization parameter (>= 0)", TypeConverters.toFloat
    )

    def getRegParam(self) -> float:
        return self.getOrDefault(self.regParam)


class HasElasticNetParam(Params):
    elasticNetParam = Param(
        _dummy(),
        "elasticNetParam",
        "the ElasticNet mixing parameter, in range [0, 1]. alpha = 0 -> L2, alpha = 1 -> L1",
        TypeConverters.toFloat,
    )

    def getElasticNetParam(self) -> float:
        return self.getOrDefault(self.elasticNetParam)


class HasFitIntercept(Params):
    fitIntercept = Param(
        _dummy(),
        "fitIntercept",
        "whether to fit an intercept term",
        TypeConverters.toBoolean,
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(fitIntercept=True)

    def getFitIntercept(self) -> bool:
        return self.getOrDefault(self.fitIntercept)


class HasStandardization(Params):
    standardization = Param(
        _dummy(),
        "standardization",
        "whether to standardize the training features before fitting the model",
        TypeConverters.toBoolean,
    )

    def getStandardization(self) -> bool:
        return self.getOrDefault(self.standardization)


class HasSeed(Params):
    seed = Param(_dummy(), "seed", "random seed", TypeConverters.toInt)

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        import zlib

        self._setDefault(seed=zlib.crc32(type(self).__name__.encode()) % (1 << 31))

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)


class HasVerbose(Params):
    verbose = Param(
        _dummy(),
        "verbose",
        "solver logging verbosity (bool or 0-6 int level)",
        TypeConverters.identity,
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(verbose=False)


# ---------------------------------------------------------------------------
# Spark <-> solver param translation
# ---------------------------------------------------------------------------


class _TpuClass:
    """Declares how Spark ML params translate to solver params:
      - ``_param_mapping`` maps each Spark param name to a solver param name;
        an empty-string value means "unsupported, silently ignore"; ``None``
        means "unsupported, raise if the user sets a value".
      - ``_param_value_mapping`` maps a solver param name to a function that
        remaps/validates values, returning None for unsupported values.
      - ``_get_tpu_params_default`` returns default solver params.
    """

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Union[None, Any]]]:
        return {}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {}


class _TpuParams(_TpuClass, Params):
    """Params mixin holding the ``tpu_params`` dict fed to the torch solvers.

    Keeps the Spark Param space and the solver param dict in sync in both
    directions and reserves the ``num_workers`` / ``float32_inputs`` kwargs.
    """

    _tpu_params: Dict[str, Any]
    _num_workers: Optional[int] = None
    _float32_inputs: bool = True
    # estimators and models with a sparse (CSR -> ELL) compute path set this
    # True (the GLMs); the others densify CSR input partition by partition
    _supports_sparse_input: bool = False

    @property
    def tpu_params(self) -> Dict[str, Any]:
        return self._tpu_params

    @property
    def num_workers(self) -> int:
        return self._infer_num_workers() if self._num_workers is None else self._num_workers

    @num_workers.setter
    def num_workers(self, value: int) -> None:
        self._num_workers = value

    def _infer_num_workers(self) -> int:
        """Default parallelism: one logical worker per device of the entry
        points' device list (parallel.mesh.default_num_workers)."""
        from .parallel.mesh import default_num_workers

        return default_num_workers()

    def _initialize_tpu_params(self) -> None:
        self._tpu_params = self._get_tpu_params_default()
        # push current Spark-side defaults into solver params
        for spark_name, solver_name in self._param_mapping().items():
            if not solver_name:
                continue
            if self.hasParam(spark_name) and self.isDefined(spark_name):
                self._set_tpu_value(solver_name, self.getOrDefault(spark_name))

    def _set_params(self: P, **kwargs: Any) -> P:
        """Set params by Spark name or solver name."""
        mapping = self._param_mapping()
        for k, v in kwargs.items():
            if k == "num_workers":
                self._num_workers = v
            elif k == "float32_inputs":
                self._float32_inputs = v
            elif self.hasParam(k):
                self.set(self.getParam(k), v)
                if k in mapping:
                    solver_name = mapping[k]
                    if solver_name:
                        self._set_tpu_value(solver_name, self.getOrDefault(k))
                    elif solver_name is None:
                        raise ValueError(
                            f"Param '{k}' is not supported by the torch implementation of "
                            f"{type(self).__name__}."
                        )
            elif k in self._tpu_params:
                self._set_tpu_value(k, v)
                # reflect back to the Spark param if one maps to it
                for spark_name, solver_name in mapping.items():
                    if solver_name == k and self.hasParam(spark_name):
                        self.set(self.getParam(spark_name), v)
            else:
                raise ValueError(f"Unsupported param: {k}")
        return self

    def copy(self: P, extra: Optional[Dict[Any, Any]] = None) -> P:
        """Copy keeping spark params and solver params in sync (the base copy
        would alias the mutable _tpu_params dict and skip the translation)."""
        that = super().copy(None)
        if hasattr(self, "_tpu_params"):
            that._tpu_params = dict(self._tpu_params)
        if extra:
            for k, v in extra.items():
                name = k.name if isinstance(k, Param) else k
                that._set_params(**{name: v})
        return that

    def _set_tpu_value(self, name: str, value: Any) -> None:
        value_mapping = self._param_value_mapping()
        if name in value_mapping:
            mapped = value_mapping[name](value)
            if mapped is None:
                raise ValueError(
                    f"Value '{value}' for param '{name}' is not supported by the torch "
                    f"implementation of {type(self).__name__}."
                )
            value = mapped
        self._tpu_params[name] = value

    def _transform_dtype(self, model_dtype: Optional[str] = None) -> np.dtype:
        """Single source of truth for the inference dtype: float32 when
        float32_inputs (the default), else the dtype recorded at fit time."""
        if self._float32_inputs:
            return np.dtype(np.float32)
        return np.dtype(model_dtype or np.float64)

    # ------------------------------------------------------------------
    def _get_input_columns(self) -> tuple:
        """Returns (featuresCol-or-None, featuresCols-or-None)."""
        input_col, input_cols = None, None
        if self.hasParam("featuresCols") and self.isDefined("featuresCols"):
            input_cols = self.getOrDefault("featuresCols")
        elif self.hasParam("featuresCol") and self.isDefined("featuresCol"):
            input_col = self.getOrDefault("featuresCol")
        elif self.hasParam("inputCols") and self.isDefined("inputCols"):
            input_cols = self.getOrDefault("inputCols")
        elif self.hasParam("inputCol") and self.isDefined("inputCol"):
            input_col = self.getOrDefault("inputCol")
        else:
            raise ValueError("Please set inputCol(s) or featuresCol(s)")
        return input_col, input_cols

    def setFeaturesCol(self: P, value: Union[str, List[str]]) -> P:
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self: P, value: List[str]) -> P:
        return self._set_params(featuresCols=value)

    def setLabelCol(self: P, value: str) -> P:
        return self._set_params(labelCol=value)

    def setPredictionCol(self: P, value: str) -> P:
        return self._set_params(predictionCol=value)
