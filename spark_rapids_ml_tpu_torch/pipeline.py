#
# Pipeline / PipelineModel: chained stages over the DataFrame facade.
#
# Counterpart of spark_rapids_ml_tpu/pipeline.py, with pyspark.ml.Pipeline's
# API: fit() walks the stages, fitting each estimator and transforming with
# the fitted model to feed the next stage (up to the last estimator), and
# passing transformers through; PipelineModel.transform() applies every
# fitted stage in order.  A stage that has both fit and transform but is
# not one of this package's estimators is ambiguous and raises unless it
# declares `srml_stage_role` ("estimator" or "transformer").  Persistence
# keeps the JAX package's layout (metadata.json and a stage_NNN directory a
# stage), so a pipeline the JAX package saved loads here (its stages through
# core.load's class mapping).
#

from __future__ import annotations

import json
import os
from typing import Any, List, Optional

from .core import _TpuEstimator
from .core import load as _load_any
from .dataframe import DataFrame, as_dataframe

_PIPELINE_META = "metadata.json"


def _is_estimator(stage: Any) -> bool:
    """Whether the stage is fitted (an estimator) or applied as it is."""
    if isinstance(stage, _TpuEstimator):
        return True
    has_fit, has_transform = hasattr(stage, "fit"), hasattr(stage, "transform")
    if has_fit and has_transform:
        role = getattr(stage, "srml_stage_role", None)
        if role in ("estimator", "transformer"):
            return role == "estimator"
        if role is not None:
            raise TypeError(
                f"Pipeline stage {type(stage).__name__!r} has unrecognized srml_stage_role {role!r}; "
                "expected 'estimator' or 'transformer'."
            )
        raise TypeError(
            f"Ambiguous pipeline stage {type(stage).__name__!r}: it defines both fit and transform but is "
            "not a framework estimator. Set stage.srml_stage_role = 'estimator' (fit it here) or "
            "'transformer' (apply as-is) to disambiguate."
        )
    return has_fit


class Pipeline:
    """pyspark.ml.Pipeline: a chain of estimators and transformers."""

    def __init__(self, stages: Optional[List[Any]] = None) -> None:
        self._stages: List[Any] = list(stages or [])

    def setStages(self, stages: List[Any]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> List[Any]:
        return list(self._stages)

    def fit(self, dataset: Any) -> "PipelineModel":
        df = as_dataframe(dataset)
        # stages after the last estimator need no transform during fit
        roles = [_is_estimator(stage) for stage in self._stages]
        last_est = max((i for i, est in enumerate(roles) if est), default=-1)
        fitted: List[Any] = []
        for i, (stage, est) in enumerate(zip(self._stages, roles)):
            model = stage.fit(df) if est else stage
            fitted.append(model)
            if i < last_est:
                df = as_dataframe(model.transform(df))
        return PipelineModel(fitted)

    def copy(self, extra: Optional[dict] = None) -> "Pipeline":
        return Pipeline([s.copy(extra) if hasattr(s, "copy") else s for s in self._stages])

    def save(self, path: str) -> None:
        _save_stages(path, "Pipeline", self._stages)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        return cls(_load_stages(path))


class PipelineModel:
    """A fitted pipeline: every stage's transform in order."""

    def __init__(self, stages: List[Any]) -> None:
        self.stages: List[Any] = list(stages)

    def transform(self, dataset: Any) -> DataFrame:
        df = as_dataframe(dataset)
        for stage in self.stages:
            df = as_dataframe(stage.transform(df))
        return df

    def copy(self, extra: Optional[dict] = None) -> "PipelineModel":
        return PipelineModel([s.copy(extra) if hasattr(s, "copy") else s for s in self.stages])

    def save(self, path: str) -> None:
        _save_stages(path, "PipelineModel", self.stages)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        return cls(_load_stages(path))


def _save_stages(path: str, kind: str, stages: List[Any]) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _PIPELINE_META), "w") as f:
        json.dump({"class": f"{__name__}.{kind}", "n_stages": len(stages)}, f, indent=2)
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, f"stage_{i:03d}"))


def _load_stages(path: str) -> List[Any]:
    with open(os.path.join(path, _PIPELINE_META)) as f:
        meta = json.load(f)
    return [_load_any(os.path.join(path, f"stage_{i:03d}")) for i in range(meta["n_stages"])]
