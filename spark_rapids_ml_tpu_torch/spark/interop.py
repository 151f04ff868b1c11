#
# CPU-model interop: fitted models converted into pyspark.ml models (each
# model's cpu()).
#
# Counterpart of spark_rapids_ml_tpu/spark/interop.py, the same py4j
# construction: the Java model is built through the active SparkSession's
# gateway from the model's arrays (a forest tree by tree from
# trees_to_dicts) and wrapped in its pyspark.ml class.  Without pyspark each
# entry point raises the JAX module's ImportError (_require_pyspark).
#

from __future__ import annotations

from typing import Any


def _require_pyspark() -> Any:
    try:
        import pyspark  # noqa: F401

        return pyspark
    except ImportError as e:
        raise ImportError(
            "cpu() interop requires pyspark; install pyspark to convert TPU "
            "models into pyspark.ml models."
        ) from e


def _active_session():
    from pyspark.sql import SparkSession

    spark = SparkSession.getActiveSession()
    if spark is None:
        raise RuntimeError("cpu() requires an active SparkSession")
    return spark


def _java_uid(sc: Any, prefix: str) -> Any:
    return sc._jvm.org.apache.spark.ml.util.Identifiable.randomUID(prefix)


def to_spark_pca_model(model: Any):
    """PCAModel -> pyspark.ml.feature.PCAModel, built through py4j."""
    _require_pyspark()
    from pyspark.ml.common import _py2java
    from pyspark.ml.feature import PCAModel as SparkPCAModel
    from pyspark.ml.linalg import DenseMatrix, DenseVector

    spark = _active_session()
    sc = spark.sparkContext
    k = len(model.components_)
    n = model.n_cols
    # DenseMatrix is column-major; components rows become matrix columns
    pc = DenseMatrix(n, k, model.components_.flatten().tolist(), False)
    ev = DenseVector(model.explained_variance_ratio_.tolist())
    java_model = sc._jvm.org.apache.spark.ml.feature.PCAModel(
        _java_uid(sc, "pca"), _py2java(sc, pc), _py2java(sc, ev)
    )
    spark_model = SparkPCAModel(java_model)
    model._copyValues(spark_model)
    return spark_model


def to_spark_kmeans_model(model: Any):
    """KMeansModel -> pyspark.ml.clustering.KMeansModel."""
    _require_pyspark()
    from pyspark.ml.clustering import KMeansModel as SparkKMeansModel
    from pyspark.ml.common import _py2java
    from pyspark.ml.linalg import DenseVector

    spark = _active_session()
    sc = spark.sparkContext
    java_centers = sc._jvm.java.util.ArrayList()
    for center in model.cluster_centers_:
        java_centers.add(_py2java(sc, DenseVector(list(center))))
    java_model = sc._jvm.org.apache.spark.ml.clustering.KMeansModel(
        _java_uid(sc, "kmeans"),
        sc._jvm.org.apache.spark.mllib.clustering.KMeansModel(java_centers),
    )
    spark_model = SparkKMeansModel(java_model)
    model._copyValues(spark_model)
    return spark_model


def to_spark_logistic_model(model: Any):
    """LogisticRegressionModel -> pyspark.ml LogisticRegressionModel (the
    intercepts through interceptVector's compression rule)."""
    _require_pyspark()
    from pyspark.ml.classification import (
        LogisticRegressionModel as SparkLogisticRegressionModel,
    )
    from pyspark.ml.common import _py2java
    from pyspark.ml.linalg import DenseMatrix

    spark = _active_session()
    sc = spark.sparkContext
    coef = model.coefficientMatrix
    mat = DenseMatrix(
        coef.shape[0], coef.shape[1], coef.flatten().tolist(), True
    )
    java_model = sc._jvm.org.apache.spark.ml.classification.LogisticRegressionModel(
        _java_uid(sc, "logreg"),
        _py2java(sc, mat),
        _py2java(sc, model.interceptVector),  # reuses the compression rule
        int(model.numClasses),
        bool(model.numClasses > 2),
    )
    spark_model = SparkLogisticRegressionModel(java_model)
    model._copyValues(spark_model)
    return spark_model


def _java_impurity_calculator(sc: Any, impurity: str, stats: Any, count: float):
    """mllib ImpurityCalculator over a java double[] of per-class stats
    (classification) or [w, wy, wy2] moments (regression)."""
    arr = sc._gateway.new_array(sc._jvm.double, len(stats))
    for i, v in enumerate(stats):
        arr[i] = float(v)
    pkg = sc._jvm.org.apache.spark.mllib.tree.impurity
    if impurity == "gini":
        return pkg.GiniCalculator(arr, int(count))
    if impurity == "entropy":
        return pkg.EntropyCalculator(arr, int(count))
    if impurity == "variance":
        return pkg.VarianceCalculator(arr, int(count))
    raise ValueError(f"unsupported impurity {impurity}")


def _build_java_tree(sc: Any, impurity: str, node: dict):
    """Recursively build an org.apache.spark.ml.tree node from one
    trees_to_dicts() dict: classifier leaves carry class-count stats and
    predict the argmax; regressor leaves predict their value with
    placeholder moments; an internal node's prediction and impurity, unused
    by Spark's prediction, are 0."""
    tree_pkg = sc._jvm.org.apache.spark.ml.tree
    if "split_feature" in node:
        left = _build_java_tree(sc, impurity, node["yes"])
        right = _build_java_tree(sc, impurity, node["no"])
        split = tree_pkg.ContinuousSplit(
            int(node["split_feature"]), float(node["threshold"])
        )
        n_stats = 3 if impurity == "variance" else 2
        calc = _java_impurity_calculator(
            sc, impurity, [0.0] * n_stats, node["instance_count"]
        )
        return tree_pkg.InternalNode(
            0.0, 0.0, float(node["gain"]), left, right, split, calc
        )
    leaf_values = node["leaf_value"]
    if impurity == "variance":
        prediction = float(leaf_values[0])
        calc = _java_impurity_calculator(
            sc, impurity, [0.0, 0.0, 0.0], node["instance_count"]
        )
    else:
        prediction = float(int(max(range(len(leaf_values)), key=lambda i: leaf_values[i])))
        calc = _java_impurity_calculator(
            sc, impurity, leaf_values, node["instance_count"]
        )
    return tree_pkg.LeafNode(prediction, 0.0, calc)


def to_spark_random_forest_model(model: Any):
    """RandomForest{Classification,Regression}Model -> the pyspark.ml
    model of its kind, each tree built through py4j from
    trees_to_dicts()."""
    _require_pyspark()
    spark = _active_session()
    sc = spark.sparkContext
    is_classification = bool(getattr(model, "_is_classification", False)) or hasattr(
        model, "classes_"
    )
    impurity = "variance"
    if is_classification:
        impurity = str(model.getOrDefault("impurity")) if model.hasParam("impurity") else "gini"
        if impurity not in ("gini", "entropy"):
            impurity = "gini"
    trees = [_build_java_tree(sc, impurity, t) for t in model.trees_to_dicts()]
    n_features = int(model.n_cols)
    if is_classification:
        from pyspark.ml.classification import (
            RandomForestClassificationModel as SparkRFCModel,
        )

        uid = _java_uid(sc, "rfc")
        dt_cls = sc._jvm.org.apache.spark.ml.classification.DecisionTreeClassificationModel
        n_classes = int(len(model.classes_))
        java_trees = sc._gateway.new_array(dt_cls, len(trees))
        for i, t in enumerate(trees):
            java_trees[i] = dt_cls(uid, t, n_features, n_classes)
        java_model = sc._jvm.org.apache.spark.ml.classification.RandomForestClassificationModel(
            uid, java_trees, n_features, n_classes
        )
        spark_model = SparkRFCModel(java_model)
    else:
        from pyspark.ml.regression import (
            RandomForestRegressionModel as SparkRFRModel,
        )

        uid = _java_uid(sc, "rfr")
        dt_cls = sc._jvm.org.apache.spark.ml.regression.DecisionTreeRegressionModel
        java_trees = sc._gateway.new_array(dt_cls, len(trees))
        for i, t in enumerate(trees):
            java_trees[i] = dt_cls(uid, t, n_features)
        java_model = sc._jvm.org.apache.spark.ml.regression.RandomForestRegressionModel(
            uid, java_trees, n_features
        )
        spark_model = SparkRFRModel(java_model)
    model._copyValues(spark_model)
    return spark_model


def to_spark_linear_model(model: Any):
    """LinearRegressionModel -> pyspark.ml.regression.LinearRegressionModel."""
    _require_pyspark()
    from pyspark.ml.common import _py2java
    from pyspark.ml.linalg import DenseVector
    from pyspark.ml.regression import LinearRegressionModel as SparkLRModel

    spark = _active_session()
    sc = spark.sparkContext
    coef = _py2java(sc, DenseVector(model.coef_.tolist()))
    java_model = sc._jvm.org.apache.spark.ml.regression.LinearRegressionModel(
        _java_uid(sc, "linReg"), coef, float(model.intercept_), float(1.0)
    )
    spark_model = SparkLRModel(java_model)
    model._copyValues(spark_model)
    return spark_model
