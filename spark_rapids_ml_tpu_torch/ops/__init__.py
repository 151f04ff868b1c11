#
# Solvers and kernels of the port; module names follow spark_rapids_ml_tpu/ops.
#
