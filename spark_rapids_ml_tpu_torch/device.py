#
# Device policy of the port.
#
# Every entry point (KMeans.fit, KMeansModel.transform/predict, load followed
# by transform) runs on cuda:0.  A caller that wants the CPU says so with
# use_device("cpu") — as a setter or as a context manager; the CPU tests do.
# With no CUDA device and no such request the entry points raise
# RuntimeError: they never quietly run on the CPU.  There is no environment
# switch.
#
# Precision: the port's matmuls run in full float32.  TF32 keeps ~10 mantissa
# bits, and the norm-expansion distance ||x||^2 - 2 x.c + ||c||^2 cancels, so
# TF32 products flip nearest-center assignments between nearly equidistant
# centers (the JAX package runs the same products at Precision.HIGHEST for
# the same reason).  resolve() therefore sets
# torch.backends.cuda.matmul.allow_tf32 = False and the float32 matmul
# precision "highest" each time an entry point picks its device.
#

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

_lock = threading.Lock()
_requested: Optional[torch.device] = None


def _fix_matmul_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class use_device:
    """Ask the entry points to run on `dev` ("cpu", "cuda", "cuda:0", or a
    torch.device).  Takes effect at once; used as a context manager it
    restores the previous request on exit::

        use_device("cpu")              # from now on
        with use_device("cpu"): ...    # for this block only
    """

    def __init__(self, dev: Union[str, torch.device, None]) -> None:
        global _requested
        new = None if dev is None else torch.device(dev)
        with _lock:
            self._previous = _requested
            _requested = new

    def __enter__(self) -> "use_device":
        return self

    def __exit__(self, *exc: object) -> None:
        global _requested
        with _lock:
            _requested = self._previous


def resolve() -> torch.device:
    """The device the entry points run on: the requested one, else cuda:0.
    Raises RuntimeError when neither is available."""
    _fix_matmul_precision()
    with _lock:
        dev = _requested
    if dev is not None:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spark_rapids_ml_tpu_torch runs on a CUDA device and none is "
            "available; call spark_rapids_ml_tpu_torch.device.use_device('cpu') "
            "to run on the CPU"
        )
    return torch.device("cuda", 0)
