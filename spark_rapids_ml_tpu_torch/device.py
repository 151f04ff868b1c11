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
# A request may also be a sequence of devices: the device list a mesh is
# built over (parallel/mesh.py), one device per shard, driven from this one
# process.  A device may repeat — ["cpu"] * 8 in the CPU tests, ["cuda:0"] * 4
# on a host with one card — the counterpart of the JAX package's forced host
# device count.  resolve() keeps returning the first device of the list, so
# an entry point that runs on one device behaves as with a one-device
# request; devices() returns the whole list, or every visible CUDA device
# when nothing was requested.
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
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]

_lock = threading.Lock()
_requested: Optional[Tuple[torch.device, ...]] = None

_NO_CUDA = (
    "spark_rapids_ml_tpu_torch runs on a CUDA device and none is "
    "available; call spark_rapids_ml_tpu_torch.device.use_device('cpu') "
    "to run on the CPU"
)


def _fix_matmul_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _as_devices(dev: Union[DeviceLike, Sequence[DeviceLike], None]) -> Optional[Tuple[torch.device, ...]]:
    if dev is None:
        return None
    if isinstance(dev, (str, torch.device)):
        return (torch.device(dev),)
    devs = tuple(torch.device(d) for d in dev)
    if not devs:
        raise ValueError("use_device needs at least one device")
    return devs


class use_device:
    """Ask the entry points to run on `dev` ("cpu", "cuda", "cuda:0", a
    torch.device, or a sequence of them: the device list of a mesh, where a
    device may repeat).  Takes effect at once; used as a context manager it
    restores the previous request on exit::

        use_device("cpu")                  # from now on
        with use_device("cpu"): ...        # for this block only
        with use_device(["cpu"] * 8): ...  # an 8-shard mesh on the CPU
    """

    def __init__(self, dev: Union[DeviceLike, Sequence[DeviceLike], None]) -> None:
        global _requested
        new = _as_devices(dev)
        with _lock:
            self._previous = _requested
            _requested = new

    def __enter__(self) -> "use_device":
        return self

    def __exit__(self, *exc: object) -> None:
        global _requested
        with _lock:
            _requested = self._previous


def devices() -> Tuple[torch.device, ...]:
    """The device list of the entry points: the requested one, else every
    visible CUDA device.  Raises RuntimeError when a CUDA device is requested
    without CUDA, or when nothing is requested and there is no CUDA device."""
    _fix_matmul_precision()
    with _lock:
        devs = _requested
    if devs is not None:
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError(f"devices {[str(d) for d in devs]} requested but CUDA is not available")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def resolve() -> torch.device:
    """The device the entry points run on: the first requested one, else
    cuda:0.  Raises RuntimeError when neither is available."""
    _fix_matmul_precision()
    with _lock:
        devs = _requested
    if devs is not None:
        if devs[0].type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {devs[0]} requested but CUDA is not available")
        return devs[0]
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return torch.device("cuda", 0)
