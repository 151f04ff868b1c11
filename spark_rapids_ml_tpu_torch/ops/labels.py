#
# Label encoding shared by the supervised classifiers.
#
# Counterpart of spark_rapids_ml_tpu/ops/labels.py: the class set comes from
# core.discover_label_classes, and the encode runs on the labels' device.
#

from __future__ import annotations

import torch


def encode_labels(y: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Class index per row: the count of classes strictly below y (the
    searchsorted('left') position of y in the sorted class set), clamped
    into range, so rows whose value is outside the class set (zero-padded
    rows, masked by weight) still get a valid index.  int64, y's shape."""
    idx = torch.zeros(y.shape, dtype=torch.int64, device=y.device)
    for c in classes.to(y.device):
        idx += y > c
    return idx.clamp_(max=classes.shape[0] - 1)
