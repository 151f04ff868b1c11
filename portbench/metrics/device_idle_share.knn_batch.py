"""device_idle_share.knn_batch (%, device trace): device_idle_share.fit's
reading in the batch kNN cell, which moves that cell's own rate."""

from portbench import cell


def read(run):
    return cell.metric_reader("device_idle_share.fit").read(run)
