"""mfu.knn_online (%, host clock): mfu.knn's reading in the online cell,
which moves that cell's own rate."""

from portbench import cell


def read(run):
    return cell.metric_reader("mfu.knn").read(run)
