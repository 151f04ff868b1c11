"""kneighbors_rows_per_s.online (rows/s, host clock): query rows answered
over the window's seconds, in the online cell: kneighbors_rows_per_s's
reading under a name of its own, so that each cell's rate carries the
bound its own spread allows."""

from portbench import cell


def read(run):
    return cell.metric_reader("kneighbors_rows_per_s").read(run)
