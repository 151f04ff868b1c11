"""b5_roofline.online (%, device trace): b5_roofline's reading in the online
cell (64 queries a launch), which moves that cell's own rate."""

from portbench import cell


def read(run):
    return cell.metric_reader("b5_roofline").read(run)
