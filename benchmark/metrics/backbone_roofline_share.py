"""% of the network's time that its least time takes: the layer bounds (bytes at 3.35 TB/s or FLOP at the precision's peak) for the volume's work counted once, over the time between CUDA events around each call into the network."""

from benchmark.harness import readings


def read(run):
    return readings.roofline_share(run)
