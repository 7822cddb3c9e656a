"""% of a traced span of the window in which nothing ran on the device: 1 - (union of device operations) / span, from torch.profiler."""

from benchmark.harness import readings


def read(run):
    return readings.idle_share(run)
