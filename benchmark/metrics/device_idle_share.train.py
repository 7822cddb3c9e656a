"""% of a traced span of the training window in which nothing ran on the device (as device_idle_share)."""

from benchmark.harness import readings


def read(run):
    return readings.idle_share(run)
