"""Mean ms of the tracking stage a volume, on the clock that synchronizes around the drivers' "track" stage."""

from benchmark.harness import readings


def read(run):
    return readings.mean_span(run, "track")
