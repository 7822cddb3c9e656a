"""Mean ms of the segmentation stage a volume, on the clock that synchronizes around it (the drivers' timer hook, or the harness's clock around each segmentation call)."""

from benchmark.harness import readings


def read(run):
    return readings.mean_span(run, "seg")
