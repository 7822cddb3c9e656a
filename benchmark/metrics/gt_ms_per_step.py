"""Mean ms of the training GT (make_gt) a step, on a clock that synchronizes around it."""

from benchmark.harness import readings


def read(run):
    return readings.mean_span(run, "gt")
