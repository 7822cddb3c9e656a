"""% of the precision's peak reached by three times the batch's forward FLOP a step (forward, dX, dW) over the training window."""

from benchmark.harness import readings


def read(run):
    return readings.flop_share(run, passes=3.0)
