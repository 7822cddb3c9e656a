"""Mean PR-GLS EM iterations a tracked volume, as the program counts them (SliceResult.stats[t]["prgls_iterations"])."""

from benchmark.harness import readings


def read(run):
    return readings.mean_stat(run, "prgls_iterations")
