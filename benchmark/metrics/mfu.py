"""% of the precision's peak reached by the network's FLOP for the volumes completed (each voxel once) over the window."""

from benchmark.harness import readings


def read(run):
    return readings.flop_share(run)
