"""95th percentile of each volume's time over every volume of the window,
taken between the requests for successive volumes."""

import numpy as np


def read(run):
    ms = run.window.item_ms
    return float(np.percentile(ms, 95)) if ms else None
