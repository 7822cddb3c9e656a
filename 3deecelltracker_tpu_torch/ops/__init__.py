"""See the package docstring.  Exported here, as the JAX package's
``ops/__init__.py`` exports them: the reference trackerlite's free
functions and filters that callers import from ``ops``."""

from .filters import uniform_filter
from .matching import (non_max_suppression_normalize, row_wise_normalize,
                       softmax_normalize)
from .prgls import prgls_quick
from .subregions import move_cells_full

__all__ = ["uniform_filter", "non_max_suppression_normalize",
           "row_wise_normalize", "softmax_normalize", "prgls_quick",
           "move_cells_full"]
