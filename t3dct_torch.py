"""Importable alias for the ``3deecelltracker_tpu_torch`` package.

The directory name starts with a digit, which is not a valid Python
identifier, so ``import t3dct_torch`` is the supported import path (the
same arrangement as ``t3dct.py`` for the JAX package).  The package
registers itself and its submodules under this name on first import.
"""

import importlib
import sys

_pkg = importlib.import_module("3deecelltracker_tpu_torch")
sys.modules[__name__] = _pkg
