"""Library information, counterpart of ``mxnet_tpu/libinfo.py``:
:func:`find_lib_path` lists the native libraries the package has built,
here the hand-written kernels' libraries under ``_build/``."""
from __future__ import annotations

import os

from . import __version__  # noqa: F401  (exposed here as in the reference)


def find_lib_path():
    """Paths of the built kernel libraries (``_build.SOURCES``, each at
    the name its current sources give it), in ``SOURCES`` order; an empty
    list when none is built, as the JAX package returns when its native
    libraries are absent (the Python frontend needs none to import)."""
    from . import _build

    paths = [_build.library_path(name) for name in _build.SOURCES]
    return [p for p in paths if os.path.exists(p)]
