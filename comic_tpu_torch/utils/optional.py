"""Optional libraries, imported only inside the functions that need them:
TensorFlow (TF checkpoints), tensorstore (Orbax directories), h5py (the
packed dataset) and PIL (JPEG files). A missing one raises an ImportError
that names it; nothing falls back to another path."""

from __future__ import annotations

import importlib


def require(module: str, purpose: str):
    """``import module`` -> the module, or ImportError naming it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{purpose} needs the '{module.split('.')[0]}' "
                          f"package, which cannot be imported here: {e}"
                          ) from e
