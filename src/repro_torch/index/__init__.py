"""Storage layer: the shared device arena, the flat backend (arena views
and the private-copy ``FlatIndex``) and the IVF backend."""
from . import flat, ivf  # noqa: F401  (register "flat" and "ivf")
from .base import (INDEX_REGISTRY, Arena, CapacityError,  # noqa: F401
                   get_index_builder, register_index)
from .flat import FlatIndex  # noqa: F401
from .ivf import IVFIndex  # noqa: F401
