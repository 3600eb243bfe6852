"""Storage layer: the shared device arena and the streaming delta arena,
the flat backend (arena views and the private-copy ``FlatIndex``), the IVF
backend and the graph backend."""
from . import flat, graph, ivf  # noqa: F401  (register the backends)
from .base import (INDEX_REGISTRY, Arena, CapacityError,  # noqa: F401
                   DeltaArena, get_index_builder, register_index)
from .flat import FlatIndex  # noqa: F401
from .graph import GraphIndex  # noqa: F401
from .ivf import IVFIndex  # noqa: F401
