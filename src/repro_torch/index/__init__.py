"""Storage layer: the shared device arena and the flat backend."""
from . import flat  # noqa: F401  (registers the "flat" backend)
from .base import (INDEX_REGISTRY, Arena, CapacityError,  # noqa: F401
                   get_index_builder, register_index)
