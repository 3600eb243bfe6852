"""Serving (port of ``repro/serve``): the slot-based batched decoder."""
from .engine import BatchedDecoder, Request

__all__ = ["BatchedDecoder", "Request"]
