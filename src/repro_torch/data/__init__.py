"""Workload generation."""
from .pipeline import VectorLabelDataset  # noqa: F401
