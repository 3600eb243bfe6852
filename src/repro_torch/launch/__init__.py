"""Launch-side models: the fused-scan tile model."""
