"""Geometry, resampling and plane-sweep ops (PyTorch, NCHW where an op has channels, unless a docstring says otherwise)."""
