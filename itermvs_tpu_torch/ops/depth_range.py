"""Inverse-depth normalization (counterpart of itermvs_tpu/ops/depth_range.py).

All depth state in the model lives in normalized inverse-depth space
`norm(d) = (1/d − 1/d_max) / (1/d_min − 1/d_max) ∈ [0, 1]`, with the
1e-5 epsilon on the forward normalization only (the training loss's).
"""
from __future__ import annotations


def depth_normalization(depth, inverse_depth_min, inverse_depth_max):
    """Depth map → normalized inverse-depth index in [0, 1]."""
    inverse_depth = 1.0 / (depth + 1e-5)
    return (inverse_depth - inverse_depth_max) / (inverse_depth_min - inverse_depth_max)


def depth_unnormalization(normalized_depth, inverse_depth_min, inverse_depth_max):
    """Normalized inverse-depth index → depth map."""
    inverse_depth = inverse_depth_max + normalized_depth * (
        inverse_depth_min - inverse_depth_max
    )
    return 1.0 / inverse_depth
