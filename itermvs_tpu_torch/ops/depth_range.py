"""Inverse-depth normalization (counterpart of itermvs_tpu/ops/depth_range.py).

All depth state in the model lives in normalized inverse-depth space
`norm(d) = (1/d − 1/d_max) / (1/d_min − 1/d_max) ∈ [0, 1]`. Inference
needs only the way back (the forward normalization serves the
training loss, not ported yet).
"""
from __future__ import annotations


def depth_unnormalization(normalized_depth, inverse_depth_min, inverse_depth_max):
    """Normalized inverse-depth index → depth map."""
    inverse_depth = inverse_depth_max + normalized_depth * (
        inverse_depth_min - inverse_depth_max
    )
    return 1.0 / inverse_depth
