"""Wexler exemplar-based inpainting — implemented in models/inpainting.py
(coarse-to-fine pyramid with conv-batched patch search); this module re-exports
the functional wrapper.

Counterpart of ``inpainting_wexler`` (reference:
include/cpp/wexler_inpainting.hpp:336).
"""

from __future__ import annotations


def inpainting_wexler(src, mask, **kwargs):
    """(H, W, 3) u8 image + (H, W) u8 mask (hole > 0) → (H, W, 3) u8 inpainted."""
    from ..models.inpainting import WexlerInpainting
    return WexlerInpainting(**kwargs).apply(src, mask)
