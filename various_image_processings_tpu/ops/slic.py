"""SLIC superpixels — implemented in models/slic.py (vectorized k-means over
the superpixel grid); this module re-exports the functional wrapper.

Counterpart of ``superpixel_slic`` (reference: include/cpp/slic.hpp:482).
"""

from __future__ import annotations


def superpixel_slic(image, superpixel_size: int = 30, num_iteration: int = 10,
                    color_scale: float = 20.0, metric: str = "euclidean"):
    """(H, W, 3) u8 BGR → (H, W) int32 superpixel labels.

    metric: "euclidean" (the reference default, L scaled by 2.55),
    "ciede2000" (correct CIEDE2000 — carried by the reference but never
    selectable there), or "ciede2000_ref" (the reference's π-scaled
    variant, twinned for API completeness — core/ciede2000.py).

    Unlike the stencil ops there is no ``impl`` parameter: the device stage
    is a pure-XLA k-means program, and the connectivity stage runs in
    native C++ on the host."""
    from ..models.slic import SuperpixelSLIC
    h, w = image.shape[0], image.shape[1]
    slic = SuperpixelSLIC(h, w, superpixel_size, num_iteration, color_scale,
                          metric)
    return slic.apply(image)
