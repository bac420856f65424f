"""Golden scalar references.

Pure NumPy implementations that reproduce the reference C++ CPU layer's
arithmetic exactly (same f32 accumulation order, same LUT contents, same u8
truncation), playing the role the hand-written scalar references play in the
reference's test suite (e.g. test/adaptive_bilateral_filter.cu:7-119).  They
are the oracles the device (XLA / Pallas) paths are parity-tested against.
"""

from .gradient import gradient as gradient
from .bilateral import bilateral_filter as bilateral_filter
from .bilateral import joint_bilateral_filter as joint_bilateral_filter
from .adaptive_bilateral import adaptive_bilateral_filter as adaptive_bilateral_filter
from .integral_image import BorderReplicatedIntegralImage as BorderReplicatedIntegralImage
from .bilateral_texture import compute_blur_and_rtv as compute_blur_and_rtv
from .bilateral_texture import compute_guide as compute_guide
from .bilateral_texture import bilateral_texture_filter as bilateral_texture_filter
from .ciede2000_ref import ciede2000_ref_square as ciede2000_ref_square
