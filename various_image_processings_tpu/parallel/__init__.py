"""Multi-device layer: batch sharding over device meshes and spatial sharding
with halo exchange. The reference is a single-GPU library; this layer is
the scaling story (SURVEY.md §2: shard_map batch fan-out, ppermute halos
for images larger than one device's memory)."""

from .mesh import make_mesh as make_mesh
from .mesh import BATCH_AXIS as BATCH_AXIS
from .mesh import SPATIAL_AXIS as SPATIAL_AXIS
from .batch import batched_apply as batched_apply
from .batch import bilateral_filter_batched as bilateral_filter_batched
from .batch import bilateral_texture_filter_batched as bilateral_texture_filter_batched
from .batch import adaptive_bilateral_filter_batched as adaptive_bilateral_filter_batched
from .batch import gradient_batched as gradient_batched
from .batch import joint_bilateral_filter_batched as joint_bilateral_filter_batched
from .batch import bilateral_filter_batch_spatial as bilateral_filter_batch_spatial
from .batch import joint_bilateral_filter_batch_spatial as joint_bilateral_filter_batch_spatial
from .batch import superpixel_slic_batched as superpixel_slic_batched
from .batch import inpainting_wexler_batched as inpainting_wexler_batched
from .spatial import halo_exchange_rows as halo_exchange_rows
from .spatial import stencil_apply_sharded as stencil_apply_sharded
from .spatial import bilateral_filter_sharded as bilateral_filter_sharded
from .spatial import adaptive_bilateral_filter_sharded as adaptive_bilateral_filter_sharded
from .spatial import gradient_sharded as gradient_sharded
from .spatial import bilateral_texture_filter_sharded as bilateral_texture_filter_sharded
from .spatial import joint_bilateral_filter_sharded as joint_bilateral_filter_sharded
