from .hashing import SENTINEL, decode_keys, encode_keys, lookup, sort_unique  # noqa: F401
from .sparse import (  # noqa: F401
    DownsampleRulebook,
    SparseGrid,
    build_downsample,
    build_subm_rulebook,
    down_conv,
    grid_from_sorted_keys,
    inverse_conv,
    kernel_offsets,
)
from .voxelize import VoxelizedBatch, devoxelize, voxel_downsample_trace_np, voxelize_points  # noqa: F401
from .rulebook import subm_rulebook  # noqa: F401
