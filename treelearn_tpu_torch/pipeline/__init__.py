from .ensemble import ensemble, ensemble_named, propagate_by_key, quantize_keys  # noqa: F401
from .hull import HullRaster, get_coords_within_hull, get_coords_within_hull_buffer, get_hull  # noqa: F401
from .inference import get_pointwise_preds  # noqa: F401
from .instances import (  # noqa: F401
    assign_remaining_points_nearest_neighbor,
    get_cluster_means,
    get_instances,
    make_labels_consecutive,
    propagate_preds,
)
from .run import run_treelearn_pipeline, save_treewise  # noqa: F401
from .tiles import SampleGenerator, compute_tile_grid, generate_tiles  # noqa: F401
