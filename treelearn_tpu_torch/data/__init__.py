from .dataset import (  # noqa: F401
    NON_TREE_CLASS_IN_DATASET,
    TREE_CLASS_IN_DATASET,
    TreeDataset,
    TreeLoader,
    collate_padded,
    get_offset_labels,
    semantic_from_instance,
)
from .synthetic import make_crop_npz, make_synthetic_forest, verticality_proxy  # noqa: F401
