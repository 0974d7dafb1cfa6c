from .las import LasData, read_las, write_las  # noqa: F401
from .pointcloud import (  # noqa: F401
    INSTANCE_LABEL_IGNORE_IN_RAW_DATA,
    NON_TREE_CLASS_IN_RAW_DATA,
    load_data,
    save_data,
)
