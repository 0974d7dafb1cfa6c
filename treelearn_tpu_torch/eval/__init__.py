"""Evaluation protocol: detection and segmentation metrics (port of
treelearn_tpu/eval; partition tables are column dicts, not DataFrames)."""

from .evaluation import (  # noqa: F401
    contingency_matrices,
    detection_summary,
    evaluate_instance_segmentation,
    evaluate_no_partition,
    evaluate_xy_partition,
    evaluate_z_partition,
    get_detection_failures,
    get_detections,
    get_eval_components,
    get_segmentation_metrics,
)
