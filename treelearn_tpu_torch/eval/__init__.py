"""Evaluation helpers (the part of treelearn_tpu/eval that validation
needs)."""

from .evaluation import get_eval_components  # noqa: F401
