from .network import TreeLearn, build_level_plans  # noqa: F401
from .checkpoint import (  # noqa: F401
    jax_numpy_from_state_dict,
    load_checkpoint,
    params_from_jax_numpy,
)
