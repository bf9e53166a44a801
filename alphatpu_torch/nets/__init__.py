from .mlp import (  # noqa: F401
    MLP,
    PARAM_NAMES,
    NetConfig,
    apply_inference,
    config_for_game,
    init_numpy,
    params_from_jax,
    params_to_numpy,
)
