from .mlp import (  # noqa: F401
    MLP,
    NetConfig,
    config_for_game,
    init_numpy,
    params_from_jax,
)
