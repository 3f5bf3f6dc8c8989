from repro_torch.optim.functional import (  # noqa: F401
    OptimizerConfig, TrainState, UPDATE_FNS, UPDATE_FNS_FLAT, adam_leaf,
    adamw_leaf, apply_updates, global_norm, init_state, sgd_leaf)
