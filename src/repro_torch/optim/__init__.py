from repro_torch.optim.functional import (  # noqa: F401
    OptimizerConfig, TrainState, apply_updates, global_norm, init_state)
