"""Moving state between the JAX package and the port as numpy arrays.

``state_from_numpy`` takes a JAX ``TrainState``'s leaves (``np.asarray`` of
each) and returns the port's state; the tests carry the JAX package's
``init_params`` into the port this way, so both start from the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.optim.functional import TrainState


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A copy of a numpy array (including ml_dtypes' bfloat16) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bfloat16 widened to float32)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def state_from_numpy(params: dict, mu: dict, nu: dict, step: int,
                     device=None) -> TrainState:
    device = resolve(device)
    return TrainState(params={k: to_tensor(v, device) for k, v in params.items()},
                      mu={k: to_tensor(v, device) for k, v in mu.items()},
                      nu={k: to_tensor(v, device) for k, v in nu.items()},
                      step=int(step))
