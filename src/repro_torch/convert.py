"""Moving state between the JAX package and the port as numpy arrays.

``state_from_numpy`` takes a JAX ``TrainState``'s leaves (``np.asarray`` of
each) and returns the port's state; the tests carry the JAX package's
``init_params`` into the port this way, so both start from the same
weights. ``cache_from_numpy`` and ``cache_to_numpy`` move a serving
cache (numpy leaves, ``length`` an int) between the two, so decode can be
held against the reference from the same cache.
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


def cache_from_numpy(cache: dict, device=None) -> dict:
    """A JAX serving cache (array leaves, ``length`` a scalar) as the
    port's: tensors on ``device`` and ``length`` a host int."""
    device = resolve(device)
    return {k: int(v) if k == "length" else to_tensor(v, device)
            for k, v in cache.items()}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as numpy (bfloat16 widened to float32), with
    ``length`` an ``np.int32`` as the JAX package keeps it."""
    return {k: np.int32(v) if k == "length" else to_numpy(v)
            for k, v in cache.items()}
