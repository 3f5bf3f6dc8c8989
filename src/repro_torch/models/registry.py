"""Family registry, the port of ``repro.models.registry``: param specs,
counts, init and loss of all seven families, and the serving entry points
(cache specs, an empty cache, prefill and decode) of the six that serve.

Prefill and decode run under ``torch.inference_mode``. ``vit`` has no
serving path, as in the JAX package: asking it for one raises
``AttributeError``, as the reference's missing functions do.

``abstract_params``, ``abstract_cache`` and ``input_specs`` are the
stand-ins the dry run (`repro_torch.launch.dryrun`) traces a step on, the
port of the reference's ``ShapeDtypeStruct`` ones: tensors on the
``meta`` device (a shape and a dtype, no data) at the shape this rank
holds under ``rules`` (``rules.sharding(...).local_shape``: dims mapped to
dp axes cut; ``model``-mapped dims cut for the training leaves of a
tensor-parallel family (`TENSOR_PARALLEL`), whole for every other family
and for serving, as the port's layers compute them). Two differences from the reference's: integer inputs are int64,
the port's index type (the reference's are int32), and a cache's
``length`` is the host int the port's decode reads, set to the last
position so that one decode step fits (the reference's is an int32
scalar).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.device import resolve
from repro_torch.models import common

_FAMILIES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.ssm",
    "hybrid": "repro_torch.models.hybrid",
    "audio": "repro_torch.models.encdec",
    "vlm": "repro_torch.models.vlm",
    "vit": "repro_torch.models.vit",
}


# the families whose training layers run tensor-parallel over ``model``
# (`repro_torch.dist.tensor_parallel`); every other family, and serving,
# computes each layer whole on every rank of a model group
TENSOR_PARALLEL = frozenset({"dense", "vlm"})


def tensor_parallel(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s training step cuts its leaves over ``model``."""
    return cfg.family in TENSOR_PARALLEL


def family_module(cfg: ModelConfig):
    return importlib.import_module(_FAMILIES[cfg.family])


def param_specs(cfg: ModelConfig) -> dict:
    return family_module(cfg).param_specs(cfg)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    return common.spec_param_count(
        param_specs(cfg), active_only=active_only,
        top_k=cfg.top_k, num_experts=cfg.num_experts)


def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    return common.init_params(param_specs(cfg), seed, device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The loss of this rank's rows. ``rules`` reach the MoE family (its
    token groups are the dp ranks') and the tensor-parallel ones (their
    layers over ``model``); every other family computes each row on its
    own, the same on any mesh."""
    if cfg.family == "moe" or tensor_parallel(cfg):
        return family_module(cfg).loss_fn(params, cfg, batch, rules=rules)
    return family_module(cfg).loss_fn(params, cfg, batch)


def abstract_params(cfg: ModelConfig, rules, serving: bool = False) -> dict:
    """Every param leaf as a meta tensor of its dtype at this rank's local
    shape under ``rules``: cut over ``model`` for training a
    tensor-parallel family, whole over it for ``serving``."""
    return _abstract(param_specs(cfg), rules,
                     model=tensor_parallel(cfg) and not serving)


def _abstract(specs: dict, rules, model: bool) -> dict:
    # sorted leaf order, as `init_params` draws them
    return {name: _meta(rules.sharding(*specs[name].logical,
                                       dims=specs[name].shape, model=model),
                        specs[name].shape, TORCH_DTYPES[specs[name].dtype])
            for name in sorted(specs)}


def _meta(sharding, shape, dtype) -> torch.Tensor:
    return torch.empty(sharding.local_shape(shape), dtype=dtype,
                       device="meta")


def _serving(cfg: ModelConfig, name: str):
    fn = getattr(family_module(cfg), name, None)
    if fn is None:
        raise AttributeError(f"family {cfg.family!r} has no {name} (no "
                             f"serving path, as in the JAX package)")
    return fn


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return _serving(cfg, "cache_specs")(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """An empty cache: every leaf zero, ``length`` 0."""
    device = resolve(device)
    cache = {name: torch.zeros(spec.shape, dtype=TORCH_DTYPES[spec.dtype],
                               device=device)
             for name, spec in cache_specs(cfg, batch, max_seq).items()}
    cache["length"] = 0
    return cache


def abstract_cache(cfg: ModelConfig, rules, batch: int,
                   max_seq: int) -> dict:
    """The cache of ``batch`` rows and ``max_seq`` positions as meta
    tensors at this rank's local shapes; ``length`` is ``max_seq - 1``."""
    cache = _abstract(cache_specs(cfg, batch, max_seq), rules, model=False)
    cache["length"] = max_seq - 1
    return cache


def _tokens(rules, shape) -> torch.Tensor:
    return _meta(rules.sharding("batch", *([None] * (len(shape) - 1)),
                                dims=shape), shape, torch.int64)


def _embeds(rules, shape, dtype) -> torch.Tensor:
    return _meta(rules.sharding("batch", None, None, dims=shape), shape,
                 dtype)


def input_specs(cfg: ModelConfig, shape, rules) -> dict:
    """Model inputs of one (arch x shape) cell as meta tensors, batch rows
    cut over the dp ranks: train -> the step's batch {tokens, labels, ...};
    prefill -> {tokens, ...}; decode -> {token} (the cache comes from
    `abstract_cache`). Audio adds ``frames``, vlm ``patch_embeds`` before
    ``s - num_patches`` text tokens, vit patch embeddings and one label a
    row, in the compute dtype, as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    cd = TORCH_DTYPES[cfg.compute_dtype]
    if shape.kind == "train":
        if cfg.family == "audio":
            return {"frames": _embeds(rules, (b, cfg.encoder_seq,
                                              cfg.d_model), cd),
                    "tokens": _tokens(rules, (b, s)),
                    "labels": _tokens(rules, (b, s))}
        if cfg.family == "vlm":
            s_text = s - cfg.num_patches
            return {"patch_embeds": _embeds(rules, (b, cfg.num_patches,
                                                    cfg.d_model), cd),
                    "tokens": _tokens(rules, (b, s_text)),
                    "labels": _tokens(rules, (b, s_text))}
        if cfg.family == "vit":
            return {"patch_embeds": _embeds(rules, (b, cfg.num_patches,
                                                    cfg.d_model), cd),
                    "labels": _tokens(rules, (b, 1))}
        return {"tokens": _tokens(rules, (b, s)),
                "labels": _tokens(rules, (b, s))}
    if shape.kind == "prefill":
        out = {"tokens": _tokens(rules, (b, s))}
        if cfg.family == "audio":
            out["frames"] = _embeds(rules, (b, cfg.encoder_seq, cfg.d_model),
                                    cd)
        if cfg.family == "vlm":
            out["tokens"] = _tokens(rules, (b, s - cfg.num_patches))
            out["patch_embeds"] = _embeds(
                rules, (b, cfg.num_patches, cfg.d_model), cd)
        return out
    return {"token": _tokens(rules, (b, 1))}


@torch.inference_mode()
def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int, **extra):
    """(cache, logits of the last position (b, 1, vocab)); ``extra`` is
    ``frames`` (audio) or ``patch_embeds`` (vlm)."""
    return _serving(cfg, "prefill")(params, cfg, tokens, max_seq, **extra)


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, cache: dict, token):
    """(logits (b, 1, vocab), cache advanced by one position); the cache's
    tensors are updated in place."""
    return _serving(cfg, "decode_step")(params, cfg, cache, token)
