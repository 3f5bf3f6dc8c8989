"""Family registry, the port of ``repro.models.registry``: param specs,
counts, init and loss of all seven families, and the serving entry points
(cache specs, an empty cache, prefill and decode) of the six that serve.

Prefill and decode run under ``torch.inference_mode``. ``vit`` has no
serving path, as in the JAX package: asking it for one raises
``AttributeError``, as the reference's missing functions do. Under
``rules`` whose ``model`` extent is above 1, every family trains, and
each of the six that serve serves, over ``model`` (`TENSOR_PARALLEL`
holds all seven) from this rank's slices of the params
(`serving_shardings`; the FSDP leaves' ``wemb`` slices gathered where
they are read: a stacked one a layer at a time, any other once a call)
and its cut of the cache, as the cache specs cut it: positions on
``kv_seq`` (the attention caches), the SSD heads and the x conv's
columns on ``ssm_inner``, whisper's cross-attention k and v on
``heads``; its logits are this rank's vocab columns where the vocab is
cut (`greedy_token` takes the argmax). With no rules or ``model`` of
extent 1, every family serves each layer whole.

``abstract_params``, ``abstract_cache`` and ``input_specs`` are the
stand-ins the dry run (`repro_torch.launch.dryrun`) traces a step on, the
port of the reference's ``ShapeDtypeStruct`` ones: tensors on the
``meta`` device (a shape and a dtype, no data) at the shape this rank
holds under ``rules`` (``rules.sharding(...).local_shape``: dims mapped to
dp axes cut, and ``model``-mapped dims of the leaves and caches of a
tensor-parallel family, as the port's layers compute them). Three
differences from the reference's: integer inputs are int64, the port's
index type (the reference's are int32); a cache's ``length`` is the host
int the port's decode reads, set to the last position so that one decode
step fits (the reference's is an int32 scalar); and a cache with
positions (a ``kv_seq`` dim) served over ``model`` keeps ``max_seq``, a
host int.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.device import resolve
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import fsdp_gather, gather_per_layer
from repro_torch.models import common
from repro_torch.models.transformer import vocab_tp

_FAMILIES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.ssm",
    "hybrid": "repro_torch.models.hybrid",
    "audio": "repro_torch.models.encdec",
    "vlm": "repro_torch.models.vlm",
    "vit": "repro_torch.models.vit",
}


# the families whose layers run tensor-parallel over ``model`` in training
# and serving (`repro_torch.dist.tensor_parallel`; moe's experts cut over
# it too, the SSM's ``ssm_inner``): all seven. A family outside the set
# would compute each layer whole on every rank of a model group.
TENSOR_PARALLEL = frozenset(_FAMILIES)


def tensor_parallel(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s steps cut its leaves over ``model``."""
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
    """The loss of this rank's rows. ``rules`` reach a tensor-parallel
    family (its layers over ``model``; moe's token groups are the dp
    ranks' too); a family outside `TENSOR_PARALLEL` computes each row on
    its own, the same on any mesh."""
    if tensor_parallel(cfg):
        return family_module(cfg).loss_fn(params, cfg, batch, rules=rules)
    return family_module(cfg).loss_fn(params, cfg, batch)


def abstract_params(cfg: ModelConfig, rules) -> dict:
    """Every param leaf as a meta tensor of its dtype at this rank's local
    shape under ``rules``, for training and serving alike: cut over
    ``model`` for a tensor-parallel family (whole over it for a family
    outside `TENSOR_PARALLEL`)."""
    return _abstract(param_specs(cfg), rules, model=tensor_parallel(cfg))


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


def serving_tp(cfg: ModelConfig, rules):
    """The `tensor_parallel.ModelParallel` ``cfg``'s serving runs under
    ``rules`` (the family's ``tp_context``): None for a family that
    serves each layer whole, and where there are no rules or ``model``
    has extent 1."""
    if rules is None or not tensor_parallel(cfg):
        return None
    return family_module(cfg).tp_context(cfg, rules)


def serving_shardings(cfg: ModelConfig, rules):
    """``{name: NamedSharding}`` of the params ``cfg``'s serving reads
    under ``rules`` (cut over ``model`` as the specs cut them, and a
    ``wemb`` dim over the dp axes under FSDP), or None where serving
    holds every leaf whole (`serving_tp` None)."""
    if serving_tp(cfg, rules) is None:
        return None
    return {k: rules.sharding(*ps.logical, dims=ps.shape)
            for k, ps in param_specs(cfg).items()}


def _cache_meta(cache: dict, specs: dict, cfg: ModelConfig, rules,
                max_seq: int):
    """``cache`` with ``max_seq`` where it is served over ``model`` and
    has positions (a ``kv_seq`` dim in its ``specs``: the SSM's state has
    none)."""
    if serving_tp(cfg, rules) is not None and any(
            "kv_seq" in ps.logical for ps in specs.values()):
        cache["max_seq"] = max_seq
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None, rules=None) -> dict:
    """An empty cache of ``batch`` rows: every leaf zero, ``length`` 0;
    under ``rules``, this rank's rows and, over ``model``, its cut
    (`abstract_cache`'s shapes)."""
    device = resolve(device)
    specs = cache_specs(cfg, batch, max_seq)
    shapes = {k: spec.shape for k, spec in specs.items()}
    if rules is not None:
        shapes = {k: t.shape for k, t in _abstract(
            specs, rules, model=tensor_parallel(cfg)).items()}
    cache = {name: torch.zeros(shapes[name], dtype=TORCH_DTYPES[spec.dtype],
                               device=device)
             for name, spec in specs.items()}
    cache["length"] = 0
    return _cache_meta(cache, specs, cfg, rules, max_seq)


def abstract_cache(cfg: ModelConfig, rules, batch: int,
                   max_seq: int) -> dict:
    """The cache of ``batch`` rows and ``max_seq`` positions as meta
    tensors at this rank's local shapes (a tensor-parallel family's cut
    over ``model`` where the spec cuts it: ``kv_seq``, ``ssm_inner``,
    ``heads``); ``length`` is ``max_seq - 1``, so the one decode step
    writes the last position, which the last model rank holds."""
    specs = cache_specs(cfg, batch, max_seq)
    cache = _abstract(specs, rules, model=tensor_parallel(cfg))
    cache["length"] = max_seq - 1
    return _cache_meta(cache, specs, cfg, rules, max_seq)


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


@contextlib.contextmanager
def _serving_tree(params: dict, cfg: ModelConfig, rules):
    """The params as ``cfg``'s serving reads them under ``rules``, and
    the keyword that hands a tensor-parallel family its rules: an FSDP
    leaf outside the layer stacks gathered here in the compute dtype, a
    stacked one a layer at a time within (`gather_per_layer`)."""
    shardings = serving_shardings(cfg, rules)
    if shardings is None:
        yield params, ({"rules": rules} if tensor_parallel(cfg) else {})
        return
    cd = TORCH_DTYPES[cfg.compute_dtype]
    specs = param_specs(cfg)
    tree, per_layer = dict(params), []
    for k, sh in shardings.items():
        if sh.n == 1:
            continue
        if specs[k].logical[:1] == ("layers",):
            per_layer.append((params[k], sh))
        else:
            tree[k] = fsdp_gather(params[k], sh, sh.dim, cd)
    with gather_per_layer(per_layer, cd):
        yield tree, {"rules": rules}


@torch.inference_mode()
def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            rules=None, **extra):
    """(cache, logits of the last position (b, 1, vocab)); ``extra`` is
    ``frames`` (audio) or ``patch_embeds`` (vlm). Over ``model`` (the
    module docstring) ``params`` are this rank's slices, the cache is its
    block and the logits its vocab columns."""
    with _serving_tree(params, cfg, rules) as (tree, kw):
        return _serving(cfg, "prefill")(tree, cfg, tokens, max_seq, **extra,
                                        **kw)


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    """(logits (b, 1, vocab), cache advanced by one position); the cache's
    tensors are updated in place."""
    with _serving_tree(params, cfg, rules) as (tree, kw):
        return _serving(cfg, "decode_step")(tree, cfg, cache, token, **kw)


def greedy_token(cfg: ModelConfig, logits, rules=None):
    """The greedy next token (b, 1) of the last position of ``logits``
    that `prefill` or `decode_step` gave under ``rules``: the first
    maximum over the whole vocab, as ``jnp.argmax`` takes it."""
    return TP.vocab_argmax(logits[:, -1],
                           vocab_tp(serving_tp(cfg, rules)))[:, None]
