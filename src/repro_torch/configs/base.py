"""Model, shape and run configuration: the port's own copy of
``repro.configs.base``, field for field.

``fsdp`` and ``zero1`` act over more than one rank, as in the JAX
package: ``fsdp`` is what a launcher passes to ``ShardingRules(mesh,
fsdp=cfg.fsdp)`` (the train step follows the rules: FSDP leaves stay dp
slices between steps), and ``zero1`` cuts mu and nu to their ZeRO-1
slices (off: they follow the param spec). On one rank both leave every
leaf whole.

Four fields are kept for equality with the JAX package's configs and are
not acted on by the port; setting them changes nothing:

- ``scan_layers``: the layers run in a Python loop;
- ``param_dtype``: the master weights are always float32 (the JAX package
  reads the field nowhere either);
- ``attn_q_chunk``, ``attn_kv_chunk``: the JAX package's chunked
  attention blocks; the port's flash kernels pick their own tiles, and the
  function computed is the same.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (family-polymorphic superset)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm | vit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # expert hidden dim (0 -> d_ff)
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # -- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0              # N: state dimension per head
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_conv: int = 4               # short causal conv width
    ssm_head_dim: int = 64          # P: SSD head dim
    ssm_groups: int = 1             # B/C groups
    ssm_chunk: int = 256            # SSD chunk length

    # -- hybrid (zamba2) -----------------------------------------------------
    attn_every: int = 0             # shared attention block every k ssm layers

    # -- encoder/decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0            # source frames after the (stubbed) conv

    # -- VLM (llava) ---------------------------------------------------------
    num_patches: int = 0            # precomputed projected patch embeddings

    # -- common --------------------------------------------------------------
    mlp: str = "swiglu"             # swiglu (3 mats) | gelu2 (2 mats)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"    # master weights
    compute_dtype: str = "bfloat16"

    # -- distribution defaults (kept for equality; one device acts on none
    # but remat and microbatches) ---------------------------------------------
    remat: bool = True              # per-layer recompute in the backward
    scan_layers: bool = True
    fsdp: bool = False              # shard params over data axes between uses
    zero1: bool = True              # shard optimizer state over data axes
    microbatches: int = 16          # gradient-accumulation steps for train_4k
    attn_q_chunk: int = 512         # online-softmax q block
    attn_kv_chunk: int = 1024       # online-softmax kv block

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived -------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode (SSM state / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family config for CPU tests (as ``repro``'s)."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            microbatches=1,
            attn_q_chunk=16,
            attn_kv_chunk=32,
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=1, num_layers=2)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=32)
        if self.num_patches:
            kw.update(num_patches=8)
        kw.update(over)
        return replace(self, **kw)

    # Parameter counting (analytic, metadata only) ---------------------------
    def param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; else the documented skip."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention family: 500k-token decode KV cache is "
                       "outside the architecture family's operating envelope "
                       "(see docs/ARCHITECTURE.md, models); run only for ssm/hybrid")
    return True, ""


@dataclass(frozen=True)
class RunConfig:
    """One (arch, shape) cell: ``resolve`` gives the config with its
    overrides and the shape. ``multi_pod`` and ``remat_policy`` are kept
    for equality only: the dry run (`repro_torch.launch.dryrun`) takes
    its mesh as an argument, and the port's remat is per layer, full."""
    arch: str
    shape: str
    multi_pod: bool = False
    microbatches: Optional[int] = None    # override config default
    fsdp: Optional[bool] = None
    zero1: Optional[bool] = None
    remat_policy: str = "full"            # full | dots | none

    def resolve(self) -> tuple[ModelConfig, ShapeConfig]:
        import repro_torch.configs as C
        cfg = C.get(self.arch)
        over = {}
        if self.microbatches is not None:
            over["microbatches"] = self.microbatches
        if self.fsdp is not None:
            over["fsdp"] = self.fsdp
        if self.zero1 is not None:
            over["zero1"] = self.zero1
        if over:
            cfg = replace(cfg, **over)
        return cfg, SHAPES[self.shape]
