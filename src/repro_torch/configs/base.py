"""Model configuration: the port's own copy of ``repro.configs.base``'s
``ModelConfig`` (dense fields; the other families come with their ports)."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description."""

    name: str
    family: str                     # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    mlp: str = "swiglu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"

    remat: bool = True              # per-layer recompute in the backward
    microbatches: int = 16          # gradient-accumulation steps

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

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
        )
        kw.update(over)
        return replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self)
