"""arctic-480b [moe] — 128 experts top-2 + dense residual branch.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                # dense residual FFN width
    vocab_size=32000,
    head_dim=128,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    fsdp=True,
    microbatches=8,
)
