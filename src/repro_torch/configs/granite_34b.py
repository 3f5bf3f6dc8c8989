"""granite-34b [dense] — llama-arch code model, MQA.

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu2",          # GPT-BigCode-style 2-matrix MLP
    fsdp=True,            # 34B params: shard weights over data axes too
    microbatches=8,
)
