"""gpt3-xl (1.3B) — paper Table 1 model (benchmark harness)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-xl", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50257, head_dim=128, microbatches=4,
)
