"""gpt3-6.7b — paper Table 1 model (benchmark harness)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-6.7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=16384, vocab_size=50257, head_dim=128, microbatches=8,
)
