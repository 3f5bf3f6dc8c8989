"""gpt2-1.5b — paper Table 1 model (benchmark harness)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-1.5b", family="dense",
    num_layers=48, d_model=1600, num_heads=25, num_kv_heads=25,
    d_ff=6400, vocab_size=50257, head_dim=64, microbatches=4,
)
