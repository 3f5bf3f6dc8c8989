"""llama2-7b — paper Table 1 model (benchmark harness; 2PP x 6DP in paper)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000, head_dim=128, microbatches=8,
)
