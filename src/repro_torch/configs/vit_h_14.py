"""vit-h-14 (633.5M) — paper Table 1 vision model (benchmark harness).

Modeled as the transformer backbone over precomputed patch embeddings
(the patchify conv is a stub, same policy as the assigned [vlm] entry).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="vit-h-14", family="vlm",
    num_layers=32, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=1000,     # classification head over 1000 classes
    head_dim=80, num_patches=256, microbatches=2,
)
