"""llava-next-mistral-7b [vlm] — anyres tiling frontend STUB + mistral backbone.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

``input_specs()`` provides precomputed, projected patch embeddings
(batch, num_patches, d_model); the CLIP tower + anyres tiler are stubbed.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    num_patches=576,          # one base-resolution tile worth of patches
    microbatches=8,
)
