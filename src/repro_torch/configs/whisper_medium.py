"""whisper-medium [audio] — encoder-decoder backbone; conv frontend STUB.

24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]

``input_specs()`` provides precomputed frame embeddings (batch, 1500, d_model)
in place of the log-mel + conv1d frontend, per the assignment note.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_seq=1500,         # frames after the stubbed conv frontend
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    microbatches=8,
)
