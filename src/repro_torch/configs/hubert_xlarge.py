"""hubert-xlarge [audio] — encoder-only, same arch as w2v2. [arXiv:2106.07447; unverified]

Backbone transformer only; the CNN waveform frontend is a stub:
``input_specs()`` provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,  # masked-prediction codebook targets
    head_dim=80,
    causal=False,  # bidirectional encoder
    has_decode=False,  # encoder-only: no autoregressive decode step
    frontend="frames",
    notes="Encoder-only (w2v2 arch); MHA; masked-frame prediction objective",
)
