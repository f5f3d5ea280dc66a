"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone transformer only (per assignment); the vision frontend is a stub:
``input_specs()`` provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # (temporal, height, width) rotary sections
    frontend="patch",
    notes="M-RoPE backbone; patch-embedding frontend stubbed per assignment",
)
