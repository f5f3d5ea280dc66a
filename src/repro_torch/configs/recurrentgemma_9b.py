"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2. [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rglru=RGLRUConfig(window=2048, pattern=("rec", "rec", "attn")),
    sub_quadratic=True,  # recurrence + sliding-window attention
    notes="Griffin-style: 2 RG-LRU blocks : 1 local-attention block; MQA kv=1",
)
