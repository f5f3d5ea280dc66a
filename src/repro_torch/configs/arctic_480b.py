"""arctic-480b [moe] — 128 experts top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff=4864,
        dense_residual=True,
        dense_d_ff=4864,
    ),
    optimizer="adafactor",
    notes="Dense-MoE hybrid: residual dense FFN in parallel with 128e top-2 MoE",
)
