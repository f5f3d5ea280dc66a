"""mamba2-1.3b [ssm] — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    d_ff=0,  # no MLP; the mamba block is the whole layer
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2, chunk=256),
    sub_quadratic=True,  # O(1) decode state
    notes="SSD chunked algorithm; attention-free; constant-size decode state",
)
