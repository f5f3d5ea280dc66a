"""The paper's own evaluation model: int8-quantized Llama3-8B (llama.cpp), 8.5 GB.

Used by the MSched benchmarks (Figs. 1, 2, 7, 8) to generate the decode command
stream and ground-truth working sets.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    dtype="int8",  # weight quantization as in the paper's llama.cpp setup
    notes="Paper workload (Fig. 1): int8 Llama3-8B, 8.5 GB working set",
)
