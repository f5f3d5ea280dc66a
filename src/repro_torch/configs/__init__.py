"""Architecture registry: the 10 assigned architectures + the paper's Llama3-8B."""
from __future__ import annotations

from repro_torch.configs.base import (
    FAMILIES,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    ShapeSpec,
    SSMConfig,
    SHAPES,
    SHAPE_ORDER,
    cell_applicable,
)

from repro_torch.configs import (  # noqa: E402
    grok1_314b,
    arctic_480b,
    qwen3_1p7b,
    qwen15_110b,
    llama32_3b,
    minicpm_2b,
    qwen2_vl_7b,
    recurrentgemma_9b,
    mamba2_1p3b,
    hubert_xlarge,
    paper_llama3_8b,
)

ARCHS = {
    "grok-1-314b": grok1_314b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "qwen3-1.7b": qwen3_1p7b.CONFIG,
    "qwen1.5-110b": qwen15_110b.CONFIG,
    "llama3.2-3b": llama32_3b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "mamba2-1.3b": mamba2_1p3b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    # the paper's own evaluation model (llama.cpp int8 Llama3-8B)
    "paper-llama3-8b": paper_llama3_8b.CONFIG,
}

ASSIGNED = tuple(k for k in ARCHS if k != "paper-llama3-8b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return list(ARCHS)


__all__ = [
    "ARCHS",
    "ASSIGNED",
    "FAMILIES",
    "ModelConfig",
    "MoEConfig",
    "RGLRUConfig",
    "SSMConfig",
    "ShapeSpec",
    "SHAPES",
    "SHAPE_ORDER",
    "cell_applicable",
    "get_config",
    "list_archs",
]
