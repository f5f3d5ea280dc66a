"""Model / shape configuration system.

Every assigned architecture is expressed as a frozen ``ModelConfig``, a copy
of the JAX package's configuration so that both packages build the same
shapes. In this package the same config object drives:
  * model construction (``repro_torch.models.model.build_model``) and the
    live runtime's tasks,
  * sharding rules (``repro_torch.sharding.specs``),
  * the dry-run input specs (``repro_torch.launch.specs``),
  * the MSched workload generators (``repro_torch.core.workloads``) — each
    config deterministically yields the command stream + ground-truth
    working sets that the paper's predictor/scheduler operate on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts feed-forward settings."""

    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    dense_residual: bool = False  # Arctic: dense FFN running in parallel
    dense_d_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (state-space duality) settings."""

    state_dim: int = 128
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma (Griffin) RG-LRU + local-attention settings."""

    window: int = 2048
    # Griffin pattern: two recurrent blocks followed by one local-attn block.
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    conv_width: int = 4


# --------------------------------------------------------------------------
# Main config
# --------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    causal: bool = True  # False => bidirectional encoder (hubert)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: Optional[str] = None  # 'patch' (vlm) | 'frames' (audio); stubs
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # substrate defaults
    optimizer: str = "adamw"  # 'adamw' | 'adafactor'
    schedule: str = "cosine"  # 'cosine' | 'wsd'
    remat: bool = True
    # capability flags
    sub_quadratic: bool = False  # can run long_500k
    has_decode: bool = True  # False for encoder-only archs
    notes: str = ""

    # -- derived ----------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim() if self.num_heads else 0
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d  # lm head / output proj
        per_layer = 0
        if self.family == "ssm":
            assert self.ssm is not None
            di = self.ssm.expand * d
            nheads = di // self.ssm.head_dim
            # in_proj -> [z, x, B, C, dt], out_proj
            per_layer += d * (2 * di + 2 * self.ssm.state_dim + nheads)
            per_layer += di * d  # out proj
            per_layer += self.ssm.conv_width * (di + 2 * self.ssm.state_dim)
            per_layer += 3 * nheads  # A_log, D, dt_bias
            per_layer += d  # norm
        else:
            layer_kinds = self.layer_kinds()
            # attention params (per attn layer)
            attn = d * hd * self.num_heads  # q
            attn += 2 * d * hd * self.num_kv_heads  # k, v
            attn += hd * self.num_heads * d  # o
            if self.qkv_bias:
                attn += hd * (self.num_heads + 2 * self.num_kv_heads)
            # mlp params
            if self.moe is not None:
                mlp = self.moe.num_experts * 3 * d * self.moe.d_ff
                mlp += d * self.moe.num_experts  # router
                if self.moe.dense_residual:
                    mlp += 3 * d * self.moe.dense_d_ff
            else:
                mlp = 3 * d * self.d_ff
            rec = 0
            if self.rglru is not None:
                # recurrent block: two input projs, conv, gates, out proj
                rec = 2 * d * d + self.rglru.conv_width * d + 2 * d * d + d * d + 2 * d
            n_attn = sum(1 for k in layer_kinds if k == "attn")
            n_rec = sum(1 for k in layer_kinds if k == "rec")
            per_layer = 0
            total += n_attn * (attn + mlp + 2 * d) + n_rec * (rec + mlp + 2 * d)
            total += d  # final norm
            return total
        total += per_layer * L + d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        inactive_experts = self.moe.num_experts - self.moe.top_k
        per_layer_inactive = inactive_experts * 3 * d * self.moe.d_ff
        return full - per_layer_inactive * self.num_layers

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind: 'attn' | 'rec' | 'ssm'."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.num_layers))
        if self.rglru is not None:
            pat = self.rglru.pattern
            kinds = [pat[i % len(pat)] for i in range(self.num_layers)]
            return tuple(kinds)
        return tuple("attn" for _ in range(self.num_layers))

    # -- smoke-test shrink -------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 3 if self.rglru is not None else 2),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=32 if self.num_heads else None,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            remat=False,
        )
        if self.num_kv_heads == self.num_heads and self.num_heads:
            changes["num_kv_heads"] = 4  # keep MHA archs MHA
        if self.mrope_sections is not None:
            # rescale M-RoPE sections to the reduced head_dim (sum == hd // 2)
            changes["mrope_sections"] = (4, 6, 6)
        if self.moe is not None:
            changes["moe"] = MoEConfig(
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff=128,
                dense_residual=self.moe.dense_residual,
                dense_d_ff=128 if self.moe.dense_residual else 0,
                capacity_factor=2.0,
            )
        if self.ssm is not None:
            changes["ssm"] = SSMConfig(
                state_dim=16, head_dim=16, conv_width=4, expand=2, chunk=32
            )
        if self.rglru is not None:
            changes["rglru"] = RGLRUConfig(
                window=16, pattern=self.rglru.pattern, conv_width=4
            )
        if self.rglru is not None:
            changes["num_layers"] = 3  # one full (rec, rec, attn) pattern
        return dataclasses.replace(self, **changes)


# --------------------------------------------------------------------------
# Input shapes (assigned)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is runnable; else the documented skip reason."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k requires sub-quadratic attention"
    return True, ""
