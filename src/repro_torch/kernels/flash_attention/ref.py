"""Plain PyTorch version of flash attention (copy of the JAX package's
``flash_attention/ref.py``): exact attention with causal/window masks + GQA."""
import math

import torch


def attention_ref(q, k, v, causal=True, window=0, sm_scale=None):
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, g, d)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qf * sm_scale, kf)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask[None, None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, vf)
    return o.reshape(b, sq, h, d).to(q.dtype)
