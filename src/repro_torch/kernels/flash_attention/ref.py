"""Plain PyTorch version of flash attention (copy of the JAX package's
``flash_attention/ref.py``): exact attention with causal/window masks + GQA;
its plain backward, the gradient the reference's training step takes of
its plain attention; and the rows' softmax statistics that the CUDA forward
writes for its backward."""
import math

import torch

LOG2E = 1.4426950408889634


def _masked_scores(q, k, causal, window, sm_scale):
    """The scaled scores (B, Hkv, g, Sq, Skv) in f32, masked keys at -1e30."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, g, d)
    kf = k.float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qf * sm_scale, kf)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask[None, None, None], s, torch.tensor(-1e30, device=q.device))


def attention_ref(q, k, v, causal=True, window=0, sm_scale=None):
    b, sq, h, d = q.shape
    s = _masked_scores(q, k, causal, window, sm_scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_ref_lse(q, k, causal=True, window=0, sm_scale=None):
    """Each row's softmax statistic as the CUDA forward writes it for the
    backward (``csrc/flash_attention_wgmma.cuh``): log2 of the sum over the
    row's keys of exp(scaled score), i.e. log2(e) times the logsumexp of
    :func:`attention_ref`'s masked scores; f32, (B, H, Sq)."""
    b, sq, h, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window, sm_scale), dim=-1) * LOG2E
    return lse.reshape(b, h, sq)


def attention_ref_backward(q, k, v, do, causal=True, window=0, sm_scale=None):
    """Plain backward of :func:`attention_ref`: (dq, dk, dv) for the output
    gradient ``do``, by autograd through its f32 arithmetic, each cast to its
    input's dtype. The masked scores are constants there (``torch.where``), so
    no gradient reaches them."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention_ref(qf, kf, vf, causal=causal, window=window, sm_scale=sm_scale)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
