"""Plain PyTorch version of flash attention (copy of the JAX package's
``flash_attention/ref.py``): exact attention with causal/window masks + GQA;
its plain backward, the gradient the reference's training step takes of
its plain attention; and the rows' softmax statistics that the CUDA forward
writes for its backward.

Without positions, query i and key j sit at positions i and j, and a
masked score is the finite sentinel -1e30 (a row that sees no key then
averages V uniformly). With ``q_positions`` (B, Sq) and ``kv_positions``
(B, Skv), integers, the mask is the reference ``attend``'s
(``src/repro/models/common.py``): key t is visible to query s when
``kv_positions[t] >= 0``, causal ``q_positions[s] >= kv_positions[t]``
and, with a window, ``q_positions[s] - kv_positions[t] < window``; and a
row that sees no key gives ``masked_softmax``'s 0: 0 output, a -inf
statistic, zero gradients."""
import math

import torch

LOG2E = 1.4426950408889634


def _index(n, b, device):
    return torch.arange(n, device=device).expand(b, n)


def position_mask(q_positions, kv_positions, causal, window):
    """(B, Sq, Skv) bool: the keys each query sees, by positions."""
    qp, kp = q_positions[:, :, None].long(), kv_positions[:, None, :].long()
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def _scores(q, k, sm_scale):
    """The scaled scores (B, Hkv, g, Sq, Skv) in f32."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, h // hkv, d)
    return torch.einsum("bqkgd,btkd->bkgqt", qf * sm_scale, k.float())


def _masked_scores(q, k, causal, window, sm_scale):
    """The scaled scores (B, Hkv, g, Sq, Skv) in f32, masked keys at -1e30."""
    sq, skv = q.shape[1], k.shape[1]
    s = _scores(q, k, sm_scale)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask[None, None, None], s, torch.tensor(-1e30, device=q.device))


def _positions_probs(q, k, causal, window, sm_scale, q_positions, kv_positions):
    """(probabilities (B, Hkv, g, Sq, Skv) in f32, the mask (B, 1, 1, Sq,
    Skv), the scaled scores) by positions; a row with no visible key has
    probabilities 0."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    qp = q_positions if q_positions is not None else _index(sq, b, q.device)
    kp = kv_positions if kv_positions is not None else _index(skv, b, q.device)
    mask = position_mask(qp, kp, causal, window)[:, None, None]
    s = _scores(q, k, sm_scale)
    m = torch.where(mask, s, -1e30).amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(torch.where(mask, s, -1e30) - m), 0.0)
    total = e.sum(dim=-1, keepdim=True)
    return e / torch.where(total > 0, total, 1.0), mask, s


def _by_positions(q_positions, kv_positions):
    return q_positions is not None or kv_positions is not None


def attention_ref(q, k, v, causal=True, window=0, sm_scale=None, q_positions=None, kv_positions=None):
    b, sq, h, d = q.shape
    if _by_positions(q_positions, kv_positions):
        p = _positions_probs(q, k, causal, window, sm_scale, q_positions, kv_positions)[0]
    else:
        s = _masked_scores(q, k, causal, window, sm_scale)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_ref_lse(q, k, causal=True, window=0, sm_scale=None, q_positions=None, kv_positions=None):
    """Each row's softmax statistic as the CUDA forward writes it for the
    backward (``csrc/flash_attention_wgmma.cuh``): log2 of the sum over the
    row's keys of exp(scaled score), i.e. log2(e) times the logsumexp of
    :func:`attention_ref`'s masked scores; f32, (B, H, Sq). By positions, a
    row that sees no key gets -inf."""
    b, sq, h, _ = q.shape
    if _by_positions(q_positions, kv_positions):
        _, mask, s = _positions_probs(q, k, causal, window, sm_scale, q_positions, kv_positions)
        lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1) * LOG2E
    else:
        lse = torch.logsumexp(_masked_scores(q, k, causal, window, sm_scale), dim=-1) * LOG2E
    return lse.reshape(b, h, sq)


def attention_ref_backward(q, k, v, do, causal=True, window=0, sm_scale=None, q_positions=None,
                           kv_positions=None):
    """Plain backward of :func:`attention_ref`: (dq, dk, dv) for the output
    gradient ``do``, by autograd through its f32 arithmetic, each cast to its
    input's dtype. The masked scores are constants there (``torch.where``), so
    no gradient reaches them; by positions a row that sees no key adds 0."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention_ref(qf, kf, vf, causal=causal, window=window, sm_scale=sm_scale, q_positions=q_positions,
                            kv_positions=kv_positions)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
