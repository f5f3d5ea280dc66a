"""Plain PyTorch version of paged-KV decode attention (copy of the JAX
package's ``paged_attention/ref.py``): gather the pages, run exact masked
attention. One change: a row with ``lengths <= 0`` returns zeros, as the
Pallas kernel does (it walks no page and divides by ``max(l, 1e-30)``),
where the JAX reference returns the mean of V over the table's slots. With
``return_lse`` it also returns the log-sum-exp of the scaled scores over
the valid slots, (B, H) f32, -inf for such a row."""
import math

import torch


def paged_attention_ref(q, pool_k, pool_v, page_table, lengths, sm_scale=None, return_lse=False):
    b, h, d = q.shape
    n_pages, pt, hkv, _ = pool_k.shape
    g = h // hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    max_pages = page_table.shape[1]
    table = page_table.long()
    k = pool_k[table].reshape(b, max_pages * pt, hkv, d).float()  # (b, max_pages*pt, hkv, d)
    v = pool_v[table].reshape(b, max_pages * pt, hkv, d).float()
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qf * sm_scale, k)
    pos = torch.arange(max_pages * pt, device=q.device)[None, None, None, :]
    lens = lengths.to(q.device)[:, None, None, None]
    s = torch.where(pos < lens, s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    o = torch.where(lens > 0, o, torch.zeros((), device=q.device))
    o = o.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(lens[..., 0] > 0, torch.logsumexp(s, dim=-1), float("-inf"))
    return o, lse.reshape(b, h)
