"""Plain PyTorch versions of the weight-streaming matmuls (copies of the JAX
package's ``streammm/ref.py``): f32 product, cast to ``out_dtype``."""
import torch


def stream_matmul_ref(x, w, out_dtype=torch.bfloat16, w_layout="kn", rows=None):
    """``x @ w`` for w (K, N), or ``x @ w.T`` for w (N, K) with ``w_layout="nk"``.

    Expert-batched, x (E, C, K) and w (E, K, N): ``x[e] @ w[e]`` for every
    expert, the reference's ``einsum("ecd,edf->ecf")``; with ``rows`` (E,),
    rows at or past ``rows[e]`` (clamped to [0, C]) come out exactly 0,
    whatever x holds there."""
    if w_layout not in ("kn", "nk"):
        raise ValueError(f"stream_matmul_ref: w_layout {w_layout!r}")
    if x.dim() == 3:
        out = torch.bmm(x.float(), w.float())
        if rows is not None:
            live = torch.arange(x.shape[1], device=x.device) < rows.to(x.device).long()[:, None]
            out = torch.where(live[..., None], out, 0.0)
        return out.to(out_dtype)
    wf = w.float()
    return (x.float() @ (wf.T if w_layout == "nk" else wf)).to(out_dtype)


def stream_matmul_int8_ref(x, w_q, scales, block_k, out_dtype=torch.bfloat16):
    """``x @ (w_q * scale)``: int8 (K, N) weights dequantised to f32 by the
    scale of their (k-group of ``block_k`` rows, column), ``scales`` (K /
    block_k, N) f32."""
    wf = w_q.float() * scales.repeat_interleave(block_k, 0)
    return (x.float() @ wf).to(out_dtype)
