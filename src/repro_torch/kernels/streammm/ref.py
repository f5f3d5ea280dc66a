"""Plain PyTorch versions of the weight-streaming matmuls (copies of the JAX
package's ``streammm/ref.py``): f32 product, cast to ``out_dtype``."""
import torch


def stream_matmul_ref(x, w, out_dtype=torch.bfloat16, w_layout="kn", rows=None, x_layout="mk"):
    """``x @ w`` for w (K, N), ``x @ w.T`` for w (N, K) with ``w_layout="nk"``,
    or ``x.T @ w`` for x (K, M) with ``x_layout="km"``.

    Expert-batched, x and w stacked on a leading E: the same product for
    every expert (``x[e] @ w[e]`` is the reference's ``einsum("ecd,edf->ecf")``).
    With ``rows`` (E,) (clamped to [0, C], C the axis 1 of x): rows at or past
    ``rows[e]`` of the output come out exactly 0, whatever x holds there; with
    ``x_layout="km"`` the rows of x and w at or past ``rows[e]`` are left out
    of the sum, whatever they hold."""
    if w_layout not in ("kn", "nk") or x_layout not in ("mk", "km"):
        raise ValueError(f"stream_matmul_ref: w_layout {w_layout!r}, x_layout {x_layout!r}")
    xf, wf = x.float(), w.float()
    live = None
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device) < rows.to(x.device).long()[:, None])[..., None]
    if x_layout == "km":
        if live is not None:
            xf, wf = torch.where(live, xf, 0.0), torch.where(live, wf, 0.0)
        xf = xf.transpose(-1, -2)
    if w_layout == "nk":
        wf = wf.transpose(-1, -2)
    out = torch.bmm(xf, wf) if x.dim() == 3 else xf @ wf
    if live is not None and x_layout == "mk":
        out = torch.where(live, out, 0.0)
    return out.to(out_dtype)


def stream_matmul_batched_grads_ref(x, w, dy, rows=None):
    """The gradients of the expert-batched ``y = stream_matmul_ref(x, w,
    rows=rows)``, x (E, C, K), w (E, K, N), dy (E, C, N): dX[e] = dY[e] @
    W[e]^T with rows at or past ``rows[e]`` exactly 0, and dW[e] = X[e]^T @
    dY[e] over the filled rows only; f32 products, in x's and w's dtypes."""
    dy = dy.to(x.dtype)
    return (stream_matmul_ref(dy, w, x.dtype, "nk", rows),
            stream_matmul_ref(x, dy, w.dtype, "kn", rows, "km"))


def stream_matmul_int8_ref(x, w_q, scales, block_k, out_dtype=torch.bfloat16):
    """``x @ (w_q * scale)``: int8 (K, N) weights dequantised to f32 by the
    scale of their (k-group of ``block_k`` rows, column), ``scales`` (K /
    block_k, N) f32."""
    wf = w_q.float() * scales.repeat_interleave(block_k, 0)
    return (x.float() @ wf).to(out_dtype)
