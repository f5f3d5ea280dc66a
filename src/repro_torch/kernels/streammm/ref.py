"""Plain PyTorch version of the weight-streaming matmul (copy of the JAX
package's ``streammm/ref.py``): f32 product, cast to ``out_dtype``."""
import torch


def stream_matmul_ref(x, w, out_dtype=torch.bfloat16):
    return (x.float() @ w.float()).to(out_dtype)
