"""Request lifecycle: one served request as a finite GPU task.

``ServedRequestTask`` layers the serving request lifecycle on top of
``LLMDecodeTask`` (llama.cpp-style: one process per session, disjoint address
space — the paper's MultiLLM regime):

  * **prefill** — iteration 0 processes the whole prompt: the attention
    kernel covers the prompt-length KV slice and the weight-bound kernels are
    scaled by the prefill compute factor;
  * **per-request KV allocation** — the KV cache is sized to exactly
    ``prompt_tokens + output_tokens`` (not the model's max context), so KV
    footprint tracks the request, not the worst case;
  * **decode-to-EOS** — iterations 1..N-1 each decode one token against the
    growing KV slice; ``total_iterations = output_tokens`` makes the
    simulator retire the task at EOS;
  * **KV free on completion** — ``release()`` frees the KV buffers and tears
    down the address space so the HBM pool reclaims every page.

Copied from the JAX package's ``serving/lifecycle.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.commands import Command
from repro_torch.core.workloads import LLMDecodeTask
from repro_torch.serving.traces import Request

# Prefill cost model: below this many prompt tokens one prefill pass is
# weight-bandwidth-bound (costs one decode step); above it, compute scales
# linearly with prompt length (paper Fig. 2: a decode step streams the whole
# model, so prefill amortizes weight reads over the batch of prompt tokens).
PREFILL_TOKENS_PER_WEIGHT_PASS = 128


class ServedRequestTask(LLMDecodeTask):
    """A single request's command stream; retires at EOS."""

    name = "served_request"

    def __init__(
        self,
        task_id: int,
        request: Request,
        page_size: int = 1 << 20,
        bytes_per_weight: float = 1.0,
        kv_headroom_tokens: int = 0,
    ):
        if request.output_tokens < 1 or request.prompt_tokens < 1:
            raise ValueError(
                f"request {request.req_id}: prompt/output token counts must "
                f"be >= 1, got {request.prompt_tokens}/{request.output_tokens}"
            )
        ctx = request.prompt_tokens + request.output_tokens + kv_headroom_tokens
        super().__init__(
            task_id,
            arch=request.tenant,
            max_context=ctx,
            start_len=request.prompt_tokens,
            bytes_per_weight=bytes_per_weight,
            page_size=page_size,
        )
        self.request = request
        self.slo_class = request.slo_class  # graceful-degradation class
        self.name = f"req{request.req_id}_{request.tenant}"
        self.total_iterations = request.output_tokens
        self._prefill_factor = max(
            1.0, request.prompt_tokens / PREFILL_TOKENS_PER_WEIGHT_PASS
        )

    def iteration(self, it: int) -> List[Command]:
        cmds = super().iteration(it)
        if it == 0 and self._prefill_factor > 1.0:
            # prefill: the weight-bound kernels process the whole prompt in
            # one pass; the attention command already covers the prompt-length
            # KV slice via start_len
            for c in cmds:
                if c.name != "llm_attn":
                    c.latency_us *= self._prefill_factor
        return cmds

    def kv_bytes(self) -> int:
        return sum(b.size for b in self.kv)

    def free_kv(self) -> int:
        """Free the per-request KV cache buffers (EOS); returns bytes freed."""
        freed = 0
        for buf in self.kv:
            if buf.buf_id in self.space.buffers:
                freed += buf.size
                self.space.free(buf)
        return freed

    def release(self):
        """EOS teardown: KV first (the per-request state), then the space."""
        self.free_kv()
        return super().release()
