"""Workload generators mirroring the paper's evaluation applications.

Each generator emits the task's GPU command stream with ground-truth touched
extents and deterministic latencies (paper §6: kernel latencies are stable).
The generators reproduce the memory-behavior archetypes the paper measures:

  * vecadd / matmul            — §7.1 microbenchmarks (streaming vs compute)
  * Rodinia-like (dwt2d, hotspot, cfd, nn) — SciComp combo A; `nn` includes a
    small indirect-gather region (the <1% "Others" of Table 2 → the only
    source of template false negatives)
  * DNN inference/training     — PyTorch-style: one pooled allocation sliced
    per layer (the aggregated-allocation pathology of §5.1)
  * LLM decode                 — llama.cpp-style: monolithic weight buffer +
    per-layer slices + KV cache allocated at max context but touched only up
    to the current sequence length (sparse-access pathology of §5.1).
    LLM streams are derived from the real model configs in repro_torch.configs.

Latencies are derived from a simple device model (memory-bound: bytes / HBM
bandwidth; compute-bound: flops / peak), calibrated so an int8 Llama3-8B
decode step touches ~8.5 GB in ~12.7 ms as in paper Fig. 2.

Copied from the JAX package's ``core/workloads.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.commands import KERNEL, Command, kernel
from repro_torch.core.pages import AddressSpace, Buffer, Extent

# device compute model (RTX-5080-class), used only for latency synthesis
GPU_HBM_GBPS = 900.0
GPU_PEAK_TFLOPS = 80.0


def _mem_us(nbytes: float, efficiency: float = 0.75) -> float:
    return nbytes / (GPU_HBM_GBPS * efficiency * 1e3)


def _flop_us(flops: float, efficiency: float = 0.5) -> float:
    return flops / (GPU_PEAK_TFLOPS * efficiency * 1e6)


class TaskProgram:
    """A task's repeating command stream (one iteration = one completion).

    ``total_iterations`` is ``None`` for the classic long-running combos; a
    finite value makes the task *retire* after that many completed iterations
    (the dynamic-lifecycle serving regime), at which point the simulator calls
    :meth:`release` and reclaims the task's HBM pages.
    """

    name: str = "task"
    total_iterations: Optional[int] = None

    def __init__(self, task_id: int, page_size: int = 4096):
        self.task_id = task_id
        self.space = AddressSpace(page_size=page_size, base=(task_id + 1) << 44)

    def iteration(self, it: int) -> List[Command]:
        raise NotImplementedError

    def footprint_bytes(self) -> int:
        return sum(b.size for b in self.space.buffers.values())

    def release(self):
        """Task exit: tear down the address space; returns its page span."""
        return self.space.release()


def footprint_pages(prog: TaskProgram, page_size: int) -> int:
    """Whole-footprint page count — the conservative demand bound admission
    and placement use for tasks that have no predictor helper yet."""
    return sum(
        (b.size + page_size - 1) // page_size
        for b in prog.space.buffers.values()
    )


# --------------------------------------------------------------------------
# §7.1 microbenchmarks
# --------------------------------------------------------------------------


class VecAddTask(TaskProgram):
    """Streams 3N bytes per kernel — large working set, zero reuse."""

    name = "vecadd"

    def __init__(self, task_id: int, n_bytes: int, kernels_per_iter: int = 4, **kw):
        super().__init__(task_id, **kw)
        self.n = n_bytes
        self.k = kernels_per_iter
        self.bufs = [
            [
                self.space.malloc(n_bytes, f"vec{j}_{w}")
                for w in ("a", "b", "c")
            ]
            for j in range(kernels_per_iter)
        ]

    def iteration(self, it):
        cmds = []
        for a, b, c in self.bufs:
            n_elems = self.n // 4
            ext = [(a.base, self.n), (b.base, self.n), (c.base, self.n)]
            cmds.append(
                kernel(
                    "vector_add",
                    (a.base, b.base, c.base, n_elems, n_elems // 256, 256),
                    _mem_us(3 * self.n),
                    ext,
                )
            )
        return cmds


class MatMulTask(TaskProgram):
    """Compute-bound GEMMs over a set of weight matrices."""

    name = "matmul"

    def __init__(self, task_id: int, dim: int, n_matrices: int = 8, **kw):
        super().__init__(task_id, **kw)
        self.dim = dim
        self.sz = dim * dim * 2  # fp16
        self.a = self.space.malloc(self.sz, "act_a")
        self.c = self.space.malloc(self.sz, "act_c")
        self.ws = [self.space.malloc(self.sz, f"w{i}") for i in range(n_matrices)]

    def iteration(self, it):
        cmds = []
        d = self.dim
        for w in self.ws:
            ext = [(self.a.base, self.sz), (w.base, self.sz), (self.c.base, self.sz)]
            cmds.append(
                kernel(
                    "matmul",
                    (self.a.base, w.base, self.c.base, d, d, d),
                    _flop_us(2.0 * d * d * d),
                    ext,
                )
            )
        return cmds


# --------------------------------------------------------------------------
# Rodinia-like SciComp (combo A)
# --------------------------------------------------------------------------


class Dwt2dTask(TaskProgram):
    """2-D DWT: per level a strided access over image rows (T3)."""

    name = "dwt2d"

    def __init__(self, task_id: int, side: int = 8192, levels: int = 3, **kw):
        super().__init__(task_id, **kw)
        self.side = side
        self.levels = levels
        self.img = self.space.malloc(side * side * 4, "image")
        self.out = self.space.malloc(side * side * 4, "coeffs")

    def iteration(self, it):
        cmds = []
        for lvl in range(self.levels):
            rows = self.side >> lvl
            row_bytes = (self.side >> lvl) * 4
            stride = self.side * 4
            ext = [
                (self.img.base + r * stride, row_bytes) for r in range(rows)
            ] + [(self.out.base, rows * row_bytes)]
            cmds.append(
                kernel(
                    "dwt2d_level",
                    (self.img.base, self.out.base, rows, row_bytes, stride),
                    _mem_us(2 * rows * row_bytes),
                    ext,
                )
            )
        return cmds


class HotspotTask(TaskProgram):
    name = "hotspot"

    def __init__(self, task_id: int, cells: int = 64 << 20, steps: int = 4, **kw):
        super().__init__(task_id, **kw)
        self.steps = steps
        self.sz = cells * 4
        self.temp = self.space.malloc(self.sz, "temp")
        self.power = self.space.malloc(self.sz, "power")
        self.out = self.space.malloc(self.sz, "temp_out")

    def iteration(self, it):
        cmds = []
        for _ in range(self.steps):
            ext = [
                (self.temp.base, self.sz),
                (self.power.base, self.sz),
                (self.out.base, self.sz),
            ]
            cmds.append(
                kernel(
                    "hotspot_step",
                    (self.temp.base, self.power.base, self.out.base, self.sz // 4),
                    _mem_us(3 * self.sz),
                    ext,
                )
            )
        return cmds


class CfdTask(TaskProgram):
    name = "cfd"

    def __init__(self, task_id: int, elems: int = 24 << 20, **kw):
        super().__init__(task_id, **kw)
        self.sz = elems * 4
        self.arrays = [self.space.malloc(self.sz, f"cfd{i}") for i in range(5)]

    def iteration(self, it):
        cmds = []
        for phase in range(3):
            ext = [(a.base, self.sz) for a in self.arrays]
            cmds.append(
                kernel(
                    "cfd_flux",
                    tuple(a.base for a in self.arrays) + (self.sz // 4, phase),
                    _mem_us(5 * self.sz),
                    ext,
                )
            )
        return cmds


class NnTask(TaskProgram):
    """Nearest-neighbor search with a small *indirect* candidate gather —
    the pointer-chasing residue the templates cannot cover (Table 1's 0.92%
    Rodinia false negatives)."""

    name = "nn"

    def __init__(self, task_id: int, records: int = 48 << 20, **kw):
        super().__init__(task_id, **kw)
        self.sz = records
        self.db = self.space.malloc(records, "records")
        self.out = self.space.malloc(4 << 20, "results")
        # candidate table reached via pointers stored *in* the records
        # (pointer-chasing): its base is never passed as a kernel argument
        self.cand = self.space.malloc(16 << 20, "candidates")

    def iteration(self, it):
        ext = [(self.db.base, self.sz), (self.out.base, self.out.size)]
        # indirect gather: a data-dependent window not derivable from args
        win = 512 << 10
        widx = (it * 2654435761) % (self.cand.size - win)
        ext.append((self.cand.base + widx, win))
        return [
            kernel(
                "nn_search",
                (self.db.base, self.out.base, self.sz, 64),
                _mem_us(self.sz),
                ext,
            )
        ]


# --------------------------------------------------------------------------
# DNN inference / training (PyTorch-style pooled allocations)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _DNNSpec:
    name: str
    layer_mbytes: Sequence[float]  # per-layer weight sizes
    act_mbytes: float


DNN_SPECS = {
    # crude per-layer weight profiles (MB) — shapes only need to be *plausible*
    "resnet152": _DNNSpec("resnet152", [1.0] * 40 + [4.0] * 60 + [9.0] * 16, 256.0),
    "vgg19": _DNNSpec("vgg19", [2.0] * 8 + [9.0] * 8 + [392.0, 64.0, 16.0], 320.0),
    "inceptionv3": _DNNSpec("inceptionv3", [0.5] * 60 + [3.0] * 30 + [8.0] * 5, 192.0),
    "densenet201": _DNNSpec("densenet201", [0.3] * 120 + [2.0] * 60, 288.0),
}


class DNNInferTask(TaskProgram):
    """One pooled weight allocation sliced per layer (aggregated allocation)."""

    name = "dnn_infer"

    def __init__(self, task_id: int, model: str = "resnet152", batch: int = 8, **kw):
        super().__init__(task_id, **kw)
        spec = DNN_SPECS[model]
        self.name = f"{model}_infer"
        self.model = model
        self.batch = batch
        self.layer_sizes = [int(m * (1 << 20)) for m in spec.layer_mbytes]
        self.wpool = self.space.malloc(sum(self.layer_sizes), "weight_pool")
        self.apool = self.space.malloc(int(spec.act_mbytes * (1 << 20)), "act_pool")
        # per-layer slice offsets inside the pool
        self.offsets = []
        off = 0
        for sz in self.layer_sizes:
            self.offsets.append(off)
            off += sz

    def iteration(self, it):
        cmds = []
        act_half = self.apool.size // 2
        for li, (off, sz) in enumerate(zip(self.offsets, self.layer_sizes)):
            w_ptr = self.wpool.base + off
            x_ptr = self.apool.base + (li % 2) * act_half
            y_ptr = self.apool.base + ((li + 1) % 2) * act_half
            act_bytes = act_half * self.batch // 8  # scales with batch
            act_bytes = min(act_bytes, act_half)
            ext = [(w_ptr, sz), (x_ptr, act_bytes), (y_ptr, act_bytes)]
            flops = 2.0 * sz / 2 * self.batch * 24  # conv reuse factor
            cmds.append(
                kernel(
                    f"{self.model}_conv{li}",
                    (x_ptr, w_ptr, y_ptr, self.batch, sz, act_bytes),
                    max(_flop_us(flops), _mem_us(sz + 2 * act_bytes)),
                    ext,
                )
            )
        return cmds


class DNNTrainTask(DNNInferTask):
    """Forward + backward + optimizer step: weights touched twice, plus
    gradient and optimizer-state pools (intermittent command launching)."""

    name = "dnn_train"

    def __init__(self, task_id: int, model: str = "resnet152", batch: int = 8, **kw):
        super().__init__(task_id, model, batch, **kw)
        self.name = f"{model}_train"
        self.gpool = self.space.malloc(self.wpool.size, "grad_pool")
        self.opool = self.space.malloc(2 * self.wpool.size, "adam_pool")

    def iteration(self, it):
        fwd = super().iteration(it)
        bwd = []
        act_half = self.apool.size // 2
        for li in reversed(range(len(self.layer_sizes))):
            off, sz = self.offsets[li], self.layer_sizes[li]
            ext = [
                (self.wpool.base + off, sz),
                (self.gpool.base + off, sz),
                (self.apool.base, act_half),
            ]
            bwd.append(
                kernel(
                    f"{self.model}_bwd{li}",
                    (
                        self.apool.base,
                        self.wpool.base + off,
                        self.gpool.base + off,
                        self.batch,
                        sz,
                    ),
                    max(_flop_us(2 * sz * self.batch * 24), _mem_us(2 * sz + act_half)),
                    ext,
                )
            )
        opt = kernel(
            f"{self.model}_adam",
            (self.wpool.base, self.gpool.base, self.opool.base, self.wpool.size),
            _mem_us(self.wpool.size * 4),
            [
                (self.wpool.base, self.wpool.size),
                (self.gpool.base, self.gpool.size),
                (self.opool.base, self.opool.size),
            ],
        )
        return fwd + bwd + [opt]


# --------------------------------------------------------------------------
# LLM decode (llama.cpp-style) — derived from the real model configs
# --------------------------------------------------------------------------


class LLMDecodeTask(TaskProgram):
    """Autoregressive decode of a configs-defined LM.

    Weight layout mirrors llama.cpp: ONE monolithic buffer for all weights,
    sliced per layer/matrix. KV caches are allocated at ``max_context`` but
    the attention kernel touches only ``seq_len(t)`` tokens — the two §5.1
    pathologies. Per-step byte volume ≈ whole model (Fig. 2).
    """

    name = "llm_decode"

    def __init__(
        self,
        task_id: int,
        arch: str = "paper-llama3-8b",
        max_context: int = 4096,
        start_len: int = 256,
        bytes_per_weight: float = 1.0,  # int8
        **kw,
    ):
        super().__init__(task_id, **kw)
        self.cfg: ModelConfig = get_config(arch)
        self.name = f"llm_{arch}"
        self.max_context = max_context
        self.start_len = start_len
        c = self.cfg
        hd = c.resolved_head_dim()
        self.wq = int(c.d_model * c.num_heads * hd * bytes_per_weight)
        self.wkv = int(c.d_model * c.num_kv_heads * hd * bytes_per_weight)
        self.wo = self.wq
        self.wffn = int(c.d_model * c.d_ff * bytes_per_weight)
        per_layer = self.wq + 2 * self.wkv + self.wo + 3 * self.wffn
        embed = int(c.vocab_size * c.d_model * bytes_per_weight)
        self.layer_bytes = per_layer
        self.embed_bytes = embed
        self.wpool = self.space.malloc(
            per_layer * c.num_layers + 2 * embed, "weights"
        )
        self.apool = self.space.malloc(256 << 20, "activations")
        self.kv_token_bytes = 2 * c.num_kv_heads * hd * 2  # k+v, fp16
        self.kv = [
            self.space.malloc(self.kv_token_bytes * max_context, f"kv{l}")
            for l in range(c.num_layers)
        ]
        # precompute per-layer static command templates (args tuples, extents
        # lists, latencies); only the attention command varies with seq_len.
        # Extents lists are shared across iterations — commands never mutate
        # them, and the run-decode memo keys on their content.
        act = (self.apool.base, 8 << 20)
        self._act = act
        qkvo_sz = self.wq + 2 * self.wkv + self.wo
        self._layers = []
        for li in range(c.num_layers):
            base = self.wpool.base + li * self.layer_bytes
            ffn_base = base + qkvo_sz
            # int8 dequant scales: one scale block per quant group — a
            # strided read over the ffn weights (T3, llama.cpp-style)
            n_blocks = 64
            blk_stride = (3 * self.wffn) // n_blocks
            scale_sz = 4 << 10
            self._layers.append(
                (
                    # llm_qkvo
                    (
                        (act[0], base, qkvo_sz, c.d_model, li),
                        _mem_us(qkvo_sz),
                        [(base, qkvo_sz), act],
                    ),
                    # llm_attn statics
                    self.kv[li].base,
                    # llm_dequant_scales
                    (
                        (ffn_base, n_blocks, scale_sz, blk_stride),
                        _mem_us(n_blocks * scale_sz),
                        [(ffn_base + i * blk_stride, scale_sz) for i in range(n_blocks)],
                    ),
                    # llm_ffn
                    (
                        (act[0], ffn_base, 3 * self.wffn, c.d_ff, li),
                        _mem_us(3 * self.wffn),
                        [(ffn_base, 3 * self.wffn), act],
                    ),
                )
            )
        head_base = self.wpool.base + c.num_layers * self.layer_bytes
        self._head = (
            (act[0], head_base, 2 * self.embed_bytes, c.vocab_size),
            _mem_us(2 * self.embed_bytes),
            [(head_base, 2 * self.embed_bytes), act],
        )

    def seq_len(self, it: int) -> int:
        return min(self.start_len + it, self.max_context)

    def iteration(self, it):
        s = self.seq_len(it)
        act = self._act
        kv_bytes = s * self.kv_token_bytes
        attn_lat = _mem_us(kv_bytes)
        cmds: List[Command] = []
        for li, (qkvo, kv_base, scales, ffn) in enumerate(self._layers):
            cmds.append(Command(KERNEL, "llm_qkvo", qkvo[0], qkvo[1], qkvo[2]))
            cmds.append(
                Command(
                    KERNEL,
                    "llm_attn",
                    (kv_base, act[0], s, self.kv_token_bytes, li),
                    attn_lat,
                    [(kv_base, kv_bytes), act],
                )
            )
            cmds.append(
                Command(KERNEL, "llm_dequant_scales", scales[0], scales[1], scales[2])
            )
            cmds.append(Command(KERNEL, "llm_ffn", ffn[0], ffn[1], ffn[2]))
        cmds.append(
            Command(KERNEL, "llm_head", self._head[0], self._head[1], self._head[2])
        )
        return cmds


# --------------------------------------------------------------------------
# Paper task combinations (Table 3)
# --------------------------------------------------------------------------


def combo(
    name: str, page_size: int, scale: float = 1.0
) -> List[TaskProgram]:
    """Builds the paper's combos A–D. ``scale`` stretches footprints to hit a
    target oversubscription ratio (the paper scales problem/batch sizes)."""
    mk = lambda cls, tid, **kw: cls(tid, page_size=page_size, **kw)
    s = scale
    if name == "A":  # SciComp
        return [
            mk(Dwt2dTask, 0, side=int(8192 * s**0.5)),
            mk(HotspotTask, 1, cells=int((64 << 20) * s)),
            mk(CfdTask, 2, elems=int((24 << 20) * s)),
            mk(NnTask, 3, records=int((48 << 20) * s)),
        ]
    if name == "B":  # MultiDNN
        return [
            mk(DNNInferTask, 0, model="resnet152", batch=int(8 * s)),
            mk(DNNInferTask, 1, model="vgg19", batch=int(8 * s)),
            mk(DNNInferTask, 2, model="inceptionv3", batch=int(8 * s)),
            mk(DNNInferTask, 3, model="densenet201", batch=int(8 * s)),
        ]
    if name == "C":  # HybridDL
        return combo("B", page_size, s) + [
            mk(LLMDecodeTask, 4, arch="paper-llama3-8b")
        ]
    if name == "D":  # MultiLLM
        n = max(2, int(round(2 * s)))
        return [
            mk(LLMDecodeTask, i, arch="paper-llama3-8b") for i in range(n)
        ]
    raise KeyError(name)
