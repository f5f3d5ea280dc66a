"""Hardware constants.

GPU-side constants are calibrated from the paper's own measurements (§3, §7.3)
so the simulator reproduces its figures; TPU v5e constants drive the roofline
analysis of the dry-run (§Roofline in EXPERIMENTS.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    hbm_bytes: int
    page_size: int
    # demand-paging fault path (paper §3: 31.79 us/fault, 96% control plane)
    fault_total_us: float
    fault_transfer_us: float
    # batched DMA bandwidths (paper Fig. 9a)
    d2h_gbps: float  # eviction incl. unmap
    h2d_gbps: float  # population incl. map
    duplex_cap_gbps: float  # host-side ceiling on overlapped D2H+H2D
    # UM fault-group model: CUDA UM's tree-based prefetcher escalates the
    # migration granularity from 64 KiB up to 2 MiB for dense access; one
    # CPU-serviced fault per ~1 MiB group reproduces the paper's ~9210
    # faults per 8.5 GB decode step (Fig. 1)
    um_prefetch_pages: int = 256  # 1 MiB fault groups
    # under pressure the driver reclaims space in large chunks (2 MiB blocks
    # batched per eviction pass), kicking out soon-needed pages of *other*
    # tasks — a key source of UM's multitasking thrash (§3)
    um_evict_batch_bytes: int = 64 << 20


# NVIDIA RTX 5080 (16 GB, PCIe 5.0 x16) — the paper's primary testbed.
RTX5080 = Platform(
    name="rtx5080",
    hbm_bytes=16 << 30,
    page_size=4 << 10,
    fault_total_us=31.79,
    fault_transfer_us=1.35,
    d2h_gbps=41.7,
    h2d_gbps=41.7,
    duplex_cap_gbps=63.5,  # Intel chiplet NoC ceiling (paper §7.3)
)

# NVIDIA RTX 3080 (10 GB, PCIe 4.0 x16) — the paper's second testbed.
RTX3080 = Platform(
    name="rtx3080",
    hbm_bytes=10 << 30,
    page_size=4 << 10,
    fault_total_us=31.79,
    fault_transfer_us=2.7,
    d2h_gbps=22.22,
    h2d_gbps=22.22,
    duplex_cap_gbps=39.8,
)

# Heterogeneous serving-fleet presets: datacenter device classes with 40 GB /
# 80 GB HBM variants and differing swap bandwidths, so cluster topologies can
# mix device classes (the fault control-plane cost is the same KMD path the
# paper measures; the transfer term scales with the interconnect).
A100_40G = Platform(
    name="a100_40g",
    hbm_bytes=40 << 30,
    page_size=4 << 10,
    fault_total_us=31.79,
    fault_transfer_us=2.4,
    d2h_gbps=24.0,  # PCIe 4.0 x16
    h2d_gbps=24.0,
    duplex_cap_gbps=42.0,
)

A100_80G = Platform(
    name="a100_80g",
    hbm_bytes=80 << 30,
    page_size=4 << 10,
    fault_total_us=31.79,
    fault_transfer_us=2.2,
    d2h_gbps=26.0,  # PCIe 4.0 x16, SXM board power/host path headroom
    h2d_gbps=26.0,
    duplex_cap_gbps=46.0,
)

H100_80G = Platform(
    name="h100_80g",
    hbm_bytes=80 << 30,
    page_size=4 << 10,
    fault_total_us=31.79,
    fault_transfer_us=1.2,
    d2h_gbps=49.0,  # PCIe 5.0 x16
    h2d_gbps=49.0,
    duplex_cap_gbps=80.0,
)

# NVLink peer-to-peer bandwidth (GB/s per direction) for the cluster link
# graph; GPUs without NVLink reach peers through host-staged PCIe copies.
NVLINK_A100_GBPS = 300.0
NVLINK_H100_GBPS = 450.0

# TPU v5e — the deployment target for the framework (roofline §Perf).
TPU_V5E_PEAK_BF16_FLOPS = 197e12  # per chip
TPU_V5E_HBM_GBPS = 819.0  # per chip
TPU_V5E_ICI_GBPS = 50.0  # per link
TPU_V5E_HBM_BYTES = 16 << 30

TPU_V5E = Platform(
    name="tpu_v5e",
    hbm_bytes=TPU_V5E_HBM_BYTES,
    page_size=4 << 20,  # TPU adaptation: 4 MiB extents (see DESIGN.md)
    fault_total_us=0.0,  # TPUs cannot fault: proactive scheduling is mandatory
    fault_transfer_us=0.0,
    d2h_gbps=32.0,  # host DMA
    h2d_gbps=32.0,
    duplex_cap_gbps=60.0,
)

PLATFORMS = {
    p.name: p
    for p in (RTX5080, RTX3080, A100_40G, A100_80G, H100_80G, TPU_V5E)
}


def hbm_variant(platform: Platform, hbm_bytes: int, name: str = "") -> Platform:
    """Same device class with a different HBM size (e.g. a capacity-binned
    SKU for a heterogeneous cluster)."""
    return dataclasses.replace(
        platform,
        name=name or f"{platform.name}_{hbm_bytes >> 30}g",
        hbm_bytes=hbm_bytes,
    )


def fault_bandwidth_gbps(p: Platform) -> float:
    """Effective page-fault migration bandwidth (paper: 0.12 GB/s on 5080)."""
    return (p.page_size / 1e9) / (p.fault_total_us * 1e-6)
