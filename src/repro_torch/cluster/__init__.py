"""Multi-GPU cluster scheduling on top of the MSched simulator.

The cluster subsystem composes N per-GPU simulation cores
(:class:`repro_torch.core.simulator.SimCore`) under one event loop:

  * :mod:`~repro_torch.cluster.topology` — GPU fleet, PCIe/NVLink link graph with
    bandwidth contention, shared host DRAM staging budget;
  * :mod:`~repro_torch.cluster.placement` — which GPU gets an arriving task
    (round-robin / least-loaded baselines vs the MSched-aware bin-packer
    that best-fits predicted working sets against residency headroom);
  * :mod:`~repro_torch.cluster.migration` — inter-GPU task migration: checkpoint
    the working set through ``repro_torch.checkpointing``, pay the link-graph
    transfer, resume on the target; lazy manifest-only moves over NVLink,
    and the admission-rejection retry protocol;
  * :mod:`~repro_torch.cluster.prefetch` — NVLink peer-to-peer working-set
    prefetch: the page-location directory's wiring into each GPU's extended
    context switch, and cluster-wide OPT eviction;
  * :mod:`~repro_torch.cluster.aggregate` — merge per-GPU results/records into
    cluster-wide goodput/TTFT/TPOT;
  * :mod:`~repro_torch.cluster.faults` — fault injection (GPU/link/task failures)
    and the recovery runtime: checkpoint-based re-placement, linger-copy
    harvesting, capped-backoff requeues, and graceful degradation;
  * :mod:`~repro_torch.cluster.engine` — the ``simulate_cluster()`` entrypoint.

Copied from the JAX package's ``cluster/__init__.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from repro_torch.cluster.aggregate import (  # noqa: F401
    RequestStats,
    merge_request_records,
    merge_sim_results,
    peak_concurrent_bytes,
)
from repro_torch.cluster.engine import (  # noqa: F401
    ClusterReport,
    GPUReport,
    simulate_cluster,
)
from repro_torch.cluster.faults import (  # noqa: F401
    Checkpoint,
    CheckpointVault,
    FaultEvent,
    FaultInjector,
    FaultRuntime,
    RecoveryEvent,
)
from repro_torch.cluster.migration import (  # noqa: F401
    MigrationEvent,
    Rebalancer,
    ResumedTask,
)
from repro_torch.cluster.placement import (  # noqa: F401
    PLACEMENTS,
    LeastLoadedPlacement,
    MSchedPlacement,
    PlacementPolicy,
    RoundRobinPlacement,
    make_placement,
)
from repro_torch.cluster.prefetch import (  # noqa: F401
    PeerFetchEvent,
    PeerPrefetchFabric,
)
from repro_torch.cluster.topology import (  # noqa: F401
    ClusterTopology,
    GPUNode,
    LingerEntry,
    Link,
    PageDirectory,
    TransferPlan,
    homogeneous,
    mixed,
)
