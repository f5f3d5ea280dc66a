"""Placement policies: which GPU gets an arriving task.

A policy sees the arriving program and the live per-GPU cores (through
``SimCore.state_view()`` — the same read-only view admission controllers
get) and returns the index of the chosen GPU. Baselines:

  * ``RoundRobinPlacement`` — arrival order, no load awareness;
  * ``LeastLoadedPlacement`` — fewest resident-plus-queued tasks (the classic
    task-count balancer; blind to memory and to device capacity).

``MSchedPlacement`` is the MSched-aware bin-packer: it prices each GPU's
*per-schedule-cycle HBM demand* from exactly the state the memory manager
already maintains — every admitted task's predicted per-quantum working set
(the planner's ``consume_cut``) plus the whole-footprint bound for queued
candidates — and best-fits the arrival's footprint against the remaining
residency headroom. When several GPUs fit equally it prefers the one whose
interconnect lands the working set fastest (``plan_population_runs`` on the
candidate footprint — meaningful on heterogeneous clusters where swap
bandwidths differ); when nothing fits it picks the least *relatively*
overloaded device, which degrades gracefully into capacity-proportional
balancing.

Copied from the JAX package's ``cluster/placement.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.migration import plan_population_runs
from repro_torch.core.simulator import SimState, active_demand_pages
from repro_torch.core.workloads import TaskProgram, footprint_pages
from repro_torch.cluster.topology import HOST, ClusterTopology


class PlacementPolicy:
    """Base class for arrival-dispatch policies.

    ``simulate_cluster`` calls :meth:`place` once per trace arrival, the
    moment the request arrives; the chosen core receives the program as a
    normal ``TaskArrival`` (its own admission controller still decides
    *when* the task actually starts). Policies may be stateful — one
    instance drives one cluster run.
    """

    name = "base"

    def place(
        self, prog: TaskProgram, arrival_us: float, cores: Sequence
    ) -> int:
        """Index of the GPU that receives ``prog``. ``cores`` expose
        ``state_view() -> SimState`` and ``name``."""
        raise NotImplementedError


class RoundRobinPlacement(PlacementPolicy):
    """Arrival order, no load awareness — the parity baseline: every GPU
    gets every N-th request regardless of footprint or device capacity."""

    name = "roundrobin"

    def __init__(self) -> None:
        self._next = 0

    def place(self, prog, arrival_us, cores):
        i = self._next % len(cores)
        self._next += 1
        return i


class LeastLoadedPlacement(PlacementPolicy):
    """Fewest tasks on device (active + queued); ties go to the lowest
    index. Capacity- and memory-blind by design — the baseline the paper-
    style bin-packer is measured against."""

    name = "leastloaded"

    def place(self, prog, arrival_us, cores):
        loads = []
        for i, core in enumerate(cores):
            st: SimState = core.state_view()
            loads.append((len(st.active) + st.waiting, i))
        return min(loads)[1]


class MSchedPlacement(PlacementPolicy):
    """Best-fit by predicted working set against per-GPU residency headroom.

    ``headroom`` mirrors the admission controller's: the fraction of HBM the
    packed working sets may claim. ``quantum_us`` defaults to each GPU's own
    scheduler quantum.

    ``topology`` (optional; the engine wires it for NVLink-bearing fleets)
    makes the landing-time tie-break *fluid-share aware*: a GPU whose host
    link is currently carrying in-flight migrations or peer prefetches
    would land the arrival's working set at a contended share of its PCIe
    bandwidth, so its landing estimate is scaled by the live sharer count
    (``ClusterTopology.active_on``). Peer-less fleets never set it, keeping
    their placement decisions identical to the plain bin-packer.
    """

    name = "msched"

    def __init__(
        self,
        headroom: float = 0.9,
        quantum_us: Optional[float] = None,
        topology: Optional[ClusterTopology] = None,
    ):
        assert headroom > 0
        self.headroom = headroom
        self.quantum_us = quantum_us
        self.topology = topology

    def _demand(self, st: SimState) -> int:
        quantum = self.quantum_us or getattr(st.policy, "quantum_us", 5_000.0)
        return active_demand_pages(st, quantum) + st.waiting_pages

    def place(self, prog, arrival_us, cores):
        fits: List[tuple] = []
        overloaded: List[tuple] = []
        for i, core in enumerate(cores):
            st: SimState = core.state_view()
            cand = footprint_pages(prog, st.page_size)
            budget = self.headroom * st.pool.capacity
            free = budget - self._demand(st)
            if cand <= free:
                # tightest feasible fit: filling the snuggest GPU first
                # preserves the large contiguous headrooms for the large
                # arrivals that have nowhere else to go (classic best-fit);
                # ties go to the fastest-landing interconnect, at the fluid
                # share its host link would actually grant right now
                land_us = plan_population_runs(
                    st.platform, [(0, cand)], 0, True, st.page_size
                ).total_us
                if self.topology is not None:
                    land_us *= 1 + self.topology.active_on(
                        core.name, HOST, arrival_us
                    )
                fits.append((free - cand, land_us, i))
            else:
                # relative overload: a 2x-capacity device absorbs twice the
                # spill before it is as pressured as its smaller sibling
                overloaded.append(((self._demand(st) + cand) / st.pool.capacity, i))
        if fits:
            return min(fits)[2]
        return min(overloaded)[1]


PLACEMENTS = {
    RoundRobinPlacement.name: RoundRobinPlacement,
    LeastLoadedPlacement.name: LeastLoadedPlacement,
    MSchedPlacement.name: MSchedPlacement,
}


def make_placement(name_or_policy) -> PlacementPolicy:
    """Resolve a policy: an instance passes through (callers may pre-build
    one with custom knobs), a name from :data:`PLACEMENTS` is constructed
    with defaults. ``simulate_cluster`` accepts either form."""
    if isinstance(name_or_policy, PlacementPolicy):
        return name_or_policy
    return PLACEMENTS[name_or_policy]()
