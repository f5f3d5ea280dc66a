"""Cluster topology: GPU nodes, the PCIe/NVLink link graph, and the shared
host DRAM staging budget.

The topology answers one question for the cluster scheduler: *what does it
cost to move bytes between two GPUs right now?* Every GPU has a host link
(its PCIe connection, bandwidth taken from the device's ``Platform``); pairs
of GPUs may additionally have a peer-to-peer NVLink edge. A transfer follows
the direct edge when one exists, otherwise it stages through host DRAM
(src → host, then host → dst), charging the staged bytes against the shared
``host_dram_bytes`` budget for the duration of the transfer.

Link **contention** is modeled fluid-at-start: when a transfer enters a link
it shares that link's bandwidth equally with every transfer still active on
it, and the share is fixed for the transfer's lifetime (no re-evaluation as
sharers come and go). That keeps planning deterministic and O(active
transfers) while still penalizing migration storms that pile onto one PCIe
root port — the first-order effect the paper's pipelined-migration analysis
(§6.3) cares about. The assumptions are documented in EXPERIMENTS.md
("Cluster topology model").

When a :class:`~repro_torch.cluster.transfer_plan.TransferPlanner` is attached
(``simulate_cluster(transfer_plan="auto")``), :meth:`plan_transfer` /
:meth:`plan_restore` delegate to it instead: the planner prices every move
against a piecewise-constant fluid schedule (shares re-evaluated as sharers
drain), may route around a saturated host link over an idle NVLink detour,
and *rebooks* in-flight plans (:meth:`rebook`) when later admissions change
their landing times — firing ``replan_hook`` so the engine can retime the
dependent arrival events. With no planner attached every code path below is
byte-identical to the pre-planner fluid-at-start model.

Copied from the JAX package's ``cluster/topology.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Callable,
    Dict,
    FrozenSet,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.hardware import Platform
from repro_torch.core.pages import PageRun, merge_runs, run_page_count, subtract_runs


@dataclasses.dataclass(frozen=True)
class GPUNode:
    """One device in the cluster. ``capacity_bytes`` overrides the platform's
    HBM size (benchmarks shrink capacity to hit a target oversubscription
    without shrinking the workload)."""

    name: str
    platform: Platform
    capacity_bytes: Optional[int] = None

    @property
    def hbm_bytes(self) -> int:
        return self.capacity_bytes or self.platform.hbm_bytes


@dataclasses.dataclass
class Link:
    """Undirected edge of the link graph. ``kind`` is ``"pcie"`` for
    GPU↔host edges and ``"nvlink"`` for GPU↔GPU peer edges."""

    a: str
    b: str
    gbps: float
    kind: str = "pcie"

    def key(self) -> FrozenSet[str]:
        return frozenset((self.a, self.b))


@dataclasses.dataclass
class TransferPlan:
    """One planned inter-GPU transfer: leg completion times on the chosen
    path, with the share each leg got of its link.

    ``kind``/``task_id`` classify the payload for telemetry and replan
    routing (``"bulk"`` when the caller did not say). ``canceled_us`` is
    stamped by :meth:`ClusterTopology.cancel_staging`: from that instant
    the plan's remaining legs no longer count as in-flight — without it a
    canceled transfer and its same-timestamp retry would both be counted
    by the :meth:`ClusterTopology.inflight_bytes` probe."""

    src: str
    dst: str
    nbytes: int
    start_us: float
    arrival_us: float
    staged: bool  # True when routed through host DRAM
    legs: List[Tuple[str, float]]  # (link key as "a<->b", leg end time)
    kind: str = "bulk"
    task_id: Optional[int] = None
    canceled_us: Optional[float] = None


HOST = "host"


class ClusterTopology:
    """GPU fleet + link graph + host DRAM budget.

    ``nvlinks`` lists peer edges as ``(gpu_a, gpu_b, gbps)``. Host links are
    created automatically for every GPU at the platform's PCIe bandwidth
    (``min(d2h, h2d)`` — the symmetric planning rate)."""

    def __init__(
        self,
        gpus: Sequence[GPUNode],
        host_dram_bytes: int = 512 << 30,
        nvlinks: Sequence[Tuple[str, str, float]] = (),
    ):
        if len({g.name for g in gpus}) != len(gpus):
            raise ValueError("GPU names must be unique")
        self.gpus = list(gpus)
        self.by_name = {g.name: g for g in self.gpus}
        self.host_dram_bytes = host_dram_bytes
        self._links: Dict[FrozenSet[str], Link] = {}
        for g in self.gpus:
            bw = min(g.platform.d2h_gbps, g.platform.h2d_gbps)
            self._add(Link(g.name, HOST, bw, "pcie"))
        for a, b, gbps in nvlinks:
            if a not in self.by_name or b not in self.by_name:
                raise ValueError(f"nvlink endpoint not in cluster: {a}<->{b}")
            self._add(Link(a, b, gbps, "nvlink"))
        # active-transfer bookkeeping: link key -> [end_us, ...] and the host
        # staging intervals (start_us, end_us, bytes)
        self._active: Dict[FrozenSet[str], List[float]] = {}
        self._staged: List[Tuple[float, float, int]] = []
        self.transfers: List[TransferPlan] = []
        self.deferred = 0  # transfers denied by the host DRAM budget
        # fault injection: link key -> bandwidth factor (absent = healthy);
        # 0.0 takes an NVLink edge down entirely (traffic re-routes through
        # host staging)
        self._degraded: Dict[FrozenSet[str], float] = {}
        # scheduled-transfer mode: when a TransferPlanner is attached the
        # plan_* entry points delegate to it; replan_hook fires whenever a
        # rebook moves a committed plan's arrival (the engine retimes the
        # dependent TaskArrival). Both stay None in greedy mode.
        self.planner = None  # repro_torch.cluster.transfer_plan.TransferPlanner
        self.replan_hook: Optional[Callable[[TransferPlan, float], None]] = None
        self.replans = 0

    def _add(self, link: Link) -> None:
        self._links[link.key()] = link

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.gpus)

    def link(self, a: str, b: str) -> Optional[Link]:
        return self._links.get(frozenset((a, b)))

    def links(self) -> List[Link]:
        return list(self._links.values())

    def link_factor(self, key: FrozenSet[str]) -> float:
        """Current bandwidth factor of a link (1.0 = healthy, 0.0 = down)."""
        return self._degraded.get(key, 1.0)

    def has_nvlink(self) -> bool:
        """True when any peer (GPU↔GPU) edge exists. The cluster engine only
        builds the peer-prefetch machinery for NVLink-bearing fleets, which
        is what keeps peer-less topologies bit-for-bit with the plain
        composition."""
        return any(l.kind == "nvlink" for l in self._links.values())

    def nvlink_peer(self, a: str, b: str) -> Optional[Link]:
        """The direct peer edge between two GPUs, or ``None`` (host-staged).
        A downed edge (``degrade(..., 0.0)``) does not count as a peer."""
        link = self.link(a, b)
        if link is None or link.kind != "nvlink":
            return None
        return link if self.link_factor(link.key()) > 0.0 else None

    def active_on(self, a: str, b: str, at_us: float) -> int:
        """Transfers still in flight on the ``a<->b`` link at ``at_us`` —
        a read-only contention probe (no booking) for fluid-share-aware
        placement and planning."""
        ends = self._active.get(frozenset((a, b)), ())
        return sum(1 for e in ends if e > at_us)

    def inflight_bytes(self, a: str, b: str, at_us: float) -> int:
        """Bytes of planned transfers whose ``a<->b`` leg is still in flight
        at ``at_us`` — a read-only probe (telemetry link-utilization
        counters). A leg covers ``[previous leg's end, its own end)``;
        fluid-at-start pricing means the payload occupies the whole leg.
        A canceled plan (retry chain exhausted, unreachable working set)
        stops counting at its ``canceled_us``: a transfer canceled and
        replanned at the same timestamp must count once, not twice."""
        name = f"{a}<->{b}"
        alt = f"{b}<->{a}"
        total = 0
        for plan in self.transfers:
            if plan.canceled_us is not None and at_us >= plan.canceled_us:
                continue
            start = plan.start_us
            for leg_name, leg_end in plan.legs:
                if leg_name in (name, alt) and start <= at_us < leg_end:
                    total += plan.nbytes
                start = leg_end
        return total

    def solo_transfer_us(self, src: str, dst: str, nbytes: int) -> float:
        """What moving ``nbytes`` would take on an *uncontended* path at
        current degradation factors — no booking, no staging check. The
        telemetry layer splits a real (shared-rate) transit time against
        this floor: the solo portion is migration-wait, the excess is
        link-contention."""
        if nbytes <= 0:
            return 0.0
        us = 0.0
        for link in self.path(src, dst):
            factor = self.link_factor(link.key())
            if factor <= 0.0:
                return float("inf")
            us += nbytes / (link.gbps * factor * 1e3)
        return us

    def path(self, src: str, dst: str) -> List[Link]:
        """Direct peer edge when present (and not downed), else host-staged
        two-hop path."""
        direct = self.link(src, dst)
        if direct is not None and self.link_factor(direct.key()) > 0.0:
            return [direct]
        return [self._links[frozenset((src, HOST))],
                self._links[frozenset((dst, HOST))]]

    def host_staged_bytes(self, now: float) -> int:
        """Bytes currently parked in host DRAM by in-flight staged
        transfers. Drained stagings are pruned in place (time only moves
        forward within a run), so the scan stays O(in-flight)."""
        self._staged = [se for se in self._staged if se[1] > now]
        return sum(b for s, e, b in self._staged if s <= now)

    def reset_transfers(self) -> None:
        """Clear all transfer bookkeeping (active links, stagings, history,
        deferral count). ``simulate_cluster`` calls this at the start of a
        run: contention state is per-run, so one topology can be reused
        across a policy sweep."""
        self._active.clear()
        self._staged.clear()
        self.transfers.clear()
        self.deferred = 0
        self._degraded.clear()
        self.replans = 0
        if self.planner is not None:
            self.planner.reset()

    # -- fault injection -----------------------------------------------------
    def degrade(self, a: str, b: str, factor: float) -> None:
        """Scale the ``a<->b`` link's bandwidth by ``factor`` (a flap or
        partial lane failure). ``factor == 0`` takes the edge *down* —
        NVLink edges only: peer traffic re-routes through host staging, but
        a GPU's host link must always exist (a GPU with no PCIe path is a
        failed GPU, which is a ``gpu_fail`` event, not a link event).
        In-flight transfers keep their planned times (fluid-at-start); only
        new plans see the factor."""
        key = frozenset((a, b))
        link = self._links.get(key)
        if link is None:
            raise ValueError(f"no link {a}<->{b}")
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"degrade factor must be in [0, 1], got {factor}")
        if factor == 0.0 and link.kind != "nvlink":
            raise ValueError("only NVLink edges can go fully down")
        if factor == 1.0:
            self._degraded.pop(key, None)
        else:
            self._degraded[key] = factor

    def restore(self, a: str, b: str) -> None:
        """Undo :meth:`degrade` on the ``a<->b`` link."""
        self._degraded.pop(frozenset((a, b)), None)

    def cancel_staging(
        self, plan: TransferPlan, at_us: Optional[float] = None
    ) -> int:
        """Drop a staged transfer's host-DRAM reservation before it drains
        (a retry chain was exhausted, or a failure made the parked working
        set unreachable — the bytes will never be consumed). Returns bytes
        released (0 when the staging already drained).

        ``at_us`` marks the plan canceled at that instant so the in-flight
        probes stop counting its remaining legs — a transfer canceled and
        replanned at the same timestamp otherwise shows up twice in
        :meth:`inflight_bytes`. Fluid-at-start *pricing* deliberately keeps
        the dead booking (conservative, and byte-identical to the
        pre-planner model); an attached planner instead drops the flight
        and rebooks the survivors at their recovered shares."""
        if not plan.staged:
            return 0
        token = (plan.start_us, plan.arrival_us, plan.nbytes)
        try:
            self._staged.remove(token)
        except ValueError:
            return 0
        if at_us is not None:
            plan.canceled_us = at_us
            if self.planner is not None:
                self.planner.on_cancel(plan, at_us)
        return plan.nbytes

    def _sharers(self, key: FrozenSet[str], at_us: float) -> int:
        """This transfer plus every transfer still active on the link."""
        ends = self._active.setdefault(key, [])
        ends[:] = [e for e in ends if e > at_us]
        return 1 + len(ends)

    # -- planner bookkeeping --------------------------------------------------
    def book(self, plan: TransferPlan) -> None:
        """Commit an externally-priced plan (the attached planner's exact
        piecewise-constant schedule) into the same bookkeeping greedy plans
        use, so ``active_on`` / ``inflight_bytes`` / ``host_staged_bytes``
        and the staging-cancel protocol keep working unchanged."""
        for leg_name, leg_end in plan.legs:
            key = frozenset(leg_name.split("<->"))
            self._active.setdefault(key, []).append(leg_end)
        if plan.staged:
            self._staged.append((plan.start_us, plan.arrival_us, plan.nbytes))
        self.transfers.append(plan)

    def rebook(self, plan: TransferPlan, new_legs: List[Tuple[str, float]]) -> None:
        """Replace a committed plan's leg schedule in place (the planner
        re-solved the fluid schedule after a later admission or a cancel
        changed this flight's shares). Updates the active-end and staging
        ledgers to the new times, counts a replan, and fires
        ``replan_hook(plan, old_arrival_us)`` so the engine can retime the
        arrival event that depends on this landing."""
        old_arrival = plan.arrival_us
        for leg_name, leg_end in plan.legs:
            lst = self._active.get(frozenset(leg_name.split("<->")))
            if lst is not None:
                try:
                    lst.remove(leg_end)
                except ValueError:
                    pass  # already pruned by a _sharers sweep
        for leg_name, leg_end in new_legs:
            key = frozenset(leg_name.split("<->"))
            self._active.setdefault(key, []).append(leg_end)
        new_arrival = new_legs[-1][1] if new_legs else old_arrival
        if plan.staged:
            token = (plan.start_us, old_arrival, plan.nbytes)
            try:
                i = self._staged.index(token)
                self._staged[i] = (plan.start_us, new_arrival, plan.nbytes)
            except ValueError:
                pass  # staging already drained or canceled
        plan.legs = list(new_legs)
        plan.arrival_us = new_arrival
        if new_arrival != old_arrival:
            self.replans += 1
            if self.replan_hook is not None:
                self.replan_hook(plan, old_arrival)

    # -- planning ------------------------------------------------------------
    def plan_transfer(
        self,
        src: str,
        dst: str,
        nbytes: int,
        now: float,
        *,
        kind: str = "bulk",
        urgency: Optional[int] = None,
        task_id: Optional[int] = None,
    ) -> Optional[TransferPlan]:
        """Price moving ``nbytes`` from ``src`` to ``dst`` starting at
        ``now`` and commit the plan to the contention bookkeeping. Returns
        ``None`` (and counts a deferral) when the transfer would need host
        staging beyond the DRAM budget — the caller retries at a later
        rebalance tick, when earlier stagings have drained.

        ``kind``/``urgency``/``task_id`` classify the movement for the
        attached :class:`~repro_torch.cluster.transfer_plan.TransferPlanner`
        (scheduled mode); the greedy model stamps them on the plan and
        otherwise ignores them, so greedy pricing is unchanged."""
        if src == dst:
            raise ValueError("transfer to self")
        if self.planner is not None:
            from repro_torch.cluster.transfer_plan import TransferRequest

            return self.planner.submit_one(
                TransferRequest(src, dst, nbytes, kind, urgency, task_id), now
            )
        path = self.path(src, dst)
        staged = len(path) > 1
        if staged:
            in_use = self.host_staged_bytes(now)
            if in_use + nbytes > self.host_dram_bytes:
                self.deferred += 1
                return None
        t = now
        legs: List[Tuple[str, float]] = []
        for link in path:
            key = link.key()
            share = self._sharers(key, t)
            rate = link.gbps * self.link_factor(key) * 1e3 / share  # bytes/us
            t += nbytes / rate
            self._active[key].append(t)
            legs.append((f"{link.a}<->{link.b}", t))
        if staged:
            self._staged.append((now, t, nbytes))
        plan = TransferPlan(
            src, dst, nbytes, now, t, staged, legs, kind=kind, task_id=task_id
        )
        self.transfers.append(plan)
        return plan

    def plan_restore(
        self,
        dst: str,
        nbytes: int,
        now: float,
        *,
        urgency: Optional[int] = None,
        task_id: Optional[int] = None,
    ) -> Optional[TransferPlan]:
        """Price re-landing ``nbytes`` that already sit in host DRAM (a
        checkpoint restore, or a re-dispatched continuation's warm working
        set) onto ``dst``: one host-link leg, with the bytes charged against
        the staging budget until they land. A saturated budget defers the
        restore (``None`` + a deferral count) — the caller backs off and
        retries, or falls back to another recovery source. An empty payload
        (a checkpoint of a task with nothing resident) lands instantly and
        never touches the link or the staging ledger."""
        if nbytes <= 0:
            return TransferPlan(
                HOST, dst, 0, now, now, False, [], kind="restore",
                task_id=task_id,
            )
        if self.planner is not None:
            from repro_torch.cluster.transfer_plan import TransferRequest

            return self.planner.submit_one(
                TransferRequest(HOST, dst, nbytes, "restore", urgency, task_id),
                now,
            )
        in_use = self.host_staged_bytes(now)
        if in_use + nbytes > self.host_dram_bytes:
            self.deferred += 1
            return None
        link = self._links[frozenset((dst, HOST))]
        key = link.key()
        share = self._sharers(key, now)
        rate = link.gbps * self.link_factor(key) * 1e3 / share
        t = now + nbytes / rate
        self._active[key].append(t)
        plan = TransferPlan(
            HOST, dst, nbytes, now, t, True, [(f"{link.a}<->{link.b}", t)],
            kind="restore", task_id=task_id,
        )
        self._staged.append((now, t, nbytes))
        self.transfers.append(plan)
        return plan


# --------------------------------------------------------------------------
# Page-location directory
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LingerEntry:
    """One migrated task whose working set still (partially) lives in a peer
    GPU's HBM. ``runs`` is the directory's *hint* of what lingers on ``src``;
    the source pool's live residency is always re-checked at fetch time (the
    source may have evicted runs under its own pressure — those sub-runs
    fall back to host DRAM)."""

    task_id: int
    src: str  # GPU whose HBM holds the lingering runs
    dst: str  # GPU the task migrated to (where it will next run)
    runs: List[PageRun]  # merged (sorted, disjoint)
    arrival_us: float  # when the migration manifest lands on dst

    def pages(self) -> int:
        return run_page_count(self.runs)


class PageDirectory:
    """Cluster-wide map of *where a migrated task's resident runs live*.

    The directory is the piece of shared state that turns per-GPU memory
    managers into a cluster co-design: the migration planner consults it to
    source a working set from a peer's HBM over NVLink instead of host DRAM,
    and each GPU's coordinator consults it (via the engine's fleet view) to
    keep lingering runs that a *peer* needs soon out of the local eviction
    head — Belady-OPT over the cluster-wide next-use timeline.

    One entry per task (a task's working set lingers on at most one GPU —
    re-migration reclaims the old copy first). Entries are hints: residency
    truth stays in the owning pool."""

    def __init__(self) -> None:
        self._entries: Dict[int, LingerEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def record(
        self,
        task_id: int,
        src: str,
        dst: str,
        runs: Sequence[PageRun],
        arrival_us: float,
    ) -> LingerEntry:
        entry = LingerEntry(task_id, src, dst, merge_runs(runs), arrival_us)
        self._entries[task_id] = entry
        return entry

    def get(self, task_id: int) -> Optional[LingerEntry]:
        return self._entries.get(task_id)

    def forget(self, task_id: int) -> Optional[LingerEntry]:
        return self._entries.pop(task_id, None)

    def on_gpu(self, src: str) -> Iterator[LingerEntry]:
        """Entries whose lingering runs live on ``src`` (the source GPU's
        coordinator asks this to protect fleet-needed runs)."""
        return (e for e in self._entries.values() if e.src == src)

    def entries(self) -> List[LingerEntry]:
        return list(self._entries.values())

    def retarget(self, task_id: int, new_dst: str) -> None:
        """A queued continuation was stolen/re-routed: its lingering runs
        stay put, but the GPU that will fetch them changed."""
        e = self._entries.get(task_id)
        if e is not None:
            e.dst = new_dst

    def consume(self, task_id: int, fetched: Sequence[PageRun]) -> None:
        """Drop fetched sub-runs from the hint (the peer copy moved to the
        fetching GPU); an emptied entry is forgotten."""
        e = self._entries.get(task_id)
        if e is None:
            return
        e.runs = subtract_runs(e.runs, merge_runs(fetched))
        if not e.runs:
            self._entries.pop(task_id, None)


def homogeneous(
    n: int,
    platform: Platform,
    capacity_bytes: Optional[int] = None,
    host_dram_bytes: int = 512 << 30,
    nvlink_gbps: Optional[float] = None,
    prefix: str = "gpu",
) -> ClusterTopology:
    """N identical GPUs. ``nvlink_gbps`` adds an all-to-all peer mesh."""
    gpus = [GPUNode(f"{prefix}{i}", platform, capacity_bytes) for i in range(n)]
    links: List[Tuple[str, str, float]] = []
    if nvlink_gbps:
        links = [
            (gpus[i].name, gpus[j].name, nvlink_gbps)
            for i in range(n)
            for j in range(i + 1, n)
        ]
    return ClusterTopology(gpus, host_dram_bytes, links)


def mixed(
    nodes: Sequence[Tuple[Platform, Optional[int]]],
    host_dram_bytes: int = 512 << 30,
    nvlinks: Sequence[Tuple[str, str, float]] = (),
    prefix: str = "gpu",
) -> ClusterTopology:
    """Heterogeneous cluster from (platform, capacity_override) pairs."""
    gpus = [
        GPUNode(f"{prefix}{i}", plat, cap) for i, (plat, cap) in enumerate(nodes)
    ]
    return ClusterTopology(gpus, host_dram_bytes, nvlinks)
