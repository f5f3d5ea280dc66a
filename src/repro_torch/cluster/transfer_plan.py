"""Cluster-wide transfer planner: scheduled link-graph migrations.

The greedy model in :mod:`repro_torch.cluster.topology` prices every bulk movement
the moment a caller asks, at a fluid share fixed for the transfer's lifetime
(fluid-at-start). Under a migration storm that goes wrong in three ways: the
share is stale the moment a sharer drains (landing estimates overshoot),
every transfer piles onto the shared host links even when an idle NVLink
path exists, and a speculative rebalance is priced exactly like an RT-class
restore. :class:`TransferPlanner` replaces the greedy commit with a
*scheduled* one — the cluster analogue of the paper's single-GPU thesis that
fragmented, eventual page movements should be coalesced into planned
migrations:

* **Segmented fluid schedule.** All admitted flights advance through one
  discrete-event solve where each link's bandwidth is split equally among
  the flights *currently* on it. Shares are re-evaluated at every leg
  completion, so the schedule is piecewise-constant per link and landing
  times are exact for the model (pinned against an independent event-loop
  simulation in tests/cluster/test_transfer_plan.py).
* **Routing.** A host-staged pair whose host legs are saturated is routed
  over an idle two-hop NVLink detour when one exists (both edges healthy and
  carrying no flights); the detour skips host DRAM staging entirely.
* **Urgency-ordered admission with deferral.** Requests in a window are
  admitted RT restores first, then restores/deadline-retries, then peer
  fetches, then speculative rebalances and snapshots. A *speculative* move
  whose projected landing exceeds ``defer_stretch ×`` its uncontended floor
  — the storm's marginal makespan contribution dwarfs the move's urgency —
  is deferred (``None``; callers already retry at the next tick).
* **Rebooking.** Admitting a flight slows the flights it now shares links
  with; canceling one speeds the survivors up. The planner re-solves and
  rewrites the committed plans in place through
  :meth:`~repro_torch.cluster.topology.ClusterTopology.rebook`, which fires the
  topology's ``replan_hook`` so the engine retimes the dependent arrival
  events. Probes (``active_on``/``inflight_bytes``/``host_staged_bytes``)
  keep reading the same ledgers they always did.
* **Peer-fetch pressure feedback.** :meth:`linger_retention_ok` weighs a
  lingering run's NVLink refetch saving against the local misses its
  retention causes, and always yields to the eviction scavenger under zero
  headroom — retention is advisory, so eviction progress never waits on a
  transfer (no-deadlock property test in the conservation suite).

The planner is constructed only by ``simulate_cluster(transfer_plan="auto")``
on multi-GPU fleets; with ``transfer_plan="greedy"`` (the default) it is
never built and every path is bit-for-bit the pre-planner model.

Copied from the JAX package's ``cluster/transfer_plan.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core.simulator import active_demand_pages
from repro_torch.cluster.topology import (
    HOST,
    ClusterTopology,
    Link,
    LingerEntry,
    TransferPlan,
)
from repro_torch.telemetry.hub import TRACK_CLUSTER

# urgency classes, lowest admits first. Deadline-rejected retries and
# RT-class restores outrank speculative rebalances; only SPECULATIVE moves
# are ever deferred by the marginal-makespan test.
URGENCY_RT = 0  # RT-class fault restores / re-dispatches
URGENCY_RESTORE = 1  # best-effort restores, deadline-rejected retries
URGENCY_FETCH = 2  # peer working-set fetches feeding a live switch
URGENCY_SPECULATIVE = 3  # rebalance checkpoints/manifests, vault snapshots

_KIND_URGENCY = {
    "restore": URGENCY_RESTORE,
    "peer_fetch": URGENCY_FETCH,
}


@dataclasses.dataclass
class TransferRequest:
    """One pending bulk movement submitted to the planner. ``urgency`` of
    ``None`` resolves from ``kind`` (restores urgent, everything else
    speculative); ``task_id`` lets the engine retime the dependent arrival
    when a later admission rebooks this flight's landing."""

    src: str
    dst: str
    nbytes: int
    kind: str = "bulk"
    urgency: Optional[int] = None
    task_id: Optional[int] = None

    def effective_urgency(self) -> int:
        if self.urgency is not None:
            return self.urgency
        return _KIND_URGENCY.get(self.kind, URGENCY_SPECULATIVE)


class _Flight:
    """One admitted transfer's progress through the fluid schedule."""

    __slots__ = (
        "fid", "req", "links", "caps", "leg_names", "staged", "detour",
        "start_us", "leg", "rem", "leg_ends", "landed_us", "plan", "solo_us",
    )

    def __init__(
        self,
        fid: int,
        req: TransferRequest,
        links: List[Link],
        caps: List[float],
        staged: bool,
        detour: bool,
        start_us: float,
    ):
        self.fid = fid
        self.req = req
        self.links = links
        # per-leg capacity (bytes/us) frozen at submit: like greedy plans,
        # in-flight transfers keep their rates through later link degrades —
        # only new admissions see the changed factor
        self.caps = caps
        self.leg_names = [f"{l.a}<->{l.b}" for l in links]
        self.staged = staged
        self.detour = detour
        self.start_us = start_us
        self.leg = 0  # index of the leg currently flowing
        self.rem = float(req.nbytes)  # bytes left on the current leg
        self.leg_ends: List[float] = []  # absolute end of each finished leg
        self.landed_us: Optional[float] = None
        self.plan: Optional[TransferPlan] = None
        self.solo_us = sum(
            req.nbytes / c for c in caps if c > 0.0
        ) if req.nbytes > 0 else 0.0


class _St:
    """Mutable DES state for one flight (copied for projections)."""

    __slots__ = ("f", "leg", "rem", "ends")

    def __init__(self, f: _Flight):
        self.f = f
        self.leg = f.leg
        self.rem = f.rem
        self.ends: List[float] = []


Segment = Tuple[float, float, Tuple[Tuple[int, float], ...]]


class TransferPlanner:
    """Scheduled transfer admission over a :class:`ClusterTopology`.

    ``defer_stretch`` bounds how much contention a *speculative* move may
    absorb before it is deferred to a later window; ``saturation_depth`` is
    the host-leg queue depth at which a host-staged pair starts looking for
    an idle NVLink detour."""

    def __init__(
        self,
        topology: ClusterTopology,
        telemetry=None,
        defer_stretch: float = 3.0,
        saturation_depth: int = 2,
    ):
        self.topology = topology
        self.telemetry = telemetry
        self.defer_stretch = defer_stretch
        self.saturation_depth = saturation_depth
        self.reset()

    def reset(self) -> None:
        self._t = 0.0  # committed schedule time (never moves backwards)
        self._fid = 0
        self._flights: List[_Flight] = []  # in flight, fluid schedule order
        self.log: List[_Flight] = []  # every admitted flight, for probes
        # link key -> finalized bandwidth segments (t0, t1, ((fid, rate),..))
        # — the committed piecewise-constant schedule, what the conservation
        # suite integrates
        self.history: Dict[FrozenSet[str], List[Segment]] = {}
        self.windows = 0
        self.urgency_deferred = 0
        self.detours = 0
        self.landed = 0
        self._scavenged: Set[int] = set()

    # -- fluid DES kernel ----------------------------------------------------
    def _run_fluid(
        self,
        states: List[_St],
        t: float,
        until: Optional[float] = None,
        record=None,
    ) -> float:
        """Advance ``states`` through the equal-share fluid model from ``t``
        to ``until`` (or to completion). Each iteration holds shares
        constant until the next leg completion — the piecewise-constant
        segment — then re-evaluates. ``record(key, t0, t1, flows)`` gets
        every non-empty segment per link. Returns the stop time."""
        while True:
            live = [s for s in states if s.leg < len(s.f.links)]
            if not live:
                return t
            occ: Dict[FrozenSet[str], int] = {}
            for s in live:
                k = s.f.links[s.leg].key()
                occ[k] = occ.get(k, 0) + 1
            rates: List[float] = []
            dt = math.inf
            for s in live:
                r = s.f.caps[s.leg] / occ[s.f.links[s.leg].key()]
                rates.append(r)
                if r > 0.0:
                    dt = min(dt, s.rem / r)
            end = t + dt
            partial = until is not None and end > until
            if partial:
                end = until
            if record is not None and end > t:
                flows: Dict[FrozenSet[str], List[Tuple[int, float]]] = {}
                for s, r in zip(live, rates):
                    flows.setdefault(
                        s.f.links[s.leg].key(), []
                    ).append((s.f.fid, r))
                for k, fl in flows.items():
                    record(k, t, end, tuple(fl))
            span = end - t
            if span > 0.0:
                for s, r in zip(live, rates):
                    s.rem -= r * span
            t = end
            if partial:
                return t
            for s, r in zip(live, rates):
                eps = 1e-6 + 1e-9 * s.f.req.nbytes
                # fp guard: a residue whose drain time is below the spacing
                # of ``t`` cannot advance the clock (t + dt == t) — without
                # forcing it to land here the loop would spin forever on a
                # tiny manifest at a large timestamp
                stuck = r > 0.0 and s.rem / r <= 4.0 * math.ulp(max(t, 1.0))
                if r > 0.0 and (s.rem <= eps or stuck):
                    s.ends.append(t)
                    s.leg += 1
                    s.rem = (
                        float(s.f.req.nbytes)
                        if s.leg < len(s.f.links)
                        else 0.0
                    )

    def _record_history(
        self, key: FrozenSet[str], t0: float, t1: float, flows
    ) -> None:
        self.history.setdefault(key, []).append((t0, t1, flows))

    def _advance(self, now: float) -> None:
        """Commit the fluid schedule up to ``now``: finalize segments into
        ``history``, land finished flights, drop them from the active set."""
        if now <= self._t:
            return
        states = [_St(f) for f in self._flights]
        self._run_fluid(states, self._t, until=now, record=self._record_history)
        for st in states:
            f = st.f
            f.leg, f.rem = st.leg, st.rem
            f.leg_ends.extend(st.ends)
            if f.leg >= len(f.links):
                f.landed_us = f.leg_ends[-1]
                self.landed += 1
        self._flights = [f for f in self._flights if f.landed_us is None]
        self._t = now

    def _project(
        self, extra: Optional[_Flight] = None
    ) -> Tuple[Dict[int, List[float]], float]:
        """Landing projection: run the active flights (plus ``extra``) to
        completion on copied state. Returns the full absolute leg-end list
        per flight id and the projected makespan."""
        flights = self._flights + ([extra] if extra is not None else [])
        states = [_St(f) for f in flights]
        t = self._run_fluid(states, self._t)
        out = {st.f.fid: st.f.leg_ends + st.ends for st in states}
        return out, t

    # -- routing -------------------------------------------------------------
    def _queue_depth(self, key: FrozenSet[str]) -> int:
        """Flights with any remaining leg on the link — the per-link queue
        the saturation check and the telemetry probe read."""
        n = 0
        for f in self._flights:
            for i in range(f.leg, len(f.links)):
                if f.links[i].key() == key:
                    n += 1
                    break
        return n

    def link_queue_depths(
        self, now: Optional[float] = None
    ) -> Dict[FrozenSet[str], int]:
        if now is not None:
            self._advance(now)
        out: Dict[FrozenSet[str], int] = {}
        for f in self._flights:
            for key in {f.links[i].key() for i in range(f.leg, len(f.links))}:
                out[key] = out.get(key, 0) + 1
        return out

    def _find_detour(self, src: str, dst: str) -> Optional[List[Link]]:
        """An idle two-hop NVLink path src→x→dst: both edges healthy peers
        carrying no flights. Deterministic: lowest GPU name wins."""
        topo = self.topology
        for name in sorted(g.name for g in topo.gpus):
            if name in (src, dst):
                continue
            l1 = topo.nvlink_peer(src, name)
            l2 = topo.nvlink_peer(name, dst)
            if l1 is None or l2 is None:
                continue
            if self._queue_depth(l1.key()) or self._queue_depth(l2.key()):
                continue
            return [l1, l2]
        return None

    def _route(self, src: str, dst: str) -> Tuple[List[Link], bool, bool]:
        """Pick the leg sequence for a movement: ``(links, staged, detour)``.
        Host-staged pairs check the host-leg queue depth first and take an
        idle NVLink detour (no DRAM staging) when the host path is
        saturated."""
        topo = self.topology
        if dst == HOST:
            return [topo.link(src, HOST)], False, False
        if src == HOST:
            return [topo.link(dst, HOST)], True, False
        direct = topo.nvlink_peer(src, dst)
        if direct is not None:
            return [direct], False, False
        h1 = topo.link(src, HOST)
        h2 = topo.link(dst, HOST)
        depth = max(self._queue_depth(h1.key()), self._queue_depth(h2.key()))
        if depth >= self.saturation_depth:
            det = self._find_detour(src, dst)
            if det is not None:
                return det, False, True
        return [h1, h2], True, False

    # -- admission -----------------------------------------------------------
    def _admit(
        self, req: TransferRequest, now: float, pending_staged: int
    ) -> Optional[_Flight]:
        links, staged, detour = self._route(req.src, req.dst)
        if staged:
            in_use = self.topology.host_staged_bytes(now)
            if (
                in_use + pending_staged + req.nbytes
                > self.topology.host_dram_bytes
            ):
                self.topology.deferred += 1
                return None
        caps = [
            l.gbps * self.topology.link_factor(l.key()) * 1e3 for l in links
        ]
        flight = _Flight(self._fid, req, links, caps, staged, detour, now)
        if (
            req.effective_urgency() >= URGENCY_SPECULATIVE
            and self._flights
            and flight.solo_us > 0.0
        ):
            proj, _ = self._project(extra=flight)
            landing = proj[flight.fid][-1]
            if landing - now > self.defer_stretch * flight.solo_us:
                self.urgency_deferred += 1
                self.topology.deferred += 1
                return None
        self._fid += 1
        if detour:
            self.detours += 1
        self.log.append(flight)
        return flight

    def submit(
        self, requests: Sequence[TransferRequest], now: float
    ) -> List[Optional[TransferPlan]]:
        """Admit one window of pending movements. Requests are considered
        in urgency order (stable within a class), priced against the shared
        fluid schedule, and committed as :class:`TransferPlan`\\ s through
        the topology's ledgers. Results align with ``requests``; ``None``
        means deferred (budget or urgency) — the caller retries later,
        exactly as with a greedy budget deferral."""
        self._advance(now)
        self.windows += 1
        results: List[Optional[TransferPlan]] = [None] * len(requests)
        order = sorted(
            range(len(requests)),
            key=lambda i: (requests[i].effective_urgency(), i),
        )
        admitted: List[Tuple[int, _Flight]] = []
        pending_staged = 0
        for i in order:
            flight = self._admit(requests[i], now, pending_staged)
            if flight is None:
                continue
            if flight.staged:
                pending_staged += requests[i].nbytes
            self._flights.append(flight)
            admitted.append((i, flight))
        proj, makespan = self._project()
        new_fids = {f.fid for _, f in admitted}
        for i, f in admitted:
            ends = proj[f.fid]
            legs = list(zip(f.leg_names, ends))
            plan = TransferPlan(
                f.req.src, f.req.dst, f.req.nbytes, now,
                ends[-1] if ends else now, f.staged, legs,
                kind=f.req.kind, task_id=f.req.task_id,
            )
            f.plan = plan
            self.topology.book(plan)
            results[i] = plan
        self._rebook_changed(proj, skip=new_fids)
        if self.telemetry is not None:
            self.telemetry.span(
                "transfer_plan", TRACK_CLUSTER, now,
                max(0.0, makespan - now),
                requests=len(requests), admitted=len(admitted),
                deferred=self.urgency_deferred,
                replans=self.topology.replans, detours=self.detours,
                in_flight=len(self._flights),
            )
        return results

    def submit_one(
        self, req: TransferRequest, now: float
    ) -> Optional[TransferPlan]:
        return self.submit([req], now)[0]

    def _rebook_changed(
        self, proj: Dict[int, List[float]], skip: Set[int] = frozenset()
    ) -> None:
        for f in self._flights:
            if f.fid in skip or f.plan is None:
                continue
            ends = proj[f.fid]
            legs = list(zip(f.leg_names, ends))
            if any(
                abs(e - old) > 1e-6
                for (_, e), (_, old) in zip(legs, f.plan.legs)
            ):
                self.topology.rebook(f.plan, legs)

    def on_cancel(self, plan: TransferPlan, at_us: float) -> None:
        """A committed flight's payload will never be consumed
        (``cancel_staging``): drop it from the schedule, release its future
        leg bookings, and rebook the survivors at their recovered shares."""
        self._advance(at_us)
        victim = next(
            (f for f in self._flights if f.plan is plan), None
        )
        if victim is None:
            return
        self._flights.remove(victim)
        for leg_name, leg_end in plan.legs:
            if leg_end <= at_us:
                continue
            lst = self.topology._active.get(frozenset(leg_name.split("<->")))
            if lst is not None:
                try:
                    lst.remove(leg_end)
                except ValueError:
                    pass
        proj, _ = self._project()
        self._rebook_changed(proj)

    # -- peer-fetch pressure feedback ----------------------------------------
    def linger_retention_ok(
        self, entry: LingerEntry, src_core, now: float
    ) -> bool:
        """Should the eviction scavenger keep protecting this lingering
        working set? ``False`` the moment the holder has zero free headroom
        (eviction must always make progress — protection is advisory, so no
        transfer ever waits on a page whose eviction waits on the transfer),
        and whenever the NVLink refetch saving the copy buys its target no
        longer covers the local misses its retention causes."""
        pool = src_core.pool
        if pool.capacity - pool.used <= 0:
            self._scavenged.add(entry.task_id)
            return False
        linger_pages = entry.pages()
        if linger_pages <= 0:
            return False
        nv = self.topology.nvlink_peer(entry.src, entry.dst)
        if nv is None:
            # target can no longer peer-fetch: retention saves nothing
            self._scavenged.add(entry.task_id)
            return False
        st = src_core.state_view()
        quantum = getattr(st.policy, "quantum_us", 5_000.0)
        demand = active_demand_pages(st, quantum) + st.waiting_pages
        overflow = demand - (pool.capacity - linger_pages)
        if overflow <= 0:
            return True  # retention costs the holder nothing
        page = src_core.page_size
        topo = self.topology
        dst_host = topo.link(entry.dst, HOST)
        src_host = topo.link(entry.src, HOST)
        host_fetch = dst_host.gbps * topo.link_factor(dst_host.key()) * 1e3
        host_miss = src_host.gbps * topo.link_factor(src_host.key()) * 1e3
        nv_rate = nv.gbps * topo.link_factor(nv.key()) * 1e3
        if host_fetch <= 0.0 or host_miss <= 0.0:
            return True
        saving_us = linger_pages * page * max(
            0.0, 1.0 / host_fetch - 1.0 / nv_rate
        )
        miss_us = min(linger_pages, overflow) * page / host_miss
        if saving_us < miss_us:
            self._scavenged.add(entry.task_id)
            return False
        return True

    @property
    def pressure_scavenged(self) -> int:
        """Distinct linger copies the pressure feedback released to the
        eviction scavenger."""
        return len(self._scavenged)
