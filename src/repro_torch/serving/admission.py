"""Admission control: SLO feasibility quoting, load shedding, preemption.

EdgeBERT's sentence-level DVFS (paper Alg. 1) only saves energy when the
prescribed target latency is ACHIEVABLE — the controller scales (V, f) down
into the slack between the predicted exit and the deadline.  A serving stack
that accepts every ``Request.deadline_s`` unconditionally therefore fails in
the exact regime edge deployments live in: under oversubscription there is no
slack, the arbiter pins the clock at the maximum point, and accepted SLOs are
missed anyway — the worst of both worlds (max energy AND broken contracts).

``AdmissionController`` sits in FRONT of ``LaneScheduler.submit()`` and
closes that gap with three mechanisms:

* **Feasibility quoting** — at submission time, every explicit SLO is priced
  against the same models the runtime schedules with: the per-bucket cycle
  model (``LatencyAwareDVFSController.cycles_for_seq_len`` /
  ``hwmodel.scale_stats_to_seq_len``), the arbiter's MAXIMUM operating point
  (``BatchedDVFSArbiter.min_latency_quote`` — no schedule can beat the top
  table entry, plus one worst-case LDO/ADPLL switching stall), the
  entropy-LUT predicted exit depth (``predict_remaining_steps``; cold
  requests quote the conservative full depth), and the CURRENT queue state.
  Decoder SLOs price the same way off the TOKEN-level predictor: the
  engine's ``predict_remaining_steps`` returns fractional full-depth fused
  steps from the position-binned exit LUT and ``_cycles_for`` the
  full-depth fused-step cycles, so a warm calibrator tightens decode quotes
  while a cold one quotes every remaining token at full depth.
  Self-speculative decode (``DecoderServer(spec_window=...)``) needs no
  quote-side special case, by construction: quotes price predicted LAYERS,
  and a speculative fused step runs the same accepted-token exit depths in
  fewer, proportionally longer steps — the modeled compute time is
  identical and the saved per-step switch-stall opportunities only shorten
  realized latency.  The quote therefore stays one-sided under
  speculation (never under-prices realized latency), which
  the JAX package's tests/test_spec_properties.py pins for random cls+dec
  mixes on a shared
  clock; the calibrator those quotes read is fed EVERY accepted token's
  realized depth (one observation per token, not per block).
  Lane availability is priced by the deadline structure, not by max-op
  completion times: Alg. 1 deliberately stretches every slack-rich lane to
  finish JUST IN TIME, so an outstanding contract occupies its lane up to
  its own absolute deadline and a new arrival waits (at worst) for the
  lanes-th largest outstanding deadline in its bucket, plus other buckets'
  serialized explicit backlog.  Cross-traffic (other buckets, and other
  ENGINES sharing the arbiter's clock) is priced by the same stretched-
  occupancy logic: its remaining work at the SLOWEST operating point,
  capped by its deadline structure — max-op pricing there was refutably
  optimistic (the pinned counterexample in the JAX package's
  tests/test_arbiter_properties.py, now a passing regression test).  An SLO below the quote is **rejected** — the
  caller receives the minimum feasible deadline — or, with
  ``on_infeasible="requote"``, admitted at that quoted deadline instead of
  the infeasible one.

* **Load shedding** — best-effort (deadline-free) traffic gets a bounded
  per-bucket queue with an oldest-drop policy: under a sustained tight-SLO
  storm the best-effort backlog stays bounded (bounded queue => bounded
  queueing delay for everything that DOES run) instead of growing without
  limit behind an endless stream of contracts.  Explicit SLOs are never shed
  (they were quoted), and neither are preempted requests holding a
  checkpoint (their completed layers would be wasted).

* **Preemption awareness** — when the scheduler runs with ``preempt=True``
  (lane checkpointing), an explicit request's lane wait is bounded by ONE
  fused step (evict a budget-free lane, restore it later) instead of one
  retire, and the quote prices it that way.

The quote is deliberately CONSERVATIVE — cold requests are priced at full
depth, accepted explicit work is serialized — because the contract it backs
is one-sided: a quote may overestimate (we reject work we could have served)
but must not underestimate (an accepted SLO must be met).  The benchmark
gate is exactly that asymmetry: ``accepted_slo_misses == 0`` with
``rejected > 0`` under an oversubscribed storm.

This is a copy of the JAX package's ``serving/admission.py`` (numpy and
Python only), so the port's engines, the ``ClassifierServer`` and the
``DecoderServer``, sit behind the same gate, with the decoder's pricing
(token-level predicted depth, cross-engine backlog on a shared arbiter)
unchanged.  A server with replicas (``replicas > 1``: both engines) is
quoted per replica, each against its own lane slab, pinned queue share and
clock domain, and an accepted contract is pinned to the replica its
``PlacementPolicy`` chose, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Protocol, TYPE_CHECKING

import numpy as np

from repro_torch.serving.scheduler import LaneScheduler

if TYPE_CHECKING:  # circular: engine imports scheduler
    from repro_torch.serving.engine import Request


@dataclass
class Quote:
    """Feasibility quote for one explicit-SLO request at submission time.

    All figures are RELATIVE modeled seconds from the submission instant
    (an SLO is submission-anchored, so arrival == now at quote time).
    """

    bucket: int
    service_s: float        # own predicted compute at the max operating point
    wait_s: float           # modeled wait for a lane (explicit backlog +
                            # lane availability, preemption-bounded)
    min_deadline_s: float   # earliest feasible relative deadline, headroom
                            # included — an SLO >= this is accepted
    feasible: bool          # requested deadline_s >= min_deadline_s
    replica: Optional[int] = None   # clock domain this quote priced (None =
                                    # whole fleet / single-replica server)


class PlacementPolicy(Protocol):
    """Chooses which per-replica quote an accepted contract is routed to.

    ``choose`` receives one ``Quote`` per replica (all for the SAME request,
    priced against that replica's lanes, queue share, and clock domain) and
    returns the one to route to — the request is then PINNED to
    ``quote.replica`` so the scheduler only refills that domain's lanes with
    it.  Called only when at least one quote is feasible."""

    def choose(self, quotes: List[Quote]) -> Quote: ...


class LeastLoadedPlacement:
    """Route to the replica quoting the earliest feasible deadline.

    Greedy latency-optimal: the chosen replica is the one that can serve the
    request SOONEST, which spreads load and maximizes each arrival's own
    slack (hence the DVFS arbiter's energy headroom on that replica)."""

    def choose(self, quotes: List[Quote]) -> Quote:
        return min(quotes, key=lambda q: (q.min_deadline_s, q.wait_s))


class DeadlinePackedPlacement:
    """Route to the BUSIEST replica that still quotes the SLO feasible.

    Best-fit packing: concentrating contracts on already-loaded domains
    keeps the remaining replicas slack-rich — their arbiters can hold deep
    low-(V, f) points (or the fleet can later park them entirely), and
    future tight SLOs still find an empty domain to land on."""

    def choose(self, quotes: List[Quote]) -> Quote:
        return max(quotes, key=lambda q: (q.min_deadline_s, q.wait_s))


@dataclass
class AdmissionDecision:
    """What ``AdmissionController.submit`` did with a request."""

    admitted: bool
    action: str                       # "accepted" | "requoted" | "rejected"
    bucket: int
    quote: Optional[Quote] = None     # explicit-SLO requests only
    shed: List["Request"] = field(default_factory=list)  # best-effort victims
                                      # dropped to bound the queue


class AdmissionController:
    """Feasibility gate in front of a serving engine's ``submit()``.

    Parameters
    ----------
    server:  a serving engine (``ClassifierServer`` / ``DecoderServer`` —
             anything exposing ``.sched`` and ``.submit``) or a bare
             ``LaneScheduler``.
    headroom:
             multiplier applied to the raw (wait + service) estimate before
             the feasibility comparison; absorbs scheduling granularity and
             arbitration stalls the analytic quote cannot see.  The quote
             handed back to callers (``min_deadline_s``) includes it, so a
             rejected caller who resubmits at the quote is accepted.
    on_infeasible:
             ``"reject"`` (default) refuses the request — it never enters a
             queue and the decision carries the minimum feasible deadline —
             or ``"requote"``: admit at the quoted deadline instead (the
             original SLO is preserved on ``req.quoted_deadline_s``).
    max_best_effort_queue:
             bounded-queue depth for deadline-free traffic, per bucket
             (``None`` = unbounded).  Submitting past the bound sheds the
             OLDEST queued best-effort request(s) first.
    fallback_steps:
             predicted steps for a request when the engine offers no
             ``predict_remaining_steps`` hook (bare schedulers in tests).
    placement:
             ``PlacementPolicy`` routing accepted contracts across a
             sharded server's replicas (default ``LeastLoadedPlacement``).
             Ignored on single-replica servers.
    extra_wait_s:
             optional zero-arg callable priced into every quote's wait term.
             This is the cross-SERVER demand hook: sibling engines' QUEUED
             work is invisible through the shared arbiter (only their
             in-flight lanes are), so a multi-server router that can see its
             siblings' queues prices them here — without it, sustained
             bursty multi-task load admits contracts whose wait the sibling
             backlog then overruns (found by the trace-replay harness).
             Must return an upper bound in modeled seconds; conservative
             over-pricing only costs rejections, never a broken contract.
    """

    def __init__(
        self,
        server: Any,
        *,
        headroom: float = 1.25,
        on_infeasible: str = "reject",
        max_best_effort_queue: Optional[int] = None,
        fallback_steps: float = 1.0,
        placement: Optional[PlacementPolicy] = None,
        extra_wait_s: Optional[Callable[[], float]] = None,
    ):
        assert headroom >= 1.0, "headroom < 1 would quote below the estimate"
        assert on_infeasible in ("reject", "requote")
        assert max_best_effort_queue is None or max_best_effort_queue >= 1
        self.server = server
        self.sched: LaneScheduler = (
            server if isinstance(server, LaneScheduler) else server.sched
        )
        self.headroom = float(headroom)
        self.on_infeasible = on_infeasible
        self.max_best_effort_queue = max_best_effort_queue
        self.fallback_steps = float(fallback_steps)
        self.placement: PlacementPolicy = (
            LeastLoadedPlacement() if placement is None else placement
        )
        self.extra_wait_s = extra_wait_s

    # ----------------------------------------------------------- replicas
    def _replicas(self) -> int:
        return int(getattr(self.server, "replicas", 1) or 1)

    def _lane_range(self, replica: Optional[int]) -> range:
        """Lane indices a quote scans: one replica's contiguous slab, or
        every lane when ``replica`` is None (single-domain pricing)."""
        if replica is None:
            return range(self.sched.lanes)
        lpr = int(
            getattr(self.server, "lanes_per_replica", self.sched.lanes)
        )
        return range(replica * lpr, (replica + 1) * lpr)

    @staticmethod
    def _pin_ok(req: "Request", replica: Optional[int]) -> bool:
        """A queued contract competes for a replica's lanes iff unpinned or
        pinned to that replica (the scheduler enforces the same rule)."""
        if replica is None:
            return True
        pin = getattr(req, "replica", None)
        return pin is None or pin == replica

    # ------------------------------------------------------------- quoting
    def _predict_steps(self, bucket: int, req: "Request", depth: int) -> float:
        rem = self.sched._predict_remaining(bucket, req, depth)
        if rem is None:
            rem = self.fallback_steps
        # a preempted request only needs its remaining depth
        return max(float(rem), 1.0)

    def _service_s(self, bucket: int, steps: float) -> float:
        """Own compute floor: ``steps`` fused steps at the max operating
        point.  With a shared-clock arbiter this is the arbiter's quote (per
        -bucket cycles at max V/f plus one worst-case switching stall);
        otherwise the scheduler's nominal per-bucket step time, which engines
        with a hw model already define as the max-op layer time.

        ``steps`` is fractional full-depth fused steps, i.e. LAYERS over
        n_layers — deliberately invariant under speculative blocking: a
        spec-enabled server repacks the same layers into fewer, longer
        steps, so this floor remains one-sided (see module docstring)."""
        arb = getattr(self.server, "arbiter", None)
        cycles_for = getattr(self.server, "_cycles_for", None)
        if arb is not None and cycles_for is not None:
            return arb.min_latency_quote(
                steps, cycles_per_layer=cycles_for(bucket)
            )
        return steps * float(self.sched.step_time_fn(bucket))

    def _outstanding_deadlines(
        self, bucket: int, replica: Optional[int] = None
    ) -> List[float]:
        """Absolute deadlines of every outstanding explicit contract in a
        bucket — in-flight lanes AND queued (already-accepted) requests.
        With ``replica``, only that domain's lanes and the queued contracts
        that could land on them (unpinned or same-pin)."""
        sched = self.sched
        out = []
        run = sched._open.get(bucket)
        if run is not None:
            for i in self._lane_range(replica):
                r = run.lane_req[i]
                if r is not None and r.deadline_s is not None:
                    out.append(r.arrival_s + r.deadline_s)
        out.extend(
            r.arrival_s + r.deadline_s
            for r in sched.queues.get(bucket, ())
            if r.deadline_s is not None and self._pin_ok(r, replica)
        )
        return out

    def _own_bucket_wait_s(
        self, bucket: int, replica: Optional[int] = None
    ) -> float:
        """Upper bound on the wait for a lane in the request's OWN bucket.

        The key subtlety is that accepted contracts do NOT free their lanes
        at max-op speed: the DVFS arbiter deliberately stretches slack-rich
        lanes to finish JUST IN TIME (that is Alg. 1's energy mechanism), so
        a lane holding a contract is occupied up to that contract's absolute
        deadline.  Every outstanding contract was admission-quoted feasible
        (completes by its own deadline), hence with ``lanes`` lane slots a
        new arrival waits at most until the lanes-th LARGEST outstanding
        deadline — before that instant at least one slot must have cleared.

        With fewer outstanding contracts than lanes, the arrival takes the
        (k+1)-th lane to come free, where k is the number of QUEUED
        contracts — EDF pops them first, so they claim the first freed
        lanes.  Per-lane free times: zero for a free lane, the contract's
        own absolute deadline for an in-flight explicit lane, one fused
        step for a preemptible budget-free lane, else that lane's predicted
        retire.

        With ``replica``, the same pricing restricted to that clock domain:
        its lane slab, and only the queued contracts that could land there
        (unpinned or same-pin) count toward the backlog."""
        sched = self.sched
        dt = float(sched.step_time_fn(bucket))
        lanes_idx = self._lane_range(replica)
        lanes_n = len(lanes_idx)
        deadlines = self._outstanding_deadlines(bucket, replica)
        if len(deadlines) >= lanes_n:
            d_l = sorted(deadlines, reverse=True)[lanes_n - 1]
            return max(0.0, d_l - sched.now_s)
        k = sum(
            1
            for r in sched.queues.get(bucket, ())
            if r.deadline_s is not None and self._pin_ok(r, replica)
        )
        run = sched._open.get(bucket)
        free_at = []
        for i in lanes_idx:
            req = run.lane_req[i] if run is not None else None
            if req is None:
                free_at.append(0.0)
            elif req.deadline_s is not None:
                free_at.append(
                    max(0.0, req.arrival_s + req.deadline_s - sched.now_s)
                )
            elif sched.preempt:
                free_at.append(dt)      # checkpoint-evict at the next refill
            else:
                rem = self._predict_steps(bucket, req, int(run.lane_depth[i]))
                free_at.append(rem * dt)
        return sorted(free_at)[min(k, lanes_n - 1)]

    def _slow_step_time_s(self, bucket: int) -> Optional[float]:
        """One fused step of ``bucket`` at the SLOWEST operating point — the
        unconditional occupancy bound for cross-traffic on a shared clock
        (every step the arbiter schedules runs at >= table[0].freq_hz, so no
        contract can hold the clock longer than its work priced here).
        None without a hw model (bare schedulers have no op table)."""
        ctrl = getattr(self.server, "_ctrl", None)
        cycles_for = getattr(self.server, "_cycles_for", None)
        if ctrl is None or cycles_for is None:
            return None
        cyc = cycles_for(bucket)
        return None if cyc is None else cyc / ctrl.table[0].freq_hz

    def _cross_bucket_backlog_s(self, bucket: int) -> float:
        """Clock time OTHER buckets' explicit work steals before ours runs:
        the scheduler advances one bucket per step and EDF ranks explicit
        work above everything, so a contract conservatively waits for other
        buckets' contracts too.  In-flight lanes advance together (max
        remaining steps), queued contracts share lanes (summed work over the
        lane count).

        Pricing: Alg. 1 STRETCHES slack-rich cross-traffic toward its
        deadline, so max-op step times are refutably optimistic here (the
        pinned counterexample in the JAX package's tests).  With a
        hw model each bucket's steal is priced as the smaller of two valid
        upper bounds: its work serialized at the SLOWEST operating point
        (no schedule can run slower), capped by its deadline structure (an
        admitted contract's lane is occupied at most until its own absolute
        deadline, exactly as ``_own_bucket_wait_s`` prices lanes).  Bare
        schedulers keep the nominal step-time pricing."""
        sched = self.sched
        total = 0.0
        for b in set(sched.queues) | set(sched._open):
            if b == bucket:
                continue
            dt_slow = self._slow_step_time_s(b)
            dt = float(sched.step_time_fn(b)) if dt_slow is None else dt_slow
            max_rem = 0.0
            latest_deadline = None
            run = sched._open.get(b)
            if run is not None:
                for i in range(sched.lanes):
                    req = run.lane_req[i]
                    if req is not None and req.deadline_s is not None:
                        rem = self._predict_steps(b, req, int(run.lane_depth[i]))
                        max_rem = max(max_rem, rem)
                        d_abs = req.arrival_s + req.deadline_s
                        if latest_deadline is None or d_abs > latest_deadline:
                            latest_deadline = d_abs
            q_steps = 0.0
            for r in sched.queues.get(b, ()):
                if r.deadline_s is None:
                    continue
                q_steps += self._predict_steps(b, r, r.ckpt_depth)
                d_abs = r.arrival_s + r.deadline_s
                if latest_deadline is None or d_abs > latest_deadline:
                    latest_deadline = d_abs
            steal = (max_rem + np.ceil(q_steps / sched.lanes)) * dt
            if dt_slow is not None and latest_deadline is not None:
                # after the latest outstanding deadline the bucket holds no
                # explicit work — whichever bound is tighter is still valid
                steal = min(steal, max(0.0, latest_deadline - sched.now_s))
            total += steal
        return total

    def _cross_engine_backlog_s(self, replica: Optional[int] = None) -> float:
        """Clock time OTHER ENGINES' in-flight lanes steal on the shared
        arbiter.  One LDO/ADPLL pair serves every server on the arbiter, so
        a classifier quote that ignores a co-resident decoder's contracts
        (or vice versa) is optimistic on exactly the shared-clock mixes the
        arbiter exists for — the cross-ENGINE half of the pinned
        counterexample.

        Each foreign lane is priced by the SMALLER of two valid upper
        bounds: its remaining work serialized at the SLOWEST operating point
        (predicted remaining layers when the lane publishes them, else the
        conservative full remaining depth, times the lane's admitted
        per-layer cycle cost — no arbiter schedule runs slower), capped by
        the lane's own deadline structure — an admitted contract occupies
        the clock at most until its own absolute deadline, after which only
        its max-op escalation tail remains (the arbiter pins overdue lanes
        at the top table entry).  Slow-op-only pricing over-rejected
        feasible mixes whenever a tight-deadline foreign lane carried deep
        remaining work: its deadline already bounds the steal far below the
        slow-op serialization.  Summed per lane — lanes stepping together
        are charged the max, so the sum over-counts concurrency, which only
        errs conservative (the quote contract is one-sided).  Foreign queued
        work is not visible through the arbiter; the headroom multiplier
        absorbs it.

        With ``replica``, prices that clock domain's OWN arbiter — each
        replica carries an independent LDO/ADPLL pair, so foreign lanes on
        other replicas' arbiters steal nothing here."""
        arbs = getattr(self.server, "arbiters", None)
        if replica is not None and arbs:
            arb = arbs[replica]
        else:
            arb = getattr(self.server, "arbiter", None)
        if arb is None:
            return 0.0
        sid = getattr(self.server, "_sid", None)
        ctrl = arb.c
        slow_hz = ctrl.table[0].freq_hz
        max_hz = ctrl.max_op.freq_hz
        n_layers = ctrl.stats.n_layers
        total = 0.0
        for key, clk in arb._lanes.items():
            own = (
                isinstance(key, tuple) and len(key) == 3 and key[0] == sid
            )
            if own:
                continue        # own-sid lanes are priced by the scheduler-
                                # side scans above — never double-count
            if clk.pred_layers_remaining is not None:
                rem = float(clk.pred_layers_remaining)
            else:
                rem = max(float(n_layers - clk.depth), 0.0)
            serial = rem * clk.cycles_per_layer / slow_hz
            capped = (
                max(0.0, clk.deadline_s - arb.now_s)
                + rem * clk.cycles_per_layer / max_hz
            )
            total += min(serial, capped)
        return total

    def quote(self, req: "Request", replica: Optional[int] = None) -> Quote:
        """Price an explicit-SLO request against the current system state.
        Pure — does not enqueue anything.

        On a sharded server (``server.replicas > 1``) and with no explicit
        ``replica``, every clock domain is quoted independently and the
        placement policy picks among the feasible ones (the request would be
        pinned there on admission); with no feasible domain the quote with
        the earliest ``min_deadline_s`` is returned, so a rejected caller
        resubmitting at the quote lands on the least-bad replica.  A request
        already pinned (``req.replica``) is only quoted against its domain.

        Assumes EDF ties resolve in arrival order (they do: the queue pop
        keeps the first of equal deadlines), i.e. a later arrival with the
        same relative SLO cannot displace an earlier accepted contract; a
        strictly TIGHTER later arrival can, which the per-arrival d_l bound
        prices for the arrival itself but not retroactively for the displaced
        contract — the headroom absorbs that second-order effect."""
        sched = self.sched
        sched.sync_clock()      # shared-arbiter time may have moved while
                                # this server was idle: price waits from the
                                # true now, not a stale clock
        if replica is None:
            pin = getattr(req, "replica", None)
            if pin is not None:
                replica = int(pin)
            elif self._replicas() > 1:
                quotes = [
                    self.quote(req, replica=r) for r in range(self._replicas())
                ]
                feasible = [q for q in quotes if q.feasible]
                if feasible:
                    return self.placement.choose(feasible)
                return min(quotes, key=lambda q: q.min_deadline_s)
        bucket = sched.bucket_for(sched.engine.bucket_key(req))
        steps = self._predict_steps(bucket, req, req.ckpt_depth)
        service = self._service_s(bucket, steps)
        wait = (
            self._own_bucket_wait_s(bucket, replica)
            + self._cross_bucket_backlog_s(bucket)
            + (
                self._cross_engine_backlog_s()
                if replica is None
                else self._cross_engine_backlog_s(replica)
            )
        )
        # eNVM task residency: a non-resident task's first refill stalls the
        # shared clock for its swap-in, so the quote must carry it — the
        # identical request is quoted strictly cheaper when its task is
        # already SRAM-resident
        res = getattr(self.server, "residency", None)
        if res is not None:
            wait += res.pending_swap_stall_s(getattr(self.server, "task", None))
        # cross-server queued demand the arbiter cannot surface (see ctor)
        if self.extra_wait_s is not None:
            wait += max(0.0, float(self.extra_wait_s()))
        min_deadline = (wait + service) * self.headroom
        feasible = (
            req.deadline_s is not None
            and req.deadline_s >= min_deadline * (1 - 1e-9)
        )
        return Quote(
            bucket=bucket,
            service_s=service,
            wait_s=wait,
            min_deadline_s=min_deadline,
            feasible=feasible,
            replica=replica,
        )

    # ----------------------------------------------------------- admission
    def _do_submit(self, req: "Request") -> None:
        # the engine's submit() also stamps req.bucket; a bare scheduler
        # only returns it
        if self.server is self.sched:
            req.bucket = self.sched.submit(req)
        else:
            self.server.submit(req)

    def _bound_best_effort(self, bucket: int) -> List["Request"]:
        shed: List["Request"] = []
        if self.max_best_effort_queue is None:
            return shed
        sched = self.sched
        excess = (
            sched.queued_best_effort(bucket) + 1 - self.max_best_effort_queue
        )
        if excess > 0:
            shed = sched.shed_oldest(bucket, n=excess)
        return shed

    def submit(self, req: "Request") -> AdmissionDecision:
        """Admit, re-quote, reject, or shed-and-admit one request.

        Best-effort (``deadline_s is None``): always admitted, but the
        bucket's bounded queue may shed its OLDEST queued best-effort
        requests to make room (returned on the decision).  Explicit SLO:
        quoted; infeasible SLOs are rejected (decision carries the minimum
        feasible deadline) or admitted at the quote per ``on_infeasible``.
        """
        sched = self.sched
        bucket = sched.bucket_for(sched.engine.bucket_key(req))
        if req.deadline_s is None:
            shed = self._bound_best_effort(bucket)
            self._do_submit(req)
            sched.admission_stats["accepted"] += 1
            return AdmissionDecision(True, "accepted", bucket, None, shed)
        q = self.quote(req)
        if q.feasible:
            if q.replica is not None:
                req.replica = q.replica     # placement pin: the scheduler
                                            # only refills that domain's lanes
            self._do_submit(req)
            sched.admission_stats["accepted"] += 1
            return AdmissionDecision(True, "accepted", bucket, q)
        if self.on_infeasible == "requote":
            req.quoted_deadline_s = req.deadline_s
            req.deadline_s = q.min_deadline_s
            if q.replica is not None:
                req.replica = q.replica
            self._do_submit(req)
            sched.admission_stats["requoted"] += 1
            return AdmissionDecision(True, "requoted", bucket, q)
        sched.admission_stats["rejected"] += 1
        return AdmissionDecision(False, "rejected", bucket, q)
