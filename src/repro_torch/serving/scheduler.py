"""Serving-layer lifecycle: ``submit() -> step() -> poll() -> telemetry()``.

A copy of the JAX package's ``serving/scheduler.py`` (numpy and Python
only), so the port's engines ride the same lane scheduler.  Where the text
below speaks of jit traces and compiles, the port's engines build one fused
step per bucket instead (``serving/engine.py``).

``LaneScheduler`` is the single continuously-clocked loop every serving engine
rides.  A caller may submit a request AT ANY TIME — before a drain, or between
two ``step()`` calls while other buckets are mid-flight — and the request
lands in a later refill of its length bucket with no new compiled traces (the
fused step's shapes are fixed per bucket, so interleaving and mid-flight
admission never retrace).  Each ``step()`` advances EXACTLY ONE bucket by one
fused step, chosen by a pluggable ``SchedulingPolicy``; ``poll()`` drains the
requests that retired since the last poll; ``run()`` is a thin back-compat
wrapper (``while work remains: step()``) for callers that still want the
drain-the-world API.  ``telemetry()`` reports lifetime counters, including
per-request queue delay (``arrival_step -> first_compute_step``) percentiles.

Retention: ``poll()`` RELEASES the polled requests' payloads from ``done``
(the caller owns them now; ``pin=True`` keeps them resident), and every
retirement-derived telemetry figure — queue-delay percentiles (bounded
reservoir), SLO-miss counters — folds in incrementally at retirement, so a
long-running submit/step/poll server stays bounded-memory while the
batch-drain idiom (``run()`` then index ``done``) is unchanged.

Engine hooks
------------
``ClassifierServer`` and ``DecoderServer`` used to each own a private copy of
the same loop — submit -> queue -> refill free lanes -> fused step -> retire.
``EngineHooks`` is that lifecycle's explicit contract: the engine owns all
device state (hidden tensors, KV caches, jitted functions) and supplies the
compute; the scheduler owns queues, lane bookkeeping, the modeled clock, and
telemetry.  Because ``step()`` time-slices across buckets, MULTIPLE buckets
may be open at once: an engine must keep its per-bucket state keyed by bucket
(``bucket_begin``/``bucket_end`` bracket a bucket's lifetime, not the drain's).

Length buckets
--------------
The queue is partitioned by *bucket*: a request is assigned the smallest
configured bucket that fits its shape key (sequence length for the
classifier, prompt + generation budget for the decoder), and its tokens are
padded up to the bucket size by the engine.  Each bucket drains as its own
fixed-shape ``[lanes, S_bucket]`` engine state, so jit compiles EXACTLY ONE
step per bucket instead of one per distinct request length.  ``buckets=None``
keeps the legacy behavior: every distinct shape key is its own bucket.

Deadlines and the modeled clock
-------------------------------
``Request.deadline_s`` is a per-request SLO measured from SUBMISSION on the
scheduler's modeled clock, which advances by ``step_time_fn(bucket)`` per
fused step (default 1.0 — deadlines in "steps"; engines with a hardware model
pass the per-bucket layer time so deadlines are in modeled seconds).  The
default ``EDFPolicy`` ranks buckets by the least slack among their work:
absolute deadline minus the modeled now minus the predicted remaining work,
where remaining work comes from the engine's entropy-LUT exit prediction
(``predict_remaining_steps`` hook -> ``core.early_exit``).  Buckets whose
work carries no deadline fall back to weighted-round-robin time slicing, so a
deep 128-token drain can no longer starve queued 32-token traffic.

Preemption and lane checkpointing
---------------------------------
With ``preempt=True`` (and an engine implementing the optional
``lane_checkpoint``/``lane_restore`` hooks) a queued EXPLICIT-SLO request no
longer waits for a lane to drain when every lane is busy: the scheduler
evicts a budget-free (deadline-less) lane — checkpointing its hidden state
``(h, depth, kv_len)`` at the layer boundary — and re-queues the evicted
request at the FRONT of its bucket's FIFO with the checkpoint attached.  A
later refill restores the checkpoint into a free lane and the request resumes
at its saved depth WITHOUT re-running completed layers; because the
checkpoint round-trips through the same fixed ``[lanes, S_bucket]`` shapes
the engine already traced, eviction and restore add ZERO new compiled traces.
Preemption bounds an explicit request's lane wait by one fused step instead
of one retire (or, FIFO-worst-case, one whole drain round).

Admission control (``serving/admission.py``) sits in FRONT of ``submit()``:
it quotes feasibility for explicit SLOs (reject / re-quote instead of
accept-then-miss) and bounds the best-effort queue (``shed_oldest``) under
sustained oversubscription.  The scheduler carries the shared telemetry
counters — ``rejected`` / ``requoted`` / ``shed`` / ``preemptions`` /
``restored_steps_saved`` — so one ``telemetry()`` call reports the whole
admit -> [preempt/checkpoint] -> retire lifecycle.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    TYPE_CHECKING,
)

import numpy as np

from repro_torch.serving import trace

if TYPE_CHECKING:  # circular: engine imports scheduler
    from repro_torch.serving.engine import Request


class EngineHooks(Protocol):
    """Compute hooks a serving engine implements to ride the scheduler.

    The engine owns all device state (hidden tensors, KV caches, jitted
    functions); the scheduler owns queues, lane bookkeeping, the modeled
    clock, and telemetry.  Cross-bucket time slicing means several buckets
    can be open simultaneously — implementations must key their state by
    bucket.
    """

    def bucket_key(self, req: "Request") -> int:
        """Shape key of a request (e.g. sequence length) used for bucketing."""
        ...

    def bucket_begin(self, bucket: int) -> None:
        """Allocate the fixed-shape ``[lanes, bucket]`` state for this bucket."""
        ...

    def lane_load(self, bucket: int, lane: int, req: "Request") -> None:
        """Insert a request into a free lane (embed / prefill)."""
        ...

    def lanes_step(self, bucket: int, active: np.ndarray) -> Any:
        """Run ONE fused step over all lanes; returns host-side step outputs."""
        ...

    # -- optional (resolved via getattr; engines may omit it) ---------------
    def step_dt_s(self, bucket: int) -> Optional[float]:
        """ACTUAL modeled duration of the step just run (e.g. the DVFS
        arbiter's chosen-op period plus any switching stall).  When provided,
        the scheduler's clock advances by this instead of the nominal
        ``step_time_fn`` estimate, keeping the EDF clock and the DVFS clock
        from drifting apart.  ``None``/absent = use ``step_time_fn``."""
        ...

    # -- optional (resolved via getattr; engines may omit it) ---------------
    def clock_s(self) -> Optional[float]:
        """Authoritative modeled time when the engine shares a hardware
        timeline with others (e.g. several servers on ONE DVFS arbiter —
        one LDO/ADPLL is one clock).  The scheduler fast-forwards its own
        ``now_s`` to this at every ``submit()`` and ``step()``, so arrival
        stamps, EDF slack, and admission quotes are judged on the same clock
        deadlines are — even when OTHER servers advanced it in between.
        ``None``/absent = the scheduler's own clock is authoritative."""
        ...

    def lane_advance(
        self, bucket: int, lane: int, req: "Request", out: Any, depth: int
    ) -> bool:
        """Per-lane host postprocess after a step; True retires the lane."""
        ...

    def lane_finish(self, bucket: int, lane: int, req: "Request", depth: int) -> None:
        """Retirement bookkeeping (final logits, DVFS report, ...)."""
        ...

    def bucket_end(self, bucket: int) -> None:
        """Release / park the bucket state once its queue + lanes drained."""
        ...

    # -- optional (resolved via getattr; engines may omit it) ---------------
    def predict_remaining_steps(
        self, bucket: int, req: "Request", depth: int
    ) -> Optional[float]:
        """Predicted fused steps this request still needs (entropy-LUT exit
        prediction for the classifier, generation budget for the decoder).
        ``None``/absent = unknown; the EDF policy then uses the bare deadline."""
        ...

    # -- optional (both required for preempt=True; resolved via getattr) ----
    def lane_checkpoint(self, bucket: int, lane: int, req: "Request") -> Any:
        """Snapshot a lane's engine state (hidden tensor row / KV cache row,
        valid length, DVFS lane clock) at a layer boundary so the lane can be
        freed for a tighter-SLO arrival.  Returns an opaque payload handed
        back verbatim to ``lane_restore``; the scheduler separately remembers
        the lane's depth.  Must not mutate the lane — the request may be
        restored into a DIFFERENT lane index later."""
        ...

    def lane_restore(self, bucket: int, lane: int, req: "Request", payload: Any) -> None:
        """Reload a checkpointed request into a free lane.  Must reuse the
        bucket's existing fixed-shape compiled paths (zero new traces) and
        reproduce the checkpointed state bit-identically, so a preempted-
        then-restored request computes the same function as an uninterrupted
        run."""
        ...


# Back-compat alias: the protocol's earlier name.
LaneEngine = EngineHooks


@dataclass
class BucketView:
    """Per-bucket snapshot handed to a ``SchedulingPolicy``."""

    bucket: int
    queued: int                     # requests waiting in this bucket's queue
    active: int                     # lanes currently in flight
    step_time_s: float              # modeled duration of one fused step
    earliest_deadline_s: float      # min absolute deadline (inf if none),
                                    # explicit SLOs and implicit budgets alike
    min_slack_s: float              # min(deadline - now - predicted remaining)
    earliest_seq: int               # submission order of the oldest work item
    # explicit per-request SLOs only (requests with their own deadline_s):
    # EDF ranks these STRICTLY above implicit controller-target budgets — a
    # per-request SLO is a contract, the global target is best-effort shaping
    explicit_deadline_s: float = float("inf")
    explicit_slack_s: float = float("inf")


class SchedulingPolicy(Protocol):
    """Picks which candidate bucket the next ``step()`` advances."""

    def choose(self, views: Sequence[BucketView], now_s: float) -> int:
        ...


class WeightedRoundRobinPolicy:
    """Deficit-style weighted round robin over the candidate buckets.

    Each bucket accrues ``weights[bucket]`` credits (default 1.0) whenever
    every candidate is out of credit; the richest candidate runs ``quantum``
    consecutive steps before the next arbitration.  With default weights this
    is fair time slicing — a deep drain and a short queue alternate instead
    of the deep drain running to completion first.
    """

    def __init__(
        self, weights: Optional[Dict[int, float]] = None, quantum: int = 1
    ):
        assert quantum >= 1
        self.weights = dict(weights or {})
        self.quantum = int(quantum)
        self._credit: Dict[int, float] = {}
        self._last: Optional[int] = None
        self._ran = 0

    def choose(self, views: Sequence[BucketView], now_s: float) -> int:
        byb = {v.bucket: v for v in views}
        if self._last in byb and self._ran < self.quantum:
            self._ran += 1
            return self._last
        for b in byb:
            self._credit.setdefault(b, 0.0)
        if all(self._credit[b] <= 0 for b in byb):
            for b in byb:
                self._credit[b] += self.weights.get(b, 1.0)
        choice = max(byb, key=lambda b: (self._credit[b], -b))
        self._credit[choice] -= 1.0
        self._last, self._ran = choice, 1
        return choice


class EDFPolicy:
    """Earliest-deadline-first across buckets, slack-ranked by the predicted
    exit depth; deadline-free work falls back to ``fallback`` (WRR).

    A bucket's urgency is the least slack among its queued + in-flight
    requests: absolute deadline minus the modeled now minus the predicted
    remaining work (the engine's entropy-LUT exit prediction times the
    bucket's step time).  Deadlines come in two strengths and EDF ranks them
    in strict tiers: buckets holding EXPLICIT per-request SLOs (contracts,
    queue-wait-inclusive) preempt buckets whose urgency is only the implicit
    controller-target budget (best-effort energy shaping), which in turn
    preempt deadline-free work — the property that lets a tight-SLO 32-token
    request retire in the middle of a deep 128-token drain.
    """

    def __init__(self, fallback: Optional[SchedulingPolicy] = None):
        self.fallback = fallback if fallback is not None else WeightedRoundRobinPolicy()

    def choose(self, views: Sequence[BucketView], now_s: float) -> int:
        contracted = [v for v in views if np.isfinite(v.explicit_deadline_s)]
        if contracted:
            return min(
                contracted,
                key=lambda v: (v.explicit_slack_s, v.explicit_deadline_s, v.bucket),
            ).bucket
        dated = [v for v in views if np.isfinite(v.earliest_deadline_s)]
        if not dated:
            return self.fallback.choose(views, now_s)
        return min(
            dated,
            key=lambda v: (v.min_slack_s, v.earliest_deadline_s, v.bucket),
        ).bucket


class FIFOPolicy:
    """Strict arrival order: always advance the bucket holding the oldest
    unfinished request — the sequential drain-the-world behavior, kept as the
    baseline the EDF tests beat."""

    def choose(self, views: Sequence[BucketView], now_s: float) -> int:
        return min(views, key=lambda v: (v.earliest_seq, v.bucket)).bucket


class _DelayReservoir:
    """Bounded-memory percentile sample for the queue-delay telemetry.

    Classic reservoir sampling (deterministic seed, so telemetry is
    reproducible): the first ``cap`` observations are kept exactly — small
    drains report EXACT percentiles, unchanged from the rescan-the-retirees
    implementation — and a long-running server degrades gracefully to a
    uniform sample instead of growing without bound.  The max is tracked
    exactly (it is O(1) state)."""

    def __init__(self, cap: int = 4096, seed: int = 0):
        assert cap >= 1
        self.cap = cap
        self.n = 0
        self.buf: List[float] = []
        self.max = 0.0
        self._rng = np.random.default_rng(seed)

    def add(self, x: float) -> None:
        self.n += 1
        self.max = max(self.max, float(x))
        if len(self.buf) < self.cap:
            self.buf.append(float(x))
        else:
            j = int(self._rng.integers(0, self.n))
            if j < self.cap:
                self.buf[j] = float(x)

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.buf, q)) if self.buf else 0.0


def _pop_at(q: deque, idx: int) -> "Request":
    """Remove and return the element at ``idx`` from a deque in O(idx):
    rotate it to the front, pop, rotate back (popping at the front is what
    makes rotating by the PRE-pop index correct afterwards)."""
    q.rotate(-idx)
    item = q.popleft()
    q.rotate(idx)
    return item


@dataclass
class _BucketRun:
    """Scheduler-side lane bookkeeping of one OPEN bucket."""

    lane_req: List[Optional["Request"]]
    lane_depth: np.ndarray
    active: np.ndarray


@dataclass
class StepReport:
    """What one ``step()`` did (host-side, for callers driving the loop)."""

    bucket: int
    n_active: int
    retired: List["Request"] = field(default_factory=list)


class LaneScheduler:
    """Length-bucketed, continuously-clocked continuation-batching scheduler.

    Parameters
    ----------
    lanes:        number of hardware lanes (the fixed batch dimension).
    engine:       the ``EngineHooks`` implementation supplying compute.
    buckets:      ascending bucket sizes (e.g. ``(32, 64, 128)``); a request
                  lands in the smallest bucket >= its shape key.  ``None`` =
                  exact-shape buckets (one per distinct key).
    policy:       ``SchedulingPolicy`` picking the bucket each ``step()``
                  advances.  Default: ``EDFPolicy`` (WRR fallback when no
                  deadlines are in play).
    step_time_fn: modeled seconds one fused step of a bucket takes (drives
                  the modeled clock the EDF slack computation runs on).
                  Default: 1.0 per step — deadlines measured in steps.
    default_deadline_s: implicit latency budget for IN-FLIGHT requests that
                  carry no ``deadline_s`` (engines pass the DVFS controller's
                  global target).  Anchored at lane ADMISSION — the clock the
                  DVFS layer judges — so once a lane is loaded, EDF slack
                  (not blind round robin) decides which bucket gets each time
                  slice and the lane closest to its budget runs next.
                  QUEUED deadline-free requests stay undated: their budget
                  has not started, so an explicit (submission-anchored,
                  queue-wait-inclusive) per-request SLO always outranks a
                  backlog of budget-free work.  ``None`` keeps deadline-free
                  requests out of the EDF ranking entirely (WRR fallback
                  when nothing carries a deadline).
    preempt:      enable lane eviction for explicit SLOs: when a bucket's
                  queue holds an explicit-deadline request and every lane is
                  busy, a budget-free lane is checkpointed
                  (``engine.lane_checkpoint``) and re-queued at the FIFO
                  front, to be restored later without re-running completed
                  layers.  Requires the engine to implement the
                  ``lane_checkpoint``/``lane_restore`` hooks; silently
                  disabled otherwise.
    """

    def __init__(
        self,
        lanes: int,
        engine: EngineHooks,
        buckets=None,
        *,
        policy: Optional[SchedulingPolicy] = None,
        step_time_fn: Optional[Callable[[int], float]] = None,
        default_deadline_s: Optional[float] = None,
        preempt: bool = False,
    ):
        assert lanes >= 1
        self.lanes = lanes
        self.engine = engine
        self.buckets = tuple(sorted(int(b) for b in buckets)) if buckets else None
        assert self.buckets is None or len(set(self.buckets)) == len(self.buckets)
        self.policy: SchedulingPolicy = policy if policy is not None else EDFPolicy()
        self.step_time_fn = step_time_fn if step_time_fn is not None else (lambda b: 1.0)
        self.default_deadline_s = default_deadline_s
        self.preempt = bool(preempt) and (
            getattr(engine, "lane_checkpoint", None) is not None
            and getattr(engine, "lane_restore", None) is not None
        )
        self.queues: Dict[int, deque] = {}
        self.done: Dict[int, "Request"] = {}
        self.now_s = 0.0                # modeled clock (sum of step times)
        self._open: Dict[int, _BucketRun] = {}
        self._completed: deque = deque()  # retired since the last poll()
        self._seq = 0                   # global submission order
        # min absolute EXPLICIT deadline among each bucket's QUEUED requests,
        # maintained incrementally so _view() stays O(lanes) per step instead
        # of rescanning the whole queue (recomputed only when the minimum
        # element itself is admitted)
        self._qmin_deadline: Dict[int, float] = {}
        # ---- lifetime telemetry (persists across run()/step() calls) ----
        self._sentences = 0
        self._dense_steps = 0
        self._lane_steps = 0            # ACTIVE lane x step executions
        self._refills = 0
        self._bucket_steps: Dict[int, int] = {}
        self._preemptions = 0
        self._restored_steps_saved = 0  # checkpointed layers NOT re-run
        self._shed = 0                  # best-effort requests dropped
        # incremental retirement accounting: telemetry() must not rescan
        # ``done`` (poll() drops retired payloads unless pinned, so a
        # long-running submit/step/poll server stays bounded-memory)
        self._delays = _DelayReservoir()
        self._slo_misses = 0            # explicit SLOs missed (modeled clock)
        # admission-layer verdict counters (``serving/admission.py`` updates
        # these so one telemetry() call covers the whole request lifecycle)
        self.admission_stats: Dict[str, int] = {
            "accepted": 0, "rejected": 0, "requoted": 0,
        }

    # ------------------------------------------------------------- queueing
    def bucket_for(self, key: int) -> int:
        if self.buckets is None:
            return int(key)
        for b in self.buckets:
            if key <= b:
                return b
        raise ValueError(
            f"shape key {key} exceeds the largest bucket {self.buckets[-1]}"
        )

    def submit(self, req: "Request") -> int:
        """Queue a request — at any time, including between steps of an
        in-flight drain; it lands in a later refill of its bucket.  Returns
        the bucket it landed in.

        Stamps MODELED clocks only (``arrival_s`` / ``arrival_step``).  The
        wall-clock ``req.submit_time`` is deliberately NOT written here:
        deadline math runs entirely on the modeled clock, and a wall-clock
        stamp on the same object invited silently mixing the two (callers
        that want wall time set it themselves)."""
        with trace.span("sched.submit", req.uid):
            return self._submit(req)

    def _submit(self, req: "Request") -> int:
        self.sync_clock()
        req.arrival_step = self._dense_steps
        req.arrival_s = self.now_s
        req.seq = self._seq
        self._seq += 1
        b = self.bucket_for(self.engine.bucket_key(req))
        self.queues.setdefault(b, deque()).append(req)
        if req.deadline_s is not None:
            d_abs = req.arrival_s + req.deadline_s
            if d_abs < self._qmin_deadline.get(b, float("inf")):
                self._qmin_deadline[b] = d_abs
        return b

    def queued_best_effort(self, bucket: int) -> int:
        """Budget-free (no explicit SLO) requests waiting in a bucket's queue,
        excluding preempted requests carrying a checkpoint (those hold
        partially computed state and are not shed)."""
        return sum(
            1
            for r in self.queues.get(bucket, ())
            if r.deadline_s is None and r.checkpoint is None
        )

    def shed_oldest(self, bucket: int, n: int = 1) -> List["Request"]:
        """Load shedding: drop up to ``n`` of the OLDEST queued budget-free
        requests from a bucket (oldest-drop keeps the freshest traffic, the
        usual bounded-queue policy).  Explicit-SLO requests are never shed —
        they were admission-quoted — and neither are preempted requests
        carrying a checkpoint (their completed layers would be wasted).
        Dropped requests are marked ``shed`` and returned; they never retire
        and never appear in ``done``."""
        out: List["Request"] = []
        q = self.queues.get(bucket)
        if not q:
            return out
        for _ in range(n):
            idx = next(
                (
                    i
                    for i, r in enumerate(q)
                    if r.deadline_s is None and r.checkpoint is None
                ),
                None,
            )
            if idx is None:
                break
            victim = _pop_at(q, idx)
            victim.shed = True
            out.append(victim)
            self._shed += 1
        return out

    @property
    def pending(self) -> int:
        """Queued requests not yet loaded into a lane."""
        return sum(len(q) for q in self.queues.values())

    @property
    def in_flight(self) -> int:
        """Requests currently occupying a lane."""
        return sum(int(run.active.sum()) for run in self._open.values())

    @property
    def idle(self) -> bool:
        return self.pending == 0 and self.in_flight == 0

    # ---------------------------------------------------------- the clock
    def sync_clock(self) -> None:
        """Fast-forward ``now_s`` to the engine's authoritative shared clock
        (``clock_s`` hook), if it has one and it ran ahead — e.g. another
        server stepped the shared DVFS arbiter since we last ran.  No-op for
        engines that own their timeline (monotone: never rewinds)."""
        hook = getattr(self.engine, "clock_s", None)
        if hook is None:
            return
        t = hook()
        if t is not None and t > self.now_s:
            self.now_s = float(t)

    def lane_depths(self, bucket: int) -> np.ndarray:
        """The open bucket's layers run per lane (0 for a lane just loaded),
        the one record of each lane's depth: an engine whose lanes run
        different layers reads it here before each step and keeps no copy.
        Read only."""
        return self._open[bucket].lane_depth

    def _predict_remaining(self, bucket: int, req: "Request", depth: int):
        hook = getattr(self.engine, "predict_remaining_steps", None)
        if hook is None:
            return None
        return hook(bucket, req, depth)

    def _recompute_qmin(self, bucket: int) -> None:
        m = float("inf")
        for r in self.queues.get(bucket, ()):
            if r.deadline_s is not None:
                m = min(m, r.arrival_s + r.deadline_s)
        if np.isfinite(m):
            self._qmin_deadline[bucket] = m
        else:
            self._qmin_deadline.pop(bucket, None)

    def _pop_next(self, bucket: int, domain: Optional[int] = None) -> Optional["Request"]:
        """Next request to admit from a bucket's queue: the earliest-deadline
        EXPLICIT-SLO request if any (so a contract jumps the queue inside its
        own bucket, not just across buckets), else plain FIFO.  The O(queue)
        scan runs once per lane admission, not per step.

        ``domain`` restricts the pop to requests compatible with the lane's
        replica (admission placement pins ``req.replica``; unpinned requests
        run anywhere).  Returns ``None`` when nothing queued may take this
        lane — the refill leaves it free for a compatible arrival."""
        q = self.queues[bucket]
        best, best_d = None, float("inf")
        first_ok = None
        for idx, r in enumerate(q):
            pin = getattr(r, "replica", None)
            if domain is not None and pin is not None and pin != domain:
                continue
            if first_ok is None:
                first_ok = idx
            if r.deadline_s is not None:
                d = r.arrival_s + r.deadline_s
                if d < best_d:
                    best, best_d = idx, d
        if best is None:
            return _pop_at(q, first_ok) if first_ok is not None else None
        req = _pop_at(q, best)
        self._recompute_qmin(bucket)       # the minimum just left the queue
        return req

    def _view(self, bucket: int) -> BucketView:
        """Per-bucket urgency snapshot — O(lanes), not O(queue): in-flight
        lanes are enumerated, while the queue contributes its (incrementally
        maintained) min explicit deadline and its FIFO head's cold-start
        remaining-work estimate (queued requests have no entropy trace yet,
        so the head's prediction stands in for all of them)."""
        run = self._open.get(bucket)
        q = self.queues.get(bucket)
        dt = float(self.step_time_fn(bucket))
        queued = len(q) if q else 0
        active = int(run.active.sum()) if run is not None else 0
        earliest_deadline = float("inf")
        min_slack = float("inf")
        explicit_deadline = float("inf")
        explicit_slack = float("inf")
        earliest_seq = np.iinfo(np.int64).max
        if run is not None:
            for i in range(self.lanes):
                if not run.active[i]:
                    continue
                req, depth = run.lane_req[i], int(run.lane_depth[i])
                earliest_seq = min(earliest_seq, req.seq)
                explicit = req.deadline_s is not None
                if explicit:
                    # explicit SLO: submission-anchored — queue wait counts
                    d_abs = req.arrival_s + req.deadline_s
                elif self.default_deadline_s is not None:
                    # implicit budget: admission-anchored — the DVFS clock
                    d_abs = req.admit_s + self.default_deadline_s
                else:
                    continue
                rem = self._predict_remaining(bucket, req, depth)
                slack = d_abs - self.now_s - (rem or 0.0) * dt
                earliest_deadline = min(earliest_deadline, d_abs)
                min_slack = min(min_slack, slack)
                if explicit:
                    explicit_deadline = min(explicit_deadline, d_abs)
                    explicit_slack = min(explicit_slack, slack)
        if q:
            # queued budget-free work stays undated (its implicit budget has
            # not started); queued explicit SLOs enter via the running min
            earliest_seq = min(earliest_seq, q[0].seq)
            d_abs = self._qmin_deadline.get(bucket, float("inf"))
            if np.isfinite(d_abs):
                rem = self._predict_remaining(bucket, q[0], 0)
                slack = d_abs - self.now_s - (rem or 0.0) * dt
                earliest_deadline = min(earliest_deadline, d_abs)
                min_slack = min(min_slack, slack)
                explicit_deadline = min(explicit_deadline, d_abs)
                explicit_slack = min(explicit_slack, slack)
        return BucketView(
            bucket=bucket,
            queued=queued,
            active=active,
            step_time_s=dt,
            earliest_deadline_s=earliest_deadline,
            min_slack_s=min_slack,
            earliest_seq=int(earliest_seq),
            explicit_deadline_s=explicit_deadline,
            explicit_slack_s=explicit_slack,
        )

    def _candidates(self) -> List[BucketView]:
        out = []
        seen = set()
        for b, q in self.queues.items():
            if q:
                seen.add(b)
        for b, run in self._open.items():
            if run.active.any():
                seen.add(b)
        for b in sorted(seen):
            out.append(self._view(b))
        return out

    def candidate_views(self) -> List[BucketView]:
        """Public snapshot of this scheduler's candidate buckets, with the
        clock synced to the engine's shared timeline first.  Cross-server
        arbitration (e.g. task-affinity routing across per-task servers)
        ranks these the same way ``step()``'s own policy does, without
        stepping anything."""
        self.sync_clock()
        return self._candidates()

    # --------------------------------------------------------- preemption
    def _maybe_preempt(self, bucket: int, run: _BucketRun) -> None:
        """Evict budget-free lanes for queued EXPLICIT-SLO requests.

        Runs just before refill on the bucket ``step()`` chose: if the queue
        holds more explicit requests than there are free lanes, budget-free
        in-flight lanes are checkpointed (most predicted remaining work
        first — the longest work is the cheapest to defer) and re-queued at
        the FIFO front so the freed lanes take the contracts THIS step.  The
        explicit request's lane wait is thereby bounded by one fused step
        instead of one retire."""
        q = self.queues.get(bucket)
        if not q:
            return
        explicit = [r for r in q if r.deadline_s is not None]
        if not explicit:
            return

        def _victims(lane_idxs) -> List:
            out = []
            for i in lane_idxs:
                req = run.lane_req[i]
                if req is None or req.deadline_s is not None:
                    continue
                rem = self._predict_remaining(bucket, req, int(run.lane_depth[i]))
                out.append((-(rem if rem is not None else float(np.inf)), i))
            out.sort()
            return out

        def _evict(victims, need: int) -> None:
            for _, i in victims[: max(need, 0)]:
                req = run.lane_req[i]
                req.checkpoint = self.engine.lane_checkpoint(bucket, i, req)
                req.ckpt_depth = int(run.lane_depth[i])
                req.preempted += 1
                q.appendleft(req)
                run.lane_req[i] = None
                run.active[i] = False
                self._preemptions += 1

        dom_hook = getattr(self.engine, "lane_domain", None)
        pinned = [r for r in explicit if getattr(r, "replica", None) is not None]
        if dom_hook is None or not pinned:
            # single-domain (or wholly unpinned) case: evict globally
            free = sum(1 for r in run.lane_req if r is None)
            _evict(_victims(range(self.lanes)), len(explicit) - free)
            return
        # replica-pinned contracts can only take lanes of THEIR domain, so
        # eviction runs per domain for them; unpinned contracts then evict
        # globally for whatever free capacity remains
        domains: Dict[int, List[int]] = {}
        for i in range(self.lanes):
            domains.setdefault(dom_hook(i), []).append(i)
        for d, lane_idxs in domains.items():
            n_d = sum(1 for r in pinned if r.replica == d)
            if not n_d:
                continue
            free_d = sum(1 for i in lane_idxs if run.lane_req[i] is None)
            _evict(_victims(lane_idxs), n_d - free_d)
        n_wild = len(explicit) - len(pinned)
        if n_wild:
            free = sum(1 for r in run.lane_req if r is None)
            _evict(_victims(range(self.lanes)), n_wild - free)

    # ----------------------------------------------------------- stepping
    def step(self) -> Optional[StepReport]:
        """Advance ONE bucket by one fused step; returns what happened, or
        ``None`` when no work remains anywhere."""
        with trace.span("sched.step"):
            return self._step()

    def _step(self) -> Optional[StepReport]:
        with trace.span("sched.choose"):
            self.sync_clock()       # another server may have advanced the shared
                                    # timeline: EDF slack and admit_s need it
            views = self._candidates()
            bucket = self.policy.choose(views, self.now_s) if views else None
        if not views:
            return None
        assert any(v.bucket == bucket for v in views), (
            f"policy chose bucket {bucket} which has no queued or active work"
        )
        eng = self.engine
        run = self._open.get(bucket)
        if run is None:
            eng.bucket_begin(bucket)
            run = _BucketRun(
                lane_req=[None] * self.lanes,
                lane_depth=np.zeros(self.lanes, np.int32),
                active=np.zeros(self.lanes, bool),
            )
            self._open[bucket] = run

        # evict budget-free lanes for queued explicit SLOs BEFORE refill, so
        # the freed lanes take the contracts in this very step
        if self.preempt:
            self._maybe_preempt(bucket, run)

        step_idx = self._dense_steps
        with trace.span("sched.refill"):
            self._refill(bucket, run, step_idx)
        assert run.active.any(), "candidate bucket must have work after refill"

        out = eng.lanes_step(bucket, run.active.copy())
        n_active = int(run.active.sum())
        self._dense_steps += 1
        self._lane_steps += n_active
        self._bucket_steps[bucket] = self._bucket_steps.get(bucket, 0) + 1
        # the engine may report the step's ACTUAL modeled duration (DVFS op
        # period + switching stalls); fall back to the nominal estimate so
        # the EDF clock cannot drift from the clock deadlines are judged by
        dt_hook = getattr(eng, "step_dt_s", None)
        dt = dt_hook(bucket) if dt_hook is not None else None
        self.now_s += float(dt) if dt is not None else float(self.step_time_fn(bucket))
        run.lane_depth[run.active] += 1

        report = StepReport(bucket=bucket, n_active=n_active)
        with trace.span("sched.retire"):
            self._retire(bucket, run, out, step_idx, report)

        if not run.active.any() and not self.queues.get(bucket):
            eng.bucket_end(bucket)
            del self._open[bucket]
        return report

    def _refill(self, bucket: int, run: _BucketRun, step_idx: int) -> None:
        """Refill every free lane from this bucket's queue (continuation
        batching: retired lanes never idle while work is queued)."""
        eng = self.engine
        q = self.queues.get(bucket)
        # replica-aware refill: a lane only takes work compatible with its
        # clock domain (engines without replicas report domain 0 for every
        # lane, and unpinned requests run anywhere — the common path is
        # unchanged)
        dom_hook = getattr(eng, "lane_domain", None)
        for i in range(self.lanes):
            if run.lane_req[i] is None and q:
                req = self._pop_next(
                    bucket, dom_hook(i) if dom_hook is not None else None
                )
                if req is None:
                    continue    # everything queued is pinned elsewhere
                if req.checkpoint is not None:
                    # preempted earlier: restore the checkpointed state and
                    # resume at its saved depth — completed layers are NOT
                    # re-run, and the original admission stamps survive (the
                    # queue-delay telemetry measures the FIRST admission)
                    eng.lane_restore(bucket, i, req, req.checkpoint)
                    run.lane_depth[i] = req.ckpt_depth
                    self._restored_steps_saved += req.ckpt_depth
                    req.checkpoint = None
                else:
                    eng.lane_load(bucket, i, req)
                    run.lane_depth[i] = 0
                    req.admit_s = self.now_s
                if req.first_compute_step is None:
                    req.first_compute_step = step_idx
                run.lane_req[i] = req
                run.active[i] = True
                self._refills += 1

    def _retire(self, bucket: int, run: _BucketRun, out: Any, step_idx: int,
                report: StepReport) -> None:
        """Advance every active lane past the step's outputs and retire the
        lanes the engine says are done."""
        eng = self.engine
        for i in range(self.lanes):
            if not run.active[i]:
                continue
            req = run.lane_req[i]
            if eng.lane_advance(bucket, i, req, out, int(run.lane_depth[i])):
                eng.lane_finish(bucket, i, req, int(run.lane_depth[i]))
                req.retire_step = step_idx
                req.retire_s = self.now_s
                self.done[req.uid] = req
                self._completed.append(req)
                self._sentences += 1
                # fold retirement telemetry in NOW — once poll() hands the
                # request to the caller its payload may be gone
                if (
                    req.first_compute_step is not None
                    and req.arrival_step is not None
                ):
                    self._delays.add(req.first_compute_step - req.arrival_step)
                if (
                    req.deadline_s is not None
                    and req.retire_s - req.arrival_s > req.deadline_s * (1 + 1e-9)
                ):
                    self._slo_misses += 1
                report.retired.append(req)
                run.lane_req[i] = None
                run.active[i] = False

    def poll(self, *, pin: bool = False) -> List["Request"]:
        """Requests retired since the last ``poll()`` (completion order).

        By default the polled requests are DROPPED from ``done`` — the
        caller now owns the payloads (tokens, logits, entropy traces), and a
        long-running submit/step/poll server keeps ``done`` at
        O(retired-but-unpolled) instead of growing forever (telemetry is
        folded incrementally at retirement, so nothing is lost).
        ``pin=True`` keeps the polled requests resident in ``done`` — the
        batch-drain idiom (``run()`` then index ``done`` by uid) is
        unaffected either way, since it never polls."""
        with trace.span("sched.poll"):
            out = list(self._completed)
            self._completed.clear()
            if not pin:
                for r in out:
                    self.done.pop(r.uid, None)
        return out

    def run(self) -> Dict[str, float]:
        """Back-compat drain-the-world wrapper: step until idle.

        The bucket ORDER now follows the configured policy (EDF/WRR time
        slicing instead of ascending sequential drains).  Per-request COMPUTE
        results (logits, exit layers, generated tokens) are identical — lanes
        are independent and each bucket's shapes are fixed, so no new traces
        either — but shared-clock DVFS accounting (energy_j / latency_s /
        operating points) legitimately differs from the sequential order: the
        arbiter sees a different lane mix and admission timeline.
        """
        while not self.idle:
            self.step()
        return self.telemetry()

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> Dict[str, float]:
        # all retirement-derived keys come from INCREMENTAL accumulators
        # (delay reservoir, miss counters) folded in at retirement: they are
        # exact for small drains, bounded-memory for long-running servers,
        # and independent of whether poll() already dropped the payloads;
        # every key exists, as 0, even when nothing has retired yet
        return {
            "sentences": self._sentences,
            "dense_steps": self._dense_steps,
            "lane_steps": self._lane_steps,
            "refills": self._refills,
            "buckets_used": len(self._bucket_steps),
            "bucket_steps": dict(self._bucket_steps),
            "lane_occupancy": (
                self._lane_steps / (self._dense_steps * self.lanes)
                if self._dense_steps
                else 0.0
            ),
            "modeled_now_s": self.now_s,
            "queue_delay_steps_p50": self._delays.percentile(50),
            "queue_delay_steps_p95": self._delays.percentile(95),
            "queue_delay_steps_p99": self._delays.percentile(99),
            "queue_delay_steps_max": self._delays.max if self._delays.n else 0.0,
            # ---- admission / preemption lifecycle counters ----
            "accepted": self.admission_stats["accepted"],
            "rejected": self.admission_stats["rejected"],
            "requoted": self.admission_stats["requoted"],
            "shed": self._shed,
            "preemptions": self._preemptions,
            "restored_steps_saved": self._restored_steps_saved,
            # explicit SLOs judged on the MODELED engine clock (submission ->
            # retirement), so the contract metric exists for every engine and
            # DVFS configuration; servers with a DVFS controller overwrite it
            # with the equivalent arbiter-latency accounting
            "accepted_slo_misses": self._slo_misses,
        }
