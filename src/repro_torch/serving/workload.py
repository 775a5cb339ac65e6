"""Trace-driven workload harness: arrival-process generators + full-path
replay through the serving stack.

Every benchmark in this repo used to be a hand-rolled single-scenario script
(a fixed queue of N requests, submitted in a loop), so the
``AdmissionController -> ResidencyRouter -> LaneScheduler ->
BatchedDVFSArbiter`` path had never been exercised against large,
statistically-shaped request streams — exactly the regime where EdgeBERT's
sentence-granularity latency/energy claims are made or broken.  This module
is the load-generation layer every perf run is measured through:

* **Arrival processes** — ``PoissonArrivals`` (memoryless open-loop load),
  ``MMPPArrivals`` (Markov-modulated Poisson: exponential dwell in each rate
  state, the classic bursty-traffic model; state switches carry the residual
  exponential across via memorylessness, so the process is exact, not
  binned), and ``DiurnalArrivals`` (sinusoid-modulated inhomogeneous Poisson
  via thinning — the day/night envelope).  All are seeded generators on the
  MODELED clock: no wall time anywhere, so a trace is a pure function of
  (config, seed).

* **Traffic shaping** — ``WorkloadConfig`` mixes explicit-SLO tiers against
  best-effort (``TierSpec``; an explicit tier's deadline is
  ``slo_mult x service_s(length)``, priced off the caller's cycle model so
  SLOs scale with the hardware), multi-task mixes with skewed popularity
  (``tasks`` weights — Zipf-style skew is just unequal weights), and
  per-bucket length distributions (sample a bucket by weight, then a length
  inside it — matching how the serving stack actually pads).

* **Traces** — ``generate_trace`` streams ``TraceEvent``s (O(1) memory);
  ``save_trace``/``load_trace`` round-trip them through JSONL so a trace can
  be generated once and replayed byte-identically elsewhere.

* **Replay** — ``TraceReplayer`` drives a trace through a live serving
  target in submission order on the modeled clock: step the system until the
  clock reaches the next arrival (fast-forwarding through idle gaps via the
  arbiter's ``advance_to`` — idle time passes, it is not compressed), submit
  through admission control, ``poll()`` every step so retired payloads are
  released immediately.  Retention is O(outstanding): the replayer folds all
  per-request accounting (queue-delay reservoirs, per-tier SLO misses,
  completion counters) incrementally at poll time and never holds the trace
  or the retirees in memory, so 10^5-10^6 request replays run in bounded
  memory with zero new jit traces beyond one compile per (bucket, replica).
  Two targets ship: ``AdmissionServerTarget`` (one engine — or a bare
  ``LaneScheduler`` in tests — behind an ``AdmissionController``) and
  ``ResidencyRouterTarget`` (the full multi-task path: per-task admission
  controllers over a ``ResidencyRouter``'s task servers).

The replay summary is a flat JSON-safe dict of MODELED quantities only
(throughput, energy/request, queue-delay p50/p95/p99, accepted-SLO miss
rate, shed/reject/requote counts, swap + trace counts), so the same seed
reproduces it bit-identically — the property the benchmark history diff and
the CI determinism gate rely on.

This is a copy of the JAX package's ``serving/workload.py`` (numpy and
Python only).  The JSONL trace format is the same, so a trace saved by
either package loads in the other; ``launch/replay.py`` is the port's
replay entry point.  Where the text says jit traces, the port's engines
count one build of the fused step per bucket instead.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
)

import numpy as np

from repro_torch.serving.scheduler import LaneScheduler, _DelayReservoir

# ===========================================================================
# Arrival processes (seeded, modeled-clock, streaming)
# ===========================================================================


class ArrivalProcess(Protocol):
    """Yields absolute arrival instants (modeled seconds, strictly
    increasing) forever; the generator bounds how many it consumes."""

    def times(self, rng: np.random.Generator) -> Iterator[float]: ...


@dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson arrivals: i.i.d. exponential inter-arrival gaps
    at ``rate_hz`` — the memoryless open-loop baseline."""

    rate_hz: float

    def __post_init__(self):
        assert self.rate_hz > 0.0

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate_hz))
            yield t


@dataclass(frozen=True)
class MMPPArrivals:
    """Markov-modulated Poisson process: the classic bursty-traffic model.

    The process cycles through ``len(rates_hz)`` states (0 -> 1 -> ... -> 0),
    dwelling an exponential time with mean ``mean_dwell_s[i]`` in state ``i``
    and emitting Poisson arrivals at ``rates_hz[i]`` while there.  A state
    switch mid-gap is handled EXACTLY: the residual of the pending
    exponential is rescaled by the rate ratio (memorylessness makes
    ``residual * rate_old`` a unit exponential, re-priced at the new rate),
    so no arrival is binned or dropped at the boundary.  Long-run rate is
    ``sum(rate_i * dwell_i) / sum(dwell_i)`` (cyclic stationary occupancy).
    """

    rates_hz: Tuple[float, ...]
    mean_dwell_s: Tuple[float, ...]
    start_state: int = 0

    def __post_init__(self):
        assert len(self.rates_hz) >= 2, "one state is plain Poisson"
        assert len(self.rates_hz) == len(self.mean_dwell_s)
        assert all(r > 0.0 for r in self.rates_hz)
        assert all(d > 0.0 for d in self.mean_dwell_s)
        assert 0 <= self.start_state < len(self.rates_hz)

    @property
    def long_run_rate_hz(self) -> float:
        w = sum(self.mean_dwell_s)
        return sum(r * d for r, d in zip(self.rates_hz, self.mean_dwell_s)) / w

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        rates, dwell = self.rates_hz, self.mean_dwell_s
        s = self.start_state
        t = 0.0
        next_switch = t + float(rng.exponential(dwell[s]))
        while True:
            gap = float(rng.exponential(1.0 / rates[s]))
            while t + gap >= next_switch:
                # carry the residual exponential across the switch exactly
                residual = (t + gap) - next_switch
                t = next_switch
                s_new = (s + 1) % len(rates)
                gap = residual * rates[s] / rates[s_new]
                s = s_new
                next_switch = t + float(rng.exponential(dwell[s]))
            t += gap
            yield t


@dataclass(frozen=True)
class DiurnalArrivals:
    """Inhomogeneous Poisson with a sinusoidal (day/night) rate envelope:
    ``rate(t) = base_rate_hz * (1 + depth * sin(2 pi t / period_s + phase))``,
    realized by thinning against the peak rate (exact for any envelope
    bounded by ``base * (1 + depth)``)."""

    base_rate_hz: float
    period_s: float
    depth: float = 0.5
    phase: float = 0.0

    def __post_init__(self):
        assert self.base_rate_hz > 0.0 and self.period_s > 0.0
        assert 0.0 <= self.depth < 1.0, "depth >= 1 would need a zero-rate trough"

    def rate_at(self, t: float) -> float:
        return self.base_rate_hz * (
            1.0 + self.depth * math.sin(2.0 * math.pi * t / self.period_s + self.phase)
        )

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        peak = self.base_rate_hz * (1.0 + self.depth)
        t = 0.0
        while True:
            while True:
                t += float(rng.exponential(1.0 / peak))
                if float(rng.random()) * peak <= self.rate_at(t):
                    break
            yield t


# ===========================================================================
# Workload shaping: tiers, task mixes, length distributions
# ===========================================================================


@dataclass(frozen=True)
class TierSpec:
    """One traffic tier.  ``slo_mult=None`` is best-effort (no deadline);
    otherwise the tier's requests carry an explicit SLO of
    ``slo_mult x service_s(length)`` — a multiple of the request's own
    full-depth service time, so specs stay scale-free across hw models."""

    name: str
    weight: float
    slo_mult: Optional[float] = None

    def __post_init__(self):
        assert self.weight > 0.0
        assert self.slo_mult is None or self.slo_mult > 0.0


@dataclass(frozen=True)
class WorkloadConfig:
    """A complete, seeded workload recipe: arrivals x tiers x tasks x lengths.

    ``lengths`` is a per-bucket mixture ``((bucket_size, weight), ...)``:
    sample a bucket by weight, then a length uniform in
    ``[max(4, bucket//2 + 1), bucket]`` — every sampled length lands in its
    intended serving bucket.  ``tasks`` is a weighted popularity mix
    (``()`` = single-task traffic, events carry ``task=None``).  The config
    plus ``seed`` fully determines the trace.
    """

    arrivals: ArrivalProcess
    lengths: Tuple[Tuple[int, float], ...]
    tiers: Tuple[TierSpec, ...] = (TierSpec("best_effort", 1.0),)
    tasks: Tuple[Tuple[str, float], ...] = ()
    seed: int = 0

    def __post_init__(self):
        assert self.lengths, "need at least one (bucket, weight) pair"
        assert all(b >= 4 and w > 0.0 for b, w in self.lengths)
        assert self.tiers, "need at least one tier"
        assert all(w > 0.0 for _, w in self.tasks)


@dataclass
class TraceEvent:
    """One request of a trace, before it becomes a live ``Request``."""

    uid: int
    t_s: float                          # absolute modeled arrival instant
    length: int                         # token length (pre-padding)
    tier: str
    deadline_s: Optional[float] = None  # relative SLO; None = best-effort
    task: Optional[str] = None


def _cdf(weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    c = np.cumsum(w / w.sum())
    c[-1] = 1.0 + 1e-12                 # guard the u ~ [0, 1) upper edge
    return c


def _pick(cdf: np.ndarray, rng: np.random.Generator) -> int:
    return int(np.searchsorted(cdf, float(rng.random()), side="right"))


def generate_trace(
    cfg: WorkloadConfig,
    n: int,
    service_s: Optional[Callable[[int], float]] = None,
) -> Iterator[TraceEvent]:
    """Stream ``n`` seeded trace events (O(1) memory — never materializes).

    ``service_s(length)`` prices one request's full-depth service time for
    the SLO tiers (pass the hw model's per-bucket cycle time; default 1.0 —
    deadlines in ``slo_mult`` step units, matching bare schedulers).  Two
    independent seeded substreams drive arrivals and shaping, so the arrival
    process's variable draw count (thinning) cannot perturb the mix."""
    assert n >= 0
    svc = service_s if service_s is not None else (lambda length: 1.0)
    rng_arr = np.random.default_rng([int(cfg.seed), 0xA1])
    rng_mix = np.random.default_rng([int(cfg.seed), 0xB2])
    arrivals = cfg.arrivals.times(rng_arr)
    tier_cdf = _cdf([t.weight for t in cfg.tiers])
    len_cdf = _cdf([w for _, w in cfg.lengths])
    task_cdf = _cdf([w for _, w in cfg.tasks]) if cfg.tasks else None

    def _events() -> Iterator[TraceEvent]:
        for uid in range(n):
            t = next(arrivals)
            tier = cfg.tiers[_pick(tier_cdf, rng_mix)]
            bucket = cfg.lengths[_pick(len_cdf, rng_mix)][0]
            length = int(rng_mix.integers(max(4, bucket // 2 + 1), bucket + 1))
            task = (
                cfg.tasks[_pick(task_cdf, rng_mix)][0]
                if task_cdf is not None
                else None
            )
            deadline = (
                None if tier.slo_mult is None
                else float(tier.slo_mult) * float(svc(length))
            )
            yield TraceEvent(
                uid=uid, t_s=float(t), length=length, tier=tier.name,
                deadline_s=deadline, task=task,
            )

    return _events()


def save_trace(path: str, events: Iterable[TraceEvent]) -> int:
    """Write events as JSONL (one event per line, streaming).  Returns the
    event count."""
    n = 0
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({
                "uid": ev.uid, "t_s": ev.t_s, "length": ev.length,
                "tier": ev.tier, "deadline_s": ev.deadline_s, "task": ev.task,
            }, sort_keys=True))
            f.write("\n")
            n += 1
    return n


def load_trace(path: str) -> Iterator[TraceEvent]:
    """Stream events back from a ``save_trace`` JSONL file."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            yield TraceEvent(
                uid=int(d["uid"]), t_s=float(d["t_s"]), length=int(d["length"]),
                tier=str(d["tier"]),
                deadline_s=None if d.get("deadline_s") is None else float(d["deadline_s"]),
                task=d.get("task"),
            )


# ===========================================================================
# Replay targets: the live systems a trace drives
# ===========================================================================


class ReplayTarget(Protocol):
    """What the replayer needs from a live serving stack."""

    def now_s(self) -> float: ...
    def advance_idle_to(self, t: float) -> None: ...
    def submit(self, ev: TraceEvent, req: Any) -> Optional[Any]: ...
    def step(self) -> bool: ...
    def poll(self) -> List[Any]: ...
    def outstanding(self) -> int: ...
    def merged_telemetry(self) -> Dict[str, Any]: ...


def _max_bucket_replica_traces(tel: Dict[str, Any]) -> int:
    per = tel.get("step_traces_per_bucket_replica", {})
    return max((int(v) for v in per.values()), default=0)


def _advance_scheduler_idle(server: Any, sched: LaneScheduler, t: float) -> None:
    """Fast-forward an idle system's modeled clock to ``t``: push every
    arbiter clock (the authoritative shared timeline) and let the scheduler
    sync, or move the scheduler's own clock for arbiter-less engines.
    Monotone — a clock already past ``t`` is untouched."""
    arbs = getattr(server, "arbiters", None)
    if arbs:
        for a in arbs:
            a.advance_to(t)
        sched.sync_clock()
    else:
        sched.now_s = max(sched.now_s, float(t))


class AdmissionServerTarget:
    """One serving engine (or a bare ``LaneScheduler`` in tests) behind an
    optional ``AdmissionController``.  Without admission every request is
    submitted raw (the accept-everything baseline)."""

    def __init__(self, server: Any, admission: Optional[Any] = None):
        self.server = server
        self.sched: LaneScheduler = (
            server if isinstance(server, LaneScheduler) else server.sched
        )
        self.admission = admission

    def now_s(self) -> float:
        self.sched.sync_clock()
        return self.sched.now_s

    def advance_idle_to(self, t: float) -> None:
        _advance_scheduler_idle(self.server, self.sched, t)

    def submit(self, ev: TraceEvent, req: Any):
        if self.admission is not None:
            return self.admission.submit(req)
        if self.server is self.sched:
            self.sched.submit(req)
        else:
            self.server.submit(req)
        self.sched.admission_stats["accepted"] += 1
        return None

    def step(self) -> bool:
        return self.sched.step() is not None

    def poll(self) -> List[Any]:
        return self.sched.poll()

    def outstanding(self) -> int:
        return self.sched.pending + self.sched.in_flight + len(self.sched.done)

    def merged_telemetry(self) -> Dict[str, Any]:
        tel = dict(
            self.sched.telemetry()
            if self.server is self.sched
            else self.server.telemetry()
        )
        tel.setdefault("energy_j", tel.get("arb_energy_j", 0.0))
        tel["max_traces_per_bucket_replica"] = _max_bucket_replica_traces(tel)
        return tel


class ResidencyRouterTarget:
    """The full multi-task path: per-task ``AdmissionController``s over a
    ``ResidencyRouter``'s task servers.  Every event's ``task`` routes to
    that task's controller (quotes price the task's compressed deployment
    AND its pending eNVM swap stall), and stepping is the router's
    task-affinity arbitration."""

    def __init__(
        self,
        router: Any,
        *,
        admission: bool = True,
        admission_kwargs: Optional[Dict[str, Any]] = None,
        price_foreign_queues: bool = True,
    ):
        from functools import partial

        from repro_torch.serving.admission import AdmissionController

        self.router = router
        self.admission: Dict[str, Any] = {}
        if admission:
            kw = dict(admission_kwargs or {})
            for name, srv in router.tasks.items():
                if price_foreign_queues and "extra_wait_s" not in kw:
                    kw_task = dict(
                        kw,
                        extra_wait_s=partial(self._foreign_queued_demand_s, name),
                    )
                else:
                    kw_task = kw
                self.admission[name] = AdmissionController(srv, **kw_task)

    def _foreign_queued_demand_s(self, task: str) -> float:
        """Upper bound on the shared-clock time SIBLING tasks' QUEUED
        explicit work steals before ``task``'s next contract can run.

        The per-task controller's cross-engine term only sees siblings'
        in-flight LANES through the arbiter; their queues are invisible to
        it, and under sustained bursts the queued demand dominates — quotes
        go optimistic and accepted contracts overrun.  The router target CAN
        see the sibling queues, so it prices each sibling bucket's queued
        contracts with the same two valid upper bounds the admission layer
        uses for cross-bucket backlog: full-remaining-depth work serialized
        at the SLOWEST shared-clock operating point (no schedule runs
        slower), capped by the bucket's deadline structure (an admitted
        contract occupies the clock at most until its own absolute
        deadline).  Over-pricing only costs rejections — the miss contract
        stays one-sided.

        Deliberately NOT priced: sibling queued best-effort work.  The
        affinity policy may batch a resident task through its best-effort
        backlog ahead of a waiting non-resident contract, but charging that
        backlog to every quote rejects ~30% of otherwise-met contracts for
        a marginal miss-rate change (measured across seeds) — the policy
        preempts residency long before a full best-effort drain.  The
        residual is the just-in-time deferral tail of the JAX package's
        trace-replay harness."""
        total = 0.0
        for name, srv in self.router.tasks.items():
            if name == task:
                continue
            sched = srv.sched
            arbs = getattr(srv, "arbiters", None)
            ctrl = arbs[0].c if arbs else None
            n_layers = ctrl.stats.n_layers if ctrl is not None else None
            for b, q in sched.queues.items():
                steps = 0.0
                latest = None
                for r in q:
                    if r.deadline_s is None:
                        continue
                    rem = (
                        float(n_layers) if n_layers is not None else 1.0
                    ) - float(r.ckpt_depth or 0)
                    steps += max(rem, 1.0)
                    d_abs = r.arrival_s + r.deadline_s
                    if latest is None or d_abs > latest:
                        latest = d_abs
                if not steps:
                    continue
                if ctrl is not None:
                    dt_slow = ctrl.cycles_for_seq_len(b) / ctrl.table[0].freq_hz
                else:
                    dt_slow = float(sched.step_time_fn(b))
                steal = math.ceil(steps / sched.lanes) * dt_slow
                if latest is not None:
                    steal = min(steal, max(0.0, latest - sched.now_s))
                total += steal
        return total

    def _servers(self) -> List[Any]:
        return list(self.router.tasks.values())

    def now_s(self) -> float:
        return max(srv.sched.now_s for srv in self._servers())

    def advance_idle_to(self, t: float) -> None:
        seen: Dict[int, Any] = {}
        for srv in self._servers():
            for a in getattr(srv, "arbiters", None) or ():
                seen[id(a)] = a
        for a in seen.values():
            a.advance_to(t)
        for srv in self._servers():
            if not seen:
                srv.sched.now_s = max(srv.sched.now_s, float(t))
            srv.sched.sync_clock()

    def _outstanding_contracts(self):
        """Every accepted-but-unretired explicit contract across the task
        servers, as ``((server_id, bucket), d_abs, remaining_steps)`` — the
        demand set the displacement guard protects."""
        out = []
        for sid, srv in enumerate(self._servers()):
            sched = srv.sched
            arbs = getattr(srv, "arbiters", None)
            n_layers = (
                arbs[0].c.stats.n_layers if arbs else 1.0
            )
            for b, q in sched.queues.items():
                for r in q:
                    if r.deadline_s is None:
                        continue
                    rem = max(float(n_layers) - float(r.ckpt_depth or 0), 1.0)
                    out.append(((sid, b), r.arrival_s + r.deadline_s, rem))
            for b, run in sched._open.items():
                for i in range(sched.lanes):
                    r = run.lane_req[i]
                    if r is None or r.deadline_s is None:
                        continue
                    rem = max(float(n_layers) - float(run.lane_depth[i]), 1.0)
                    out.append(((sid, b), r.arrival_s + r.deadline_s, rem))
        return out

    def _admitting_displaces(self, ev: TraceEvent, req: Any, ac) -> bool:
        """Online EDF demand-bound test: would admitting ``req`` push any
        ALREADY-ACCEPTED contract past its deadline?

        A per-request quote prices the arrival's own wait, but EDF lets a
        later, tighter arrival insert work ahead of standing contracts —
        the quote cannot retroactively re-check them (the documented
        second-order displacement effect headroom is asked to absorb, and
        under sustained cross-task bursts does not).  The router target has
        global visibility, so it closes the loop: for every outstanding
        contract deadline ``d`` at or beyond the new request's, the total
        remaining explicit work with deadlines <= ``d`` — including the new
        request, grouped by (server, bucket) since same-bucket lanes step
        together — must fit in ``d - now`` when serialized at the SLOWEST
        shared-clock operating point (the same "no schedule runs slower"
        bound the admission layer's backlog terms use: the arbiter may
        stretch any step down to it, and the task-affinity policy may spend
        the slack on best-effort batches before an explicit contract runs).
        Any violated window is an overcommitted one, so the request is
        rejected instead of being allowed to displace a standing contract."""
        srv = self.router.tasks[ev.task]
        sched = srv.sched
        now = max(s.sched.now_s for s in self._servers())
        sid = list(self.router.tasks).index(ev.task)
        bucket = sched.bucket_for(sched.engine.bucket_key(req))
        arbs = getattr(srv, "arbiters", None)
        if not arbs:
            return False                      # no hw model: nothing to price
        ctrl = arbs[0].c
        n_layers = float(ctrl.stats.n_layers)
        d_new = now + float(req.deadline_s)
        contracts = self._outstanding_contracts()
        contracts.append(((sid, bucket), d_new, n_layers))
        lanes = sched.lanes

        def t_step(group):
            return ctrl.cycles_for_seq_len(group[1]) / ctrl.table[0].freq_hz

        deadlines = sorted({d for _, d, _ in contracts if d >= d_new})
        contracts.sort(key=lambda c: c[1])
        steps_by_group: Dict[Any, float] = {}
        i = 0
        for d in deadlines:
            while i < len(contracts) and contracts[i][1] <= d:
                g, _, rem = contracts[i]
                steps_by_group[g] = steps_by_group.get(g, 0.0) + rem
                i += 1
            demand = sum(
                math.ceil(steps / lanes) * t_step(g)
                for g, steps in steps_by_group.items()
            )
            if demand > (d - now):
                return True
        return False

    def submit(self, ev: TraceEvent, req: Any):
        assert ev.task is not None, "multi-task replay needs per-event tasks"
        ac = self.admission.get(ev.task)
        if ac is not None:
            if req.deadline_s is not None and self._admitting_displaces(
                ev, req, ac
            ):
                srv = self.router.tasks[ev.task]
                srv.sched.admission_stats["rejected"] += 1
                from types import SimpleNamespace

                return SimpleNamespace(
                    admitted=False, action="displacement_reject", shed=[]
                )
            return ac.submit(req)
        srv = self.router.tasks[ev.task]
        srv.submit(req)
        srv.sched.admission_stats["accepted"] += 1
        return None

    def step(self) -> bool:
        return self.router.step() is not None

    def poll(self) -> List[Any]:
        out: List[Any] = []
        for srv in self._servers():
            out.extend(srv.poll())
        return out

    def outstanding(self) -> int:
        return sum(
            srv.sched.pending + srv.sched.in_flight + len(srv.sched.done)
            for srv in self._servers()
        )

    def merged_telemetry(self) -> Dict[str, Any]:
        tel = dict(self.router.telemetry())     # swaps, energy (incl. swap),
                                                # accepted_slo_misses
        per = [srv.telemetry() for srv in self._servers()]
        for k in (
            "accepted", "rejected", "requoted", "shed",
            "preemptions", "restored_steps_saved", "sentences",
        ):
            tel[k] = sum(p.get(k, 0) for p in per)
        tel["step_traces"] = sum(p.get("step_traces", 0) for p in per)
        tel["max_traces_per_bucket_replica"] = max(
            (_max_bucket_replica_traces(p) for p in per), default=0
        )
        return tel


# ===========================================================================
# The replay engine
# ===========================================================================


class TraceReplayer:
    """Streams a trace through a live target on the modeled clock, in
    bounded memory, and folds a structured summary incrementally.

    The loop per event: step the system until the modeled clock reaches the
    arrival instant (or the system idles — then fast-forward, idle time
    passes), build the live ``Request`` (tokens are a pure function of
    ``(token_seed, uid)``, so a trace file needs no token payloads), submit
    through admission, and ``poll()`` after every step so retired payloads
    are released immediately.  Nothing retained scales with the trace
    length: queue-delay percentiles ride bounded reservoirs, counters fold
    at poll time, and ``peak_outstanding``/``peak_done`` record the high-
    water marks the bounded-memory tests gate on."""

    def __init__(
        self,
        target: ReplayTarget,
        *,
        vocab_size: int,
        token_seed: int = 0,
        min_token_id: int = 4,
    ):
        assert vocab_size > min_token_id >= 0
        self.target = target
        self.vocab_size = int(vocab_size)
        self.token_seed = int(token_seed)
        self.min_token_id = int(min_token_id)

    def _make_request(self, ev: TraceEvent):
        from repro_torch.serving.engine import Request   # lazy: engine <-> workload

        rng = np.random.default_rng([self.token_seed, ev.uid])
        tokens = rng.integers(
            self.min_token_id, self.vocab_size, size=ev.length, dtype=np.int32
        )
        return Request(uid=ev.uid, tokens=tokens, deadline_s=ev.deadline_s)

    def replay(self, events: Iterable[TraceEvent]) -> Dict[str, Any]:
        tgt = self.target
        delays_steps = _DelayReservoir(seed=1)
        delays_s = _DelayReservoir(seed=2)
        per_tier: Dict[str, Dict[str, int]] = {}
        per_task: Dict[str, int] = {}
        tier_of: Dict[int, str] = {}            # outstanding uid -> tier
        n_events = submitted = rejected = 0
        completed = completed_explicit = completed_be = misses = 0
        peak_out = peak_done = 0
        first_t = last_t = None

        def _tier_bucket(name: str) -> Dict[str, int]:
            return per_tier.setdefault(
                name, {"submitted": 0, "admitted": 0, "rejected": 0,
                       "completed": 0, "slo_misses": 0}
            )

        def _done_len() -> int:
            if isinstance(tgt, ResidencyRouterTarget):
                return sum(len(s.sched.done) for s in tgt._servers())
            return len(tgt.sched.done)

        def _fold(polled: List[Any]) -> None:
            nonlocal completed, completed_explicit, completed_be, misses
            for r in polled:
                completed += 1
                tb = _tier_bucket(tier_of.pop(r.uid, "unknown"))
                tb["completed"] += 1
                if r.first_compute_step is not None and r.arrival_step is not None:
                    delays_steps.add(r.first_compute_step - r.arrival_step)
                delays_s.add(max(0.0, r.admit_s - r.arrival_s))
                if r.deadline_s is not None:
                    completed_explicit += 1
                    if r.retire_s - r.arrival_s > r.deadline_s * (1 + 1e-9):
                        misses += 1
                        tb["slo_misses"] += 1
                else:
                    completed_be += 1

        def _track_peaks() -> None:
            nonlocal peak_out, peak_done
            peak_out = max(peak_out, tgt.outstanding())
            peak_done = max(peak_done, _done_len())

        for ev in events:
            n_events += 1
            first_t = ev.t_s if first_t is None else first_t
            last_t = ev.t_s
            while tgt.now_s() + 1e-12 < ev.t_s and tgt.step():
                _fold(tgt.poll())
                _track_peaks()
            if tgt.now_s() < ev.t_s:
                tgt.advance_idle_to(ev.t_s)     # idle gap: time passes
            req = self._make_request(ev)
            decision = tgt.submit(ev, req)
            submitted += 1
            tb = _tier_bucket(ev.tier)
            tb["submitted"] += 1
            if ev.task is not None:
                per_task[ev.task] = per_task.get(ev.task, 0) + 1
            if decision is not None and not decision.admitted:
                rejected += 1
                tb["rejected"] += 1
            else:
                tb["admitted"] += 1
                tier_of[ev.uid] = ev.tier
            _fold(tgt.poll())
            _track_peaks()
        while tgt.step():                       # drain the tail
            _fold(tgt.poll())
            _track_peaks()
        _fold(tgt.poll())

        tel = tgt.merged_telemetry()
        shed = int(tel.get("shed", 0))
        # shed requests never retire: drop their tier tracking so the
        # outstanding map stays bounded after the drain
        if shed:
            tier_of.clear()
        span = max(0.0, tgt.now_s() - (first_t or 0.0))
        energy = float(tel.get("energy_j", tel.get("arb_energy_j", 0.0)) or 0.0)
        summary: Dict[str, Any] = {
            "requests": n_events,
            "submitted": submitted,
            "accepted": int(tel.get("accepted", 0)),
            "rejected": int(tel.get("rejected", rejected)),
            "requoted": int(tel.get("requoted", 0)),
            "shed": shed,
            "completed": completed,
            "completed_explicit": completed_explicit,
            "completed_best_effort": completed_be,
            "accepted_slo_misses": misses,
            "accepted_slo_miss_rate": (
                misses / completed_explicit if completed_explicit else 0.0
            ),
            "queue_delay_steps_p50": delays_steps.percentile(50),
            "queue_delay_steps_p95": delays_steps.percentile(95),
            "queue_delay_steps_p99": delays_steps.percentile(99),
            "queue_delay_s_p50": delays_s.percentile(50),
            "queue_delay_s_p95": delays_s.percentile(95),
            "queue_delay_s_p99": delays_s.percentile(99),
            "modeled_span_s": span,
            "throughput_rps": completed / span if span > 0.0 else 0.0,
            "energy_j": energy,
            "energy_per_request_j": energy / completed if completed else 0.0,
            "preemptions": int(tel.get("preemptions", 0)),
            "step_traces": int(tel.get("step_traces", 0)),
            "max_traces_per_bucket_replica": int(
                tel.get("max_traces_per_bucket_replica", 0)
            ),
            "peak_outstanding": peak_out,
            "peak_done": peak_done,
            "per_tier": {k: dict(v) for k, v in sorted(per_tier.items())},
            "per_task": dict(sorted(per_task.items())),
        }
        for k in ("task_swaps", "swap_stall_s", "swap_energy_j"):
            if k in tel:
                summary[k] = tel[k]
        if "degraded_tasks" in tel:
            summary["degraded_tasks"] = list(tel["degraded_tasks"])
        return summary


def summaries_identical(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Bit-identical summary comparison (the determinism acceptance gate):
    serialized with sorted keys so nested dict ordering cannot hide a
    difference — floats must match exactly, not approximately."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
