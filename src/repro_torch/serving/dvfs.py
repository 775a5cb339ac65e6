"""Sentence-level latency-aware DVFS (paper Alg. 1, §IV; system Fig. 9).

EdgeBERT's headline mechanism: entropy-based early-exit *prediction* drives
dynamic voltage-frequency scaling per sentence, so each inference finishes
"just in time" at the lowest energy instead of racing to idle at max clock.

Mapping to the paper:

  * **Alg. 1 line 1** (run the first encoder layer at nominal VDD/freq):
    ``sentence_report`` always charges layer 1 at the table's top operating
    point — the LDO/ADPLL switch only after the first off-ramp is evaluated.
  * **Alg. 1 line 2** (predict the exit layer from the first off-ramp's
    entropy): ``core.early_exit.ExitPredictor``, a binned LUT calibrated
    offline (``calibrate_predictor``) — the ASIC's small SRAM table.
  * **Alg. 1 lines 3-4** (pick the minimum (V, f) that finishes the predicted
    remaining layers within the latency target): ``select_op`` scans the
    ``DVFS table`` (fast-switching LDO + ADPLL operating points, Fig. 9's
    clock/power management blocks) for the slowest point whose frequency
    still meets ``remaining_cycles / remaining_time``.
  * **Misprediction guard**: if the sentence has not exited by its predicted
    layer, remaining layers escalate to the maximum operating point so the
    latency target stays bounded (the paper's latency-aware guarantee).
  * **Energy accounting**: per-layer energy comes from the calibrated
    accelerator model (``hwmodel.edgebert_accel``); dynamic energy scales as
    (VDD/VDD_NOM)^2 and latency as cycles/f, so the DVFS win is quadratic in
    the voltage headroom the early-exit prediction uncovers.

The controller is deliberately analytic + host-side: the deployed model
(``serving/deploy.py``) records each sentence's off-ramp entropy trace, and
the controller replays Alg. 1 over that trace to produce the per-sentence
(V, f) schedule and energy/latency report.  This is the JAX package's
``serving/dvfs.py`` (per-sentence controller and the batched shared-clock
arbiter), copied as it is: numpy and Python only, apart from
``calibrate_predictor``, which runs the model's dense forward offline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.early_exit import (
    ExitPredictor,
    OnlineExitCalibrator,
    fit_exit_predictor,
    predict_exit_layer,
)
from repro_torch.hwmodel.edgebert_accel import (
    CLOCK_HZ,
    VDD_NOM,
    WorkloadStats,
    accel_power_mw,
    albert_layer_stats,
    layer_cycles,
    layer_energy_j,
    op_switch_overhead,
    scale_stats_to_seq_len,
)


@dataclass(frozen=True)
class OperatingPoint:
    """One LDO/ADPLL setting: supply voltage (V) and clock frequency (Hz)."""

    vdd: float
    freq_hz: float


# Fast-switching LDO (25mV steps) + ADPLL operating points for the 12nm
# design; the top entry is the nominal point the TableV anchors are fitted
# at.  Voltage ascends with frequency, so per-cycle energy is monotone in
# the table index — the property the controller's energy guarantees rest on.
DEFAULT_DVFS_TABLE: Tuple[OperatingPoint, ...] = (
    OperatingPoint(0.50, 100e6),
    OperatingPoint(0.55, 166e6),
    OperatingPoint(0.60, 250e6),
    OperatingPoint(0.65, 333e6),
    OperatingPoint(0.70, 400e6),
    OperatingPoint(VDD_NOM, CLOCK_HZ),
)


@dataclass
class DVFSReport:
    """Per-sentence outcome of Alg. 1."""

    exit_layer: int
    predicted_exit: float
    op: OperatingPoint              # point selected after the first off-ramp
    latency_s: float
    energy_j: float
    deadline_met: bool
    energy_max_freq_j: float        # same exit schedule, always at max V/f
    escalated_layers: int           # layers run at max point after a mispredict


def no_early_exit_baseline(
    stats: WorkloadStats,
    *,
    n: int = 16,
    op: OperatingPoint = DEFAULT_DVFS_TABLE[-1],
    use_span: bool = True,
    use_sparsity: bool = True,
) -> Dict[str, float]:
    """Conventional inference: all ``stats.n_layers`` layers at ``op``.

    Standalone so callers can derive a latency target BEFORE constructing the
    controller (the usual idiom: target = the full-model latency).
    """
    cyc = layer_cycles(stats, n, use_span=use_span)
    e = layer_energy_j(stats, n, vdd=op.vdd, use_span=use_span, use_sparsity=use_sparsity)
    L = stats.n_layers
    return {"latency_s": L * cyc / op.freq_hz, "energy_j": L * e}


class LatencyAwareDVFSController:
    """Replays paper Alg. 1 over a sentence's off-ramp entropy trace.

    Parameters
    ----------
    stats:            workload statistics of ONE encoder layer pass (from the
                      JAX model or ``albert_layer_stats``).
    target_latency_s: the prescribed per-sentence latency target T.
    predictor:        entropy -> exit-layer LUT; ``None`` predicts the full
                      ``stats.n_layers`` (conservative: never misses deadline,
                      saves least energy).
    """

    def __init__(
        self,
        stats: WorkloadStats,
        target_latency_s: float,
        *,
        table: Sequence[OperatingPoint] = DEFAULT_DVFS_TABLE,
        n: int = 16,
        predictor: Optional[ExitPredictor] = None,
        online_calibrator: Optional[OnlineExitCalibrator] = None,
        use_span: bool = True,
        use_sparsity: bool = True,
    ):
        assert target_latency_s > 0
        table = tuple(sorted(table, key=lambda p: p.freq_hz))
        assert all(
            a.vdd <= b.vdd for a, b in zip(table, table[1:])
        ), "DVFS table voltage must ascend with frequency"
        self.stats = stats
        self.target_latency_s = float(target_latency_s)
        self.table = table
        self.n = n
        self.predictor = predictor
        # online mode: the LUT is a set of RUNNING per-bin quantiles updated
        # by observe_exit() as sentences retire (no offline profiling pass);
        # takes precedence over a static ``predictor`` once armed
        self.online = online_calibrator
        self._use_span = use_span
        self.cycles_per_layer = layer_cycles(stats, n, use_span=use_span)
        self._bucket_cycles: Dict[int, float] = {int(stats.seq_len): self.cycles_per_layer}
        # per-layer energy at each table point: E ~ (V/V_nom)^2, f-independent
        self._e_layer = {
            op: layer_energy_j(
                stats, n, vdd=op.vdd, use_span=use_span, use_sparsity=use_sparsity
            )
            for op in table
        }

    # ----------------------------------------------------------- primitives
    @property
    def max_op(self) -> OperatingPoint:
        return self.table[-1]

    def layer_time_s(self, op: OperatingPoint) -> float:
        return self.cycles_per_layer / op.freq_hz

    def layer_energy(self, op: OperatingPoint) -> float:
        return self._e_layer[op]

    def cycles_for_seq_len(self, seq_len: int) -> float:
        """Per-bucket cycle model: layer cycles at ``seq_len``, from the
        controller's stats rescaled token-linearly (matmul/vector) and
        token-quadratically (attention scores).  Cached per length — this is
        what lets the batched arbiter budget each lane at ITS bucket's cost
        instead of the largest bucket's (ROADMAP per-bucket-cycles item)."""
        key = int(seq_len)
        if key not in self._bucket_cycles:
            self._bucket_cycles[key] = layer_cycles(
                scale_stats_to_seq_len(self.stats, key), self.n,
                use_span=self._use_span,
            )
        return self._bucket_cycles[key]

    def op_for_freq(self, need_hz: float) -> OperatingPoint:
        """Slowest table point with freq >= need_hz (max point if none) —
        the single op-selection rule shared by per-sentence Alg. 1 and the
        batched arbiter, so the two cannot drift apart."""
        for op in self.table:
            if op.freq_hz >= need_hz:
                return op
        return self.max_op

    def select_op(self, predicted_remaining: float, remaining_time_s: float) -> OperatingPoint:
        """Alg. 1 lines 3-4: slowest point meeting the remaining budget."""
        if remaining_time_s <= 0:
            return self.max_op
        need_hz = max(predicted_remaining, 0.0) * self.cycles_per_layer / remaining_time_s
        return self.op_for_freq(need_hz)

    def predict(self, first_entropy: float) -> float:
        if self.online is not None:
            p = self.online.predict(first_entropy)
        elif self.predictor is not None:
            p = predict_exit_layer(self.predictor, first_entropy)
        else:
            return float(self.stats.n_layers)
        return float(np.clip(p, 1.0, self.stats.n_layers))

    def observe_exit(self, first_entropy: float, exit_layer: int) -> None:
        """Online calibration: fold a retired sentence's (first entropy, exit
        layer) into the running per-bin quantiles — the LUT adapts DURING a
        drain instead of needing the offline ``calibrate_predictor`` pass."""
        if self.online is not None:
            self.online.observe(first_entropy, exit_layer)

    # -------------------------------------------------------------- Alg. 1
    def sentence_report(
        self,
        entropy_trace: Sequence[float],
        exit_layer: Optional[int] = None,
        *,
        target_latency_s: Optional[float] = None,
    ) -> DVFSReport:
        """Run Alg. 1 for one sentence given its per-layer off-ramp entropies.

        ``entropy_trace[i]`` is the entropy after layer i+1; the trace ends at
        the layer the sentence exited (``exit_layer`` defaults to its length).
        ``target_latency_s`` overrides the controller-global target with a
        per-request deadline (the serving engine passes ``Request.deadline_s``).
        """
        target = (
            self.target_latency_s if target_latency_s is None else float(target_latency_s)
        )
        assert target > 0
        if exit_layer is None:
            exit_layer = len(entropy_trace)
        assert exit_layer >= 1 and len(entropy_trace) >= 1
        t_max = self.layer_time_s(self.max_op)
        e_max = self.layer_energy(self.max_op)

        # line 1: the first layer always runs at the nominal/maximum point
        latency = t_max
        energy = e_max
        if exit_layer == 1:
            return DVFSReport(
                exit_layer=1,
                predicted_exit=1.0,
                op=self.max_op,
                latency_s=latency,
                energy_j=energy,
                deadline_met=latency <= target * (1 + 1e-9),
                energy_max_freq_j=e_max,
                escalated_layers=0,
            )

        # line 2: predict the total exit layer from the first off-ramp entropy
        predicted = max(self.predict(entropy_trace[0]), 2.0)
        # lines 3-4: slowest (V, f) finishing the predicted remainder in time
        op = self.select_op(predicted - 1.0, target - latency)

        escalated = 0
        for li in range(2, exit_layer + 1):
            # misprediction guard: past the predicted exit, bound the latency
            # by escalating to the maximum operating point
            cur = op if li <= predicted + 1e-9 else self.max_op
            if cur is self.max_op and li > predicted:
                escalated += 1
            latency += self.layer_time_s(cur)
            energy += self.layer_energy(cur)
        return DVFSReport(
            exit_layer=int(exit_layer),
            predicted_exit=predicted,
            op=op,
            latency_s=latency,
            energy_j=energy,
            deadline_met=latency <= target * (1 + 1e-9),
            energy_max_freq_j=exit_layer * e_max,
            escalated_layers=escalated,
        )

    # ----------------------------------------------------------- baselines
    def no_early_exit_baseline(self) -> Dict[str, float]:
        """Conventional inference: all n_layers, always at the max point."""
        L = self.stats.n_layers
        return {
            "latency_s": L * self.layer_time_s(self.max_op),
            "energy_j": L * self.layer_energy(self.max_op),
        }  # == module-level no_early_exit_baseline(self.stats) at defaults

    def max_freq_early_exit_baseline(self, exit_layers: Sequence[int]) -> Dict[str, float]:
        """Latency-unbounded early exit: race to the exit at max V/f."""
        t = self.layer_time_s(self.max_op)
        e = self.layer_energy(self.max_op)
        exits = np.asarray(list(exit_layers), np.float64)
        return {
            "latency_s": float(exits.max() * t) if exits.size else 0.0,
            "energy_j": float(exits.sum() * e),
        }


# ===========================================================================
# Batched shared-clock arbitration (single LDO/ADPLL across all lanes)
# ===========================================================================


@dataclass
class _LaneClock:
    """Arbiter-side state of one in-flight lane."""

    admit_s: float                        # modeled admission time
    deadline_s: float                     # admit + this lane's OWN target
    target_s: float                       # the lane's latency budget (per-
                                          # request SLO or controller target)
    cycles_per_layer: float               # this lane's BUCKET layer cost
    depth: int = 0                        # layers completed (decode lanes:
                                          # summed over the tokens generated)
    tokens: int = 0                       # decode lanes: tokens ACCEPTED so
                                          # far (speculative fused steps may
                                          # accept several per step; depth
                                          # stays the layer-true energy/clock
                                          # integral while tokens carries the
                                          # throughput the DVFS re-budget and
                                          # the bench gates reason about)
    predicted_exit: Optional[float] = None  # set after the first off-ramp
    first_entropy: Optional[float] = None
    energy_j: float = 0.0
    # per-lane power ratio vs the controller anchor (compressed deployments:
    # sparsity/span power gating the cycles ratio alone cannot express)
    energy_scale: float = 1.0
    slowest_op: Optional[OperatingPoint] = None
    # decode lanes: predicted layers still to run across ALL remaining tokens
    # (position-binned per-token exit predictions, conservative full depth
    # cold).  When set it REPLACES the classifier entropy-LUT chain in
    # ``required_hz`` — the engine refreshes it before every fused step.
    pred_layers_remaining: Optional[float] = None


@dataclass
class ArbiterStepDecision:
    """Outcome of one fused-step arbitration."""

    op: OperatingPoint
    dt_s: float                           # step duration incl. any switch stall
    switched: bool
    need_hz: Dict[int, float]             # per-lane required frequency (inf =
                                          # first layer / escalation / no slack)


@dataclass
class LaneDVFSReport:
    """Per-sentence outcome under shared-clock arbitration."""

    exit_layer: int
    predicted_exit: float
    latency_s: float
    energy_j: float
    deadline_met: bool
    escalated_layers: int
    slowest_op: OperatingPoint            # lowest point the sentence ran at
    target_s: float = 0.0                 # the deadline the lane was judged by


class BatchedDVFSArbiter:
    """ONE (V, f) decision per fused step across all in-flight lanes.

    The EdgeBERT accelerator has a single LDO/ADPLL pair, so a batched
    deployment cannot replay Alg. 1 per sentence — the clock is shared.  The
    arbiter generalizes Alg. 1 to the lane set: every fused step it computes
    each active lane's *required* frequency (predicted remaining layers over
    remaining time-to-deadline, exactly Alg. 1 lines 3-4 evaluated live) and
    drives the shared clock at the slowest table point satisfying the MAX of
    those requirements.  Lanes that have not evaluated their first off-ramp
    yet (Alg. 1 line 1) and lanes past their predicted exit (misprediction
    escalation) require the maximum point.  Every operating-point change is
    charged the LDO/ADPLL switching stall (`hwmodel.op_switch_overhead`) —
    the cost a per-sentence replay never models.

    Per-request deadlines: ``admit`` accepts the lane's OWN latency budget
    (``deadline_s``; the serving engine passes ``Request.deadline_s``), so
    the shared-clock decision maximizes slack per lane against THAT lane's
    deadline — the controller-global target is only the fallback.  It also
    accepts the lane's bucket-specific ``cycles_per_layer``: required
    frequency, step duration, and energy are all budgeted at the lane's OWN
    bucket cost instead of the largest bucket's.

    Lane keys are opaque hashables — the engine uses (server, bucket, lane)
    tuples because cross-bucket time slicing keeps several buckets' lanes in
    flight at once.

    The arbiter advances a MODELED clock (`now_s`); per-sentence latency is
    measured from lane admission, matching the per-sentence controller's
    accounting (queue wait is a scheduler concern, not a DVFS one).
    """

    def __init__(self, controller: LatencyAwareDVFSController):
        self.c = controller
        self.now_s = 0.0
        self.cur_op: Optional[OperatingPoint] = None
        self._lanes: Dict[int, _LaneClock] = {}
        # ---- drain-level telemetry ----
        self.op_switches = 0
        self.switch_time_s = 0.0
        self.switch_energy_j = 0.0
        self.compute_energy_j = 0.0
        self.steps = 0
        self.lane_steps = 0          # lane participations summed over steps
        self.tokens_accepted = 0     # decode tokens accepted (spec blocks
                                     # count every accepted token)

    # ------------------------------------------------------------ lifecycle
    def admit(
        self,
        lane,
        *,
        deadline_s: Optional[float] = None,
        cycles_per_layer: Optional[float] = None,
        energy_scale: float = 1.0,
    ) -> None:
        """A request entered a lane: its deadline clock starts now.

        ``deadline_s``: this lane's OWN latency budget (``Request.deadline_s``);
        ``None`` falls back to the controller-global target.
        ``cycles_per_layer``: the lane's bucket-specific layer cost; ``None``
        uses the controller's (largest-bucket) stats.
        ``energy_scale``: this lane's per-layer POWER ratio against the
        controller anchor.  Compressed deployments (pruning/span) gate power
        beyond what the cycles ratio captures — the engine passes
        P(task stats)/P(anchor stats) so lane energy prices the task's actual
        sparse network.
        """
        assert lane not in self._lanes, f"lane {lane} already in flight"
        target = self.c.target_latency_s if deadline_s is None else float(deadline_s)
        assert target > 0
        assert energy_scale > 0
        self._lanes[lane] = _LaneClock(
            admit_s=self.now_s,
            deadline_s=self.now_s + target,
            target_s=target,
            cycles_per_layer=(
                self.c.cycles_per_layer if cycles_per_layer is None
                else float(cycles_per_layer)
            ),
            energy_scale=float(energy_scale),
        )

    def observe_entropy(self, lane, entropy: float) -> None:
        """First off-ramp evaluated: Alg. 1 line 2 prediction for this lane."""
        st = self._lanes[lane]
        if st.predicted_exit is None:
            st.first_entropy = float(entropy)
            st.predicted_exit = max(self.c.predict(entropy), float(st.depth + 1))

    def set_remaining_layers(self, lane, layers: float) -> None:
        """Decode lanes: refresh the predicted layers this lane still needs
        across ALL its remaining tokens (the engine sums its position-binned
        per-token exit predictions, conservative full depth per token while
        the calibrator is cold).  Overrides the classifier entropy-LUT chain
        in ``required_hz`` — per-token escalation is folded into the
        prediction itself (the calibrator's quantile tracks realized depths,
        and every fused step re-budgets from the refreshed value)."""
        self._lanes[lane].pred_layers_remaining = max(float(layers), 0.0)

    def required_hz(self, lane) -> float:
        """Frequency this lane needs from the SHARED clock right now.

        Before the first off-ramp there is no prediction (Alg. 1 line 1), so
        the lane conservatively budgets the FULL remaining depth — at a
        slack-free target that is exactly the nominal frequency, the paper's
        run-layer-1-at-nominal rule, and it scales down when the target has
        headroom.  inf encodes 'maximum point, unconditionally': a lane past
        its predicted exit escalates (misprediction guard), and exhausted
        slack leaves no choice.  Remaining work is costed at the lane's OWN
        bucket cycles and judged against the lane's OWN deadline.

        Decode lanes (``set_remaining_layers``) substitute the token-level
        predicted remainder for the classifier entropy chain — same
        remaining-cycles-over-remaining-time rule, Alg. 1 lines 3-4 on the
        token timeline.
        """
        st = self._lanes[lane]
        if st.pred_layers_remaining is not None:
            t_rem = st.deadline_s - self.now_s
            if t_rem <= 0:
                return float("inf")
            return st.pred_layers_remaining * st.cycles_per_layer / t_rem
        predicted = st.predicted_exit
        if predicted is None:
            predicted = float(self.c.stats.n_layers)   # conservative line 1
        elif st.depth + 1 > predicted + 1e-9:
            return float("inf")          # escalation: past the predicted exit
        t_rem = st.deadline_s - self.now_s
        if t_rem <= 0:
            return float("inf")
        remaining = predicted - st.depth
        return remaining * st.cycles_per_layer / t_rem

    def step(
        self, active_lanes: Sequence, layers: Optional[Dict] = None,
        *, floor_hz: float = 0.0, tokens: Optional[Dict] = None,
    ) -> ArbiterStepDecision:
        """Arbitrate + account ONE fused step over ``active_lanes``.

        The scheduler steps one bucket at a time, so the stepped lanes share
        a bucket; the step duration is that bucket's layer time (max over the
        stepped lanes' cycle costs) and each lane's energy is charged at its
        own bucket's cost.

        ``layers`` (optional): layers each lane actually executed this fused
        step.  Classifier fused steps run exactly ONE encoder layer per lane
        (the default); a decode fused step runs one TOKEN per lane, whose
        realized cost is that token's early-exit depth — the engine passes
        ``{lane: exit_depth}`` so energy and step duration charge only the
        layers the off-ramp let run.  The (V, f) decision itself is made
        from pre-step state (the refreshed per-lane predictions), exactly as
        in the per-layer case.

        ``floor_hz``: barrier-aware pacing for replicated clock domains.  The
        fused step is SPMD — every replica leaves the collective together, so
        the FLEET step lasts as long as its slowest domain.  Running a domain
        slower than the fleet's tightest lane requirement saves no energy
        (the tight domain sets the wall time either way) and silently spends
        OTHER domains' deadline slack through the barrier, so the engine
        passes the fleet-wide max required frequency as a floor on every
        domain's pick.  Single-domain serving passes nothing: the floor
        degenerates to this arbiter's own requirement.

        ``tokens`` (optional): tokens each lane ACCEPTED this fused step.
        A speculative decode step accepts a block, so its lane runs
        ``sum(block exit depths)`` layers but advances several tokens — the
        engine passes ``{lane: accepted}`` alongside ``layers`` so the
        arbiter's throughput telemetry (tokens per lane-step) prices the
        clock's work in tokens while energy/time stay layer-true.
        """
        lanes = list(active_lanes)
        assert lanes, "step() needs at least one active lane"
        need = {i: self.required_hz(i) for i in lanes}
        op = self.c.op_for_freq(max(max(need.values()), floor_hz))

        switched = self.cur_op is not None and op != self.cur_op
        if switched:
            ov = op_switch_overhead(
                self.cur_op.vdd, self.cur_op.freq_hz, op.vdd, op.freq_hz,
                power_mw_nom=self._power_mw_nom(),
            )
            self.op_switches += 1
            self.switch_time_s += ov["time_s"]
            self.switch_energy_j += ov["energy_j"]
            self.now_s += ov["time_s"]   # the stall spends every lane's slack
        self.cur_op = op

        e_layer = self.c.layer_energy(op)
        step_cycles = 0.0
        for i in lanes:
            st = self._lanes[i]
            nl = 1 if layers is None else int(layers[i])
            assert nl >= 1, f"lane {i}: a fused step runs at least one layer"
            st.depth += nl
            nt = 0 if tokens is None else int(tokens.get(i, 0))
            assert nt <= nl, f"lane {i}: cannot accept more tokens than layers"
            st.tokens += nt
            self.tokens_accepted += nt
            self.lane_steps += 1
            # energy ~ P(V) * cycles / f: scale the controller's per-layer
            # energy by this lane's bucket cycle ratio and its deployment's
            # power ratio (sparsity/span gating vs the anchor stats)
            e_lane = (
                nl * e_layer * st.energy_scale
                * (st.cycles_per_layer / self.c.cycles_per_layer)
            )
            st.energy_j += e_lane
            self.compute_energy_j += e_lane
            step_cycles = max(step_cycles, nl * st.cycles_per_layer)
            if st.slowest_op is None or op.freq_hz < st.slowest_op.freq_hz:
                st.slowest_op = op
        dt = step_cycles / op.freq_hz
        self.now_s += dt
        self.steps += 1
        return ArbiterStepDecision(op=op, dt_s=dt, switched=switched, need_hz=need)

    def advance_to(self, t: float) -> None:
        """Fast-forward the modeled clock to ``t`` (monotone; no-op if behind).

        Replicated serving runs one arbiter per device, but the fused step is
        SPMD: every replica leaves the collective barrier together, so after
        arbitrating its own lanes each replica's clock is pulled up to the
        fleet max.  Waiting at a barrier burns wall time, not operating-point
        changes — no energy or (V, f) state is touched.
        """
        self.now_s = max(self.now_s, float(t))

    def checkpoint_lane(self, lane) -> _LaneClock:
        """Preemption support: detach a lane's clock so the lane index can be
        reused, FREEZING the lane's remaining budget while it sits parked in
        the scheduler queue (parked time is a scheduling decision, not lane
        latency — the DVFS layer keeps budgeting compute only).  The returned
        clock stores elapsed-running-time in ``admit_s`` and budget-left in
        ``deadline_s``; ``restore_lane`` re-anchors both."""
        st = self._lanes.pop(lane)
        st.deadline_s = st.deadline_s - self.now_s    # remaining budget
        st.admit_s = self.now_s - st.admit_s          # elapsed running time
        return st

    def restore_lane(self, lane, clock: _LaneClock) -> None:
        """Re-admit a checkpointed lane clock under a (possibly different)
        lane key: depth, energy, prediction, and slowest-op carry over, the
        deadline re-arms with the frozen remaining budget (floored at a
        sliver: an already-late lane races at max V/f)."""
        assert lane not in self._lanes, f"lane {lane} already in flight"
        clock.admit_s = self.now_s - clock.admit_s
        clock.deadline_s = self.now_s + max(clock.deadline_s, 1e-12)
        self._lanes[lane] = clock

    def min_latency_quote(
        self, predicted_layers: float, cycles_per_layer: Optional[float] = None
    ) -> float:
        """Floor on achievable lane latency: the admission-control quote.

        ``predicted_layers`` at the MAXIMUM operating point — no schedule can
        beat the top table entry — plus ONE worst-case LDO/ADPLL switching
        stall (admitting a slack-free lane may yank the shared clock from the
        table's slowest point to its fastest).  An explicit SLO below this is
        physically infeasible and must be rejected or re-quoted at admission
        time instead of accepted and missed.
        """
        cyc = (
            self.c.cycles_per_layer if cycles_per_layer is None
            else float(cycles_per_layer)
        )
        lo, hi = self.c.table[0], self.c.max_op
        stall = op_switch_overhead(
            lo.vdd, lo.freq_hz, hi.vdd, hi.freq_hz,
            power_mw_nom=self._power_mw_nom(),
        )["time_s"]
        return max(predicted_layers, 0.0) * cyc / hi.freq_hz + stall

    def retire(self, lane, exit_layer: int) -> LaneDVFSReport:
        """Lane exited: close its clock, emit its report, free the lane."""
        st = self._lanes.pop(lane)
        assert st.depth == exit_layer, (st.depth, exit_layer)
        latency = self.now_s - st.admit_s
        predicted = (
            st.predicted_exit if st.predicted_exit is not None else float(exit_layer)
        )
        # layers whose index exceeded the prediction ran escalated (matches
        # the per-sentence controller: li > predicted -> max point)
        escalated = max(0, exit_layer - int(np.floor(predicted + 1e-9)))
        # online calibration: the retired sentence feeds the running LUT
        if st.first_entropy is not None:
            self.c.observe_exit(st.first_entropy, exit_layer)
        return LaneDVFSReport(
            exit_layer=int(exit_layer),
            predicted_exit=predicted,
            latency_s=latency,
            energy_j=st.energy_j,
            deadline_met=latency <= st.target_s * (1 + 1e-9),
            escalated_layers=escalated,
            slowest_op=st.slowest_op if st.slowest_op is not None else self.c.max_op,
            target_s=st.target_s,
        )

    # ------------------------------------------------------------ accounting
    def _power_mw_nom(self) -> float:
        return accel_power_mw(self.c.stats, self.c.n)["total"]

    @property
    def in_flight(self) -> int:
        return len(self._lanes)

    @property
    def total_energy_j(self) -> float:
        """Compute + switching energy of everything arbitrated so far."""
        return self.compute_energy_j + self.switch_energy_j

    def telemetry(self) -> Dict[str, float]:
        return {
            "arb_steps": self.steps,
            "op_switches": self.op_switches,
            "switch_time_s": self.switch_time_s,
            "switch_energy_j": self.switch_energy_j,
            "compute_energy_j": self.compute_energy_j,
            "total_energy_j": self.total_energy_j,
            "modeled_time_s": self.now_s,
            "lane_steps": self.lane_steps,
            "tokens_accepted": self.tokens_accepted,
            "tokens_per_lane_step": (
                self.tokens_accepted / self.lane_steps if self.lane_steps else 0.0
            ),
        }

    # ------------------------------------------------------------- batch API
    def replay_batch(
        self,
        entropy_traces: Sequence[Sequence[float]],
        exit_layers: Sequence[int],
        deadlines_s: Optional[Sequence[Optional[float]]] = None,
    ) -> List[LaneDVFSReport]:
        """Arbitrate a lock-step batch (the kernel-path ``classify`` schedule).

        All sentences are admitted at once (no refill — the deployed
        accelerator's layer-serial batch), stepped together while active, and
        retired at their recorded exit layers.  This is the batched
        counterpart of replaying ``sentence_report`` per sentence.
        ``deadlines_s`` gives each sentence its own latency budget (``None``
        entries fall back to the controller target).
        """
        assert self.in_flight == 0, "replay_batch needs an idle arbiter"
        exits = [int(e) for e in exit_layers]
        assert len(entropy_traces) == len(exits) and all(e >= 1 for e in exits)
        assert deadlines_s is None or len(deadlines_s) == len(exits)
        for i in range(len(exits)):
            self.admit(
                i, deadline_s=None if deadlines_s is None else deadlines_s[i]
            )
        reports: Dict[int, LaneDVFSReport] = {}
        depth = 0
        while True:
            active = [i for i, e in enumerate(exits) if depth < e]
            if not active:
                break
            self.step(active)
            depth += 1
            for i in active:
                if depth == 1:
                    self.observe_entropy(i, entropy_traces[i][0])
                if depth == exits[i]:
                    reports[i] = self.retire(i, depth)
        return [reports[i] for i in range(len(exits))]


def calibrate_predictor(
    model, params, batches, n_bins: int = 16, quantile: Optional[float] = None
) -> ExitPredictor:
    """Fit the Alg. 1 LUT from dense profiling passes (offline calibration).

    ``batches`` is an iterable of ``{"tokens": [B, S]}``-style dicts; the
    model's dense all-layers forward (``Model.apply_train``, plain PyTorch
    ops on the params' device) provides (first-off-ramp entropy, exit
    layer) pairs at the configured entropy threshold.  ``quantile`` picks
    the conservative per-bin prediction (see ``fit_exit_predictor``).
    """
    import torch

    ents: List[np.ndarray] = []
    exits: List[np.ndarray] = []
    for b in batches:
        with torch.no_grad():
            out = model.apply_train(params, {"tokens": b["tokens"]})
        assert out.all_entropies is not None and out.exit_layer is not None
        ents.append(out.all_entropies[0].cpu().numpy())
        exits.append(out.exit_layer.cpu().numpy())
    return fit_exit_predictor(
        np.concatenate(ents), np.concatenate(exits), n_bins=n_bins, quantile=quantile
    )


def default_albert_controller(
    target_latency_s: float,
    *,
    seq_len: int = 128,
    n: int = 16,
    n_layers: int = 12,
    avg_exit_layer: Optional[float] = None,
    predictor: Optional[ExitPredictor] = None,
    online_calibrator: Optional[OnlineExitCalibrator] = None,
) -> LatencyAwareDVFSController:
    """Controller over the analytic ALBERT-base layer workload (Fig. 8)."""
    stats = albert_layer_stats(seq_len=seq_len)
    stats.n_layers = n_layers
    if avg_exit_layer is not None:
        stats.avg_exit_layer = avg_exit_layer
    return LatencyAwareDVFSController(
        stats, target_latency_s, n=n, predictor=predictor,
        online_calibrator=online_calibrator,
    )
