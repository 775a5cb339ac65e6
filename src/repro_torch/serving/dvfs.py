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
    offline (``fit_exit_predictor``) — the ASIC's small SRAM table.
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
(V, f) schedule and energy/latency report.  This is the per-sentence part of
the JAX package's ``serving/dvfs.py``, copied as it is (numpy and Python
only); the batched shared-clock arbiter comes with the serving slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.early_exit import (
    ExitPredictor,
    OnlineExitCalibrator,
    predict_exit_layer,
)
from repro_torch.hwmodel.edgebert_accel import (
    CLOCK_HZ,
    VDD_NOM,
    WorkloadStats,
    albert_layer_stats,
    layer_cycles,
    layer_energy_j,
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
        drain instead of needing the offline ``fit_exit_predictor`` pass."""
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
