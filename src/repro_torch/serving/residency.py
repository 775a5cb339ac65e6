"""Multi-task residency: compression-aware deployments, eNVM task-swap
costs, and task-affinity-aware scheduling (paper §III-D + Table I stacked
onto the serving stack).

The paper's headline energy numbers come from the compression triad —
adaptive attention span, movement pruning, AdaptivFloat — applied PER TASK,
with every task's sparse weight set resident in eNVM and a bounded SRAM
working set serving the hot tasks.  This module turns those ``core/``
primitives into serving features:

* ``TaskDeployment`` — one task's compression configuration (span budget,
  pruning occupancy, AdaptivFloat format).  Its sparsity/span factors flow
  into the hwmodel via ``deployment_stats`` (a ``WorkloadStats`` of the
  COMPRESSED network), so ``cycles_for_seq_len``, DVFS arbitration, and
  admission quotes price the savings instead of dense full-precision work,
  and its bitmask-encoded footprint (``bitmask.storage_bytes`` accounting)
  prices the eNVM->SRAM swap.
* ``TaskResidencyManager`` — a bounded SRAM working set over an eNVM
  backing store.  Resident tasks serve immediately; a non-resident task
  pays a modeled power-on read of its sparse-encoded footprint
  (``hwmodel.task_swap_cost`` — the Fig. 11 machinery applied to task
  weights) charged as a stall on the shared DVFS clock, with LRU eviction
  (free: task weights are read-only) and swap telemetry (``task_swaps``,
  ``swap_stall_s``, ``resident_set``).  ``load_from_envm`` runs the actual
  fault-injected readback (``core.envm.store_and_readback``): a degraded
  readback raises the ``degraded_tasks`` telemetry flag instead of serving
  corrupted weights silently.
* ``TaskAffinityPolicy`` / ``ResidencyRouter`` — cross-server arbitration
  that trades EDF urgency against swap cost.  Each task is one
  ``ClassifierServer`` (the ``MultiTaskRouter`` layout), so affinity is a
  TASK-level decision: the router snapshots every server's candidate
  buckets, discounts a non-resident task's slack by its swap stall, and
  keeps serving resident tasks while deadlines permit — same-task requests
  batch through the warm working set, and residency is preempted only when
  a non-resident task's discounted slack demands it.  ``BlindEDFTaskPolicy``
  is the residency-oblivious baseline (global min slack, swap-thrashing)
  the CI benchmark gate beats.

This is a copy of the JAX package's ``serving/residency.py``.  The two
functions that read weight values, ``measured_footprint`` and
``TaskResidencyManager.load_from_envm``, copy tensors to the host first
(``_to_host``): their encoding runs in numpy, off the serving path.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitmask as bm
from repro_torch.core.adaptive_span import active_head_indices, span_flop_factor
from repro_torch.core.adaptivfloat import AFFormat
from repro_torch.core.envm import store_and_readback
from repro_torch.hwmodel.edgebert_accel import (
    WorkloadStats,
    accel_power_mw,
    task_swap_cost,
)
from repro_torch.serving.dvfs import LatencyAwareDVFSController
from repro_torch.serving.engine import ClassifierServer, MultiTaskRouter
from repro_torch.serving.scheduler import BucketView


# ===========================================================================
# Compression-aware task deployments
# ===========================================================================


@dataclass(frozen=True)
class TaskDeployment:
    """One task's deployed compression configuration (paper Table I row).

    ``pruning_occupancy`` is the fraction of weights the movement-pruned
    network KEEPS (occupancy 0.4 = 60% sparse); ``spans`` are the task's
    per-head hard attention spans (``core.adaptive_span.hard_spans``), from
    which the retained-FLOP factor and active-head fraction derive exactly
    as the standalone span benchmark computes them; ``fmt`` is the
    AdaptivFloat storage format of the eNVM-resident non-zero values.

    The deployment prices two different things from ONE config:
    * compute: ``deployment_stats`` folds span/sparsity into the hwmodel's
      ``WorkloadStats``, so cycles AND power reflect the compressed network;
    * storage: the bitmask-encoded footprint (``storage()``, mirroring
      ``bitmask.storage_bytes``) prices SRAM residency and the eNVM swap.
    """

    task: str
    n_params: float                          # dense encoder+head param count
    pruning_occupancy: float = 1.0           # fraction of weights kept
    spans: Optional[Tuple[int, ...]] = None  # per-head hard spans (None=dense)
    n_heads: int = 12
    span_seq_len: int = 128                  # seq len the spans were budgeted at
    fmt: AFFormat = field(default_factory=AFFormat)

    def __post_init__(self):
        assert 0.0 < self.pruning_occupancy <= 1.0
        assert self.n_params > 0
        assert self.spans is None or len(self.spans) == self.n_heads

    @property
    def weight_sparsity(self) -> float:
        return 1.0 - self.pruning_occupancy

    @property
    def span_factor(self) -> float:
        if self.spans is None:
            return 1.0
        return span_flop_factor(self.spans, self.n_heads, self.span_seq_len)

    @property
    def heads_active_frac(self) -> float:
        if self.spans is None:
            return 1.0
        idx, _ = active_head_indices(self.spans)
        return len(idx) / self.n_heads

    def storage(self) -> Dict[str, float]:
        """Sparse-encoded footprint: the analytic mirror of
        ``bitmask.storage_bytes`` (1 mask bit per dense param, ``fmt.n_bits``
        per surviving value) — what the SRAM working set and the eNVM swap
        actually move."""
        mask_bytes = math.ceil(self.n_params / 8.0)
        value_bytes = self.n_params * self.pruning_occupancy * self.fmt.n_bits / 8.0
        return {
            "mask_bytes": float(mask_bytes),
            "value_bytes": float(value_bytes),
            "total_bytes": float(mask_bytes) + float(value_bytes),
        }

    def swap_cost(self) -> Dict[str, float]:
        """Modeled eNVM->SRAM switch-in cost of this task's weight set."""
        s = self.storage()
        return task_swap_cost(s["value_bytes"], s["mask_bytes"])


def _to_host(arr: Any) -> np.ndarray:
    """A weight as a host numpy array: a tensor on any device is copied to
    the host (bfloat16 widened to float32, which keeps every value and every
    zero); anything else goes through ``np.asarray``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def measured_footprint(task_params: Any, fmt: AFFormat = AFFormat()) -> Dict[str, float]:
    """Bitmask-encode a task's ACTUAL weight arrays and sum the storage
    accounting — the measured counterpart of ``TaskDeployment.storage()``
    for deployments built from concrete (pruned) parameter trees."""
    totals = {"mask_bytes": 0.0, "value_bytes": 0.0, "total_bytes": 0.0}

    def _walk(node):
        if isinstance(node, dict):
            for v in node.values():
                _walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                _walk(v)
        else:
            s = bm.storage_bytes(bm.encode(_to_host(node)), value_bits=fmt.n_bits)
            totals["mask_bytes"] += s["mask_bytes"]
            totals["value_bytes"] += s["value_bytes"]
            totals["total_bytes"] += s["total_bytes"]

    _walk(task_params)
    return totals


def deployment_stats(base: WorkloadStats, dep: TaskDeployment) -> WorkloadStats:
    """The COMPRESSED network's workload statistics: the anchor stats with
    the deployment's span/sparsity factors and sparse footprint folded in.
    Everything downstream of ``WorkloadStats`` — ``layer_cycles``,
    ``layer_energy_j``, ``cycles_for_seq_len``, admission quotes — then
    prices the compressed network instead of dense full-precision work."""
    return replace(
        base,
        span_factor=dep.span_factor,
        heads_active_frac=dep.heads_active_frac,
        weight_sparsity=dep.weight_sparsity,
        model_bytes=dep.storage()["total_bytes"],
    )


def deployment_controller(
    ctrl: LatencyAwareDVFSController, dep: TaskDeployment
) -> LatencyAwareDVFSController:
    """A pricing controller over the deployment's compressed stats, sharing
    the anchor controller's target, table, and MAC width.  Used by the
    engine for per-bucket CYCLE pricing only (prediction LUTs stay on the
    shared anchor controller), so a compressed task's quotes, step times,
    and arbiter budgets all see the span/pruning savings."""
    return LatencyAwareDVFSController(
        deployment_stats(ctrl.stats, dep),
        ctrl.target_latency_s,
        table=ctrl.table,
        n=ctrl.n,
        use_span=ctrl._use_span,
    )


def deployment_energy_scale(
    ctrl: LatencyAwareDVFSController, dep: TaskDeployment
) -> float:
    """Per-layer POWER ratio of the compressed network vs the anchor stats.

    The arbiter scales lane energy by the lane's cycles ratio; sparsity
    additionally gates PU/SRAM power (``accel_power_mw``) without changing
    cycles, so the engine passes this ratio as ``admit(energy_scale=...)``
    — lane energy then equals the compressed task's actual layer energy."""
    p_dep = accel_power_mw(deployment_stats(ctrl.stats, dep), ctrl.n)["total"]
    p_base = accel_power_mw(ctrl.stats, ctrl.n)["total"]
    return p_dep / p_base


# ===========================================================================
# Bounded SRAM working set over the eNVM backing store
# ===========================================================================


class TaskResidencyManager:
    """Models which tasks' weight sets are SRAM-resident.

    All tasks live sparse-encoded in eNVM (the paper's multi-task ReRAM
    deployment); ``sram_bytes`` bounds the working set of switch-ready
    tasks.  ``acquire`` is the single serving-path entry point: a resident
    task is free (LRU-touched), a non-resident task evicts LRU victims
    until its footprint fits and pays its modeled eNVM read as a stall the
    ENGINE charges on the shared DVFS clock (the manager owns no clock —
    it returns the stall and accounts the energy).  Evictions are free:
    task weights are read-only, so there is no write-back.

    ``load_from_envm`` additionally runs the REAL fault-injected readback
    (``core.envm.store_and_readback``) over a task's arrays: any injected
    mask/code fault raises the ``degraded_tasks`` telemetry flag, so a
    risky cell configuration (MLC3) degrades detectably instead of serving
    corrupted weights silently, while the paper's SLC-mask/MLC2-data
    deployment round-trips clean.
    """

    def __init__(
        self,
        deployments: Any,
        sram_bytes: float,
    ):
        if not isinstance(deployments, dict):
            deployments = {d.task: d for d in deployments}
        self.deployments: Dict[str, TaskDeployment] = dict(deployments)
        self.sram_bytes = float(sram_bytes)
        for t, d in self.deployments.items():
            need = d.storage()["total_bytes"]
            assert need <= self.sram_bytes, (
                f"task {t!r} footprint {need:.0f}B exceeds the SRAM working "
                f"set {self.sram_bytes:.0f}B — it could never become resident"
            )
        self._resident: "OrderedDict[str, float]" = OrderedDict()
        self.degraded_tasks: set = set()
        # ---- swap telemetry ----
        self.task_swaps = 0
        self.swap_stall_s = 0.0
        self.swap_energy_j = 0.0
        self.swap_bytes = 0.0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    def footprint_bytes(self, task: str) -> float:
        return self.deployments[task].storage()["total_bytes"]

    def is_resident(self, task: Optional[str]) -> bool:
        return task in self._resident

    def swap_cost(self, task: str) -> Dict[str, float]:
        return self.deployments[task].swap_cost()

    def pending_swap_stall_s(self, task: Optional[str]) -> float:
        """The stall the NEXT request of ``task`` would pay before compute:
        zero when resident (or unmanaged), else its modeled eNVM read
        latency.  This is the term admission quotes add to the wait — a
        resident task quotes the identical request strictly cheaper."""
        if task is None or task not in self.deployments:
            return 0.0
        if task in self._resident:
            return 0.0
        return self.swap_cost(task)["latency_s"]

    @property
    def resident_set(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    @property
    def resident_bytes(self) -> float:
        return sum(self._resident.values())

    # ------------------------------------------------------------- serving
    def acquire(self, task: Optional[str]) -> float:
        """Serve-path touch: make ``task`` resident, returning the swap
        stall (modeled seconds) this acquisition cost — zero on a hit.
        The caller charges the stall on its clock; the manager accounts
        swap energy and working-set churn here."""
        if task is None or task not in self.deployments:
            return 0.0
        if task in self._resident:
            self._resident.move_to_end(task)
            self.hits += 1
            return 0.0
        self.misses += 1
        need = self.footprint_bytes(task)
        while self._resident and self.resident_bytes + need > self.sram_bytes:
            self._resident.popitem(last=False)      # LRU, write-back-free
            self.evictions += 1
        cost = self.swap_cost(task)
        self._resident[task] = need
        self.task_swaps += 1
        self.swap_stall_s += cost["latency_s"]
        self.swap_energy_j += cost["energy_j"]
        self.swap_bytes += cost["bytes"]
        return cost["latency_s"]

    def load_from_envm(
        self,
        task: str,
        weights: Dict[str, Any],
        *,
        data_cell: str = "MLC2",
        mask_cell: str = "SLC",
        seed: int = 0,
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
        """Fault-injected eNVM readback of a task's weight arrays.

        Each array round-trips ``core.envm.store_and_readback`` (bitmask +
        AdaptivFloat codes, faults injected per cell config).  Any injected
        mask-bit flip or code fault marks the task DEGRADED — the flag the
        serving telemetry surfaces instead of silently computing on
        corrupted weights.  Returns the (possibly faulted) readback arrays
        and summed fault statistics."""
        fmt = self.deployments[task].fmt if task in self.deployments else AFFormat()
        out: Dict[str, np.ndarray] = {}
        stats = {"n_mask_bit_flips": 0, "n_code_faults": 0}
        for i, (name, arr) in enumerate(sorted(weights.items())):
            decoded, st = store_and_readback(
                _to_host(arr), data_cell=data_cell, mask_cell=mask_cell,
                fmt=fmt, seed=seed + i,
            )
            out[name] = decoded
            stats["n_mask_bit_flips"] += st["n_mask_bit_flips"]
            stats["n_code_faults"] += st["n_code_faults"]
        if stats["n_mask_bit_flips"] or stats["n_code_faults"]:
            self.degraded_tasks.add(task)
        return out, stats

    # ----------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, Any]:
        return {
            "task_swaps": self.task_swaps,
            "swap_stall_s": self.swap_stall_s,
            "swap_energy_j": self.swap_energy_j,
            "swap_bytes": self.swap_bytes,
            "residency_hits": self.hits,
            "residency_misses": self.misses,
            "evictions": self.evictions,
            "resident_set": self.resident_set,
            "resident_bytes": self.resident_bytes,
            "sram_bytes": self.sram_bytes,
            "degraded_tasks": tuple(sorted(self.degraded_tasks)),
        }


# ===========================================================================
# Task-affinity-aware cross-server scheduling
# ===========================================================================


@dataclass
class TaskView:
    """One task server's scheduling snapshot for cross-server arbitration."""

    task: str
    resident: bool
    swap_stall_s: float             # stall the task's next refill would pay
    views: List[BucketView]         # the server's candidate buckets


def _task_slack_s(tv: TaskView) -> float:
    """A task's raw urgency: the least slack across its candidate buckets
    (explicit SLOs and implicit budgets alike — the same quantity EDF ranks
    buckets by, minimized over the task's buckets)."""
    return min(
        (min(v.explicit_slack_s, v.min_slack_s) for v in tv.views),
        default=float("inf"),
    )


class TaskSchedulingPolicy(Protocol):
    """Picks which TASK server the router steps next."""

    def choose_task(self, task_views: Sequence[TaskView], now_s: float) -> str:
        ...


class BlindEDFTaskPolicy:
    """Residency-oblivious EDF across tasks: always step the task holding
    the globally least slack.  Correct on deadlines, catastrophic on swaps
    — interleaving tasks whose working sets do not co-fit thrashes the
    eNVM (every alternation is a swap stall + swap energy).  The baseline
    the ``multitask_residency`` CI gate requires affinity to beat."""

    def choose_task(self, task_views: Sequence[TaskView], now_s: float) -> str:
        return min(task_views, key=lambda tv: (_task_slack_s(tv), tv.task)).task


class TaskAffinityPolicy:
    """EDF urgency traded against eNVM swap cost.

    A non-resident task's slack is discounted by its swap stall (the stall
    runs on the shared clock BEFORE any of its compute, so that is its real
    slack).  While any resident task has work, the most urgent RESIDENT
    task keeps the working set warm — same-task requests batch through it —
    UNLESS a non-resident task's discounted slack has dropped below
    ``preempt_slack_s``: then deadlines demand the swap now and residency
    is preempted.  With no resident work the least-discounted-slack task
    swaps in (ties by task name, so drains are deterministic).
    """

    def __init__(self, *, preempt_slack_s: float = 0.0):
        self.preempt_slack_s = float(preempt_slack_s)

    def _discounted(self, tv: TaskView) -> float:
        s = _task_slack_s(tv)
        return s if tv.resident else s - tv.swap_stall_s

    def choose_task(self, task_views: Sequence[TaskView], now_s: float) -> str:
        resident = [tv for tv in task_views if tv.resident]
        urgent = min(task_views, key=lambda tv: (self._discounted(tv), tv.task))
        if not resident:
            return urgent.task
        if not urgent.resident and self._discounted(urgent) < self.preempt_slack_s:
            return urgent.task          # slack demands the swap NOW
        return min(resident, key=lambda tv: (self._discounted(tv), tv.task)).task


class ResidencyRouter(MultiTaskRouter):
    """``MultiTaskRouter`` + bounded SRAM residency + task-affinity stepping.

    Each task server carries ``task=``/``residency=``/``deployment=`` (so
    its refills pay swap stalls on the shared clock, its admission quotes
    include the pending swap, and its cycle/energy pricing reflects its
    compressed deployment).  ``step()`` arbitrates ACROSS tasks: every
    non-idle server's candidate buckets are snapshotted (clocks synced to
    the shared arbiter), the task policy picks which task steps, and that
    server advances one fused step — the cross-server generalization of the
    scheduler's per-bucket policy step.  ``run_all`` drains everything
    under that arbitration instead of task-sequentially.  ``device`` goes
    to every task server, as in ``MultiTaskRouter``.
    """

    def __init__(
        self,
        model,
        shared_embed,
        task_params,
        *,
        residency: TaskResidencyManager,
        deployments: Optional[Dict[str, TaskDeployment]] = None,
        task_policy: Optional[TaskSchedulingPolicy] = None,
        dvfs=None,
        arbiter=None,
        buckets=None,
        policy_factory=None,
        preempt: bool = False,
        batch_lanes: int = 8,
        device="cuda",
    ):
        super().__init__(
            model, shared_embed, task_params, dvfs=dvfs, arbiter=arbiter,
            buckets=buckets, policy_factory=policy_factory, preempt=preempt,
            residency=residency, deployments=deployments,
            batch_lanes=batch_lanes, device=device,
        )
        self.residency = residency
        self.task_policy = (
            task_policy if task_policy is not None else TaskAffinityPolicy()
        )
        self.task_steps = 0
        self.task_switches = 0          # consecutive-step task changes
        self._last_task: Optional[str] = None

    def _task_views(self) -> List[TaskView]:
        out = []
        for name, srv in self.tasks.items():
            views = srv.sched.candidate_views()
            if not views:
                continue
            out.append(TaskView(
                task=name,
                resident=self.residency.is_resident(name),
                swap_stall_s=self.residency.pending_swap_stall_s(name),
                views=views,
            ))
        return out

    def step(self):
        """Step ONE task server one fused step, chosen by the task policy.
        Returns ``(task, StepReport)`` or ``None`` when everything is idle."""
        tvs = self._task_views()
        if not tvs:
            return None
        now = max(srv.sched.now_s for srv in self.tasks.values())
        choice = self.task_policy.choose_task(tvs, now)
        if self._last_task is not None and choice != self._last_task:
            self.task_switches += 1
        self._last_task = choice
        self.task_steps += 1
        return choice, self.tasks[choice].step()

    def run_all(self) -> Dict[str, Dict[str, float]]:
        served = set()
        while True:
            out = self.step()
            if out is None:
                break
            served.add(out[0])
        self.switches += len(served)
        return {name: self.tasks[name].telemetry() for name in sorted(served)}

    def telemetry(self) -> Dict[str, Any]:
        out = dict(self.residency.telemetry())
        out["task_steps"] = self.task_steps
        out["task_switches"] = self.task_switches
        out["energy_j"] = sum(
            srv.telemetry().get("energy_j", 0.0) for srv in self.tasks.values()
        ) + self.residency.swap_energy_j
        out["accepted_slo_misses"] = sum(
            srv.telemetry().get("accepted_slo_misses", 0)
            for srv in self.tasks.values()
        )
        return out
