"""The classifier serving engine on the lane scheduler, the port of
``ClassifierServer`` and its helpers in ``repro/serving/engine.py``.

* ``LaneScheduler`` (``serving/scheduler.py``) owns the lifecycle: submit ->
  length-bucketed queues -> refill free lanes -> fused step -> retire ->
  telemetry, one bucket per ``step()``, chosen by EDF on per-request
  deadlines with a weighted-round-robin fallback.  A request lands in the
  smallest bucket that fits and is padded up to it.
* ``ClassifierServer`` keeps a dense ``[lanes, S_bucket, D]`` hidden tensor
  per open bucket plus an active mask; one fused step runs encoder layer ->
  off-ramp logits -> entropy -> retire mask (``serving/step_math.py``), and
  retired lanes refill from the bucket queue between steps.
* DVFS, two modes, as in the JAX package: per-sentence Alg. 1 replay after
  retirement (``dvfs=``), or one shared-clock (V, f) decision per fused step
  from a ``BatchedDVFSArbiter`` (``arbiter=``).
* Multi-task residency (``task=``, ``residency=``, ``deployment=``): a lane
  refill of a task whose weights are not SRAM-resident pays the modeled
  eNVM swap stall on the shared clock, and a compressed ``TaskDeployment``
  reprices cycles and lane energy (``serving/residency.py``).
* ``MultiTaskRouter``: one shared (eNVM-resident) embedding table, moved to
  the device once, and per-task encoder/classifier weights, one
  ``ClassifierServer`` per task (paper §III-D).

* ``DecoderServer``: LM decode with per-lane KV cache positions (refilled
  lanes continue from their own prompt end), EOS retirement and refill, a
  prefill per lane load; with ``exit_threshold=`` per-token entropy early
  exit on the LM head after every layer (``Model.decode_step_ee``), a
  position-binned exit LUT, shared-clock DVFS priced per token at its exit
  depth, and with ``spec_window > 1`` (or a ``threshold_schedule``)
  self-speculative decode.  ``probe_exit_threshold`` picks a threshold from
  observed traffic.

One device, one replica.  The sharded mesh path is not ported yet.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, tree_to
from repro_torch.core.early_exit import (
    PositionBinnedExitCalibrator,
    predicted_remaining_layers,
    predicted_token_layers,
)
from repro_torch.kernels import dispatch
from repro_torch.models.model import Model
from repro_torch.serving import step_math
from repro_torch.serving.scheduler import LaneScheduler, SchedulingPolicy, StepReport

if TYPE_CHECKING:  # typing only: dvfs and residency are not runtime dependencies
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController
    from repro_torch.serving.residency import TaskDeployment, TaskResidencyManager


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    deadline_s: Optional[float] = None  # per-request SLO from SUBMISSION on the
                                        # modeled clock; None = controller target
    result: Optional[np.ndarray] = None
    exit_layer: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    # decoder early exit: 1-based off-ramp exit depth of each generated token
    # (full depth when per-token exit is disabled)
    token_exit_layers: List[int] = field(default_factory=list)
    submit_time: float = 0.0            # WALL clock; caller-set only
    finish_time: float = 0.0
    bucket: Optional[int] = None        # length bucket the scheduler assigned
    replica: Optional[int] = None       # replica the request is pinned to
    # ---- admission / preemption lifecycle ----
    checkpoint: Optional[Any] = None    # engine-opaque lane snapshot while
                                        # the request sits preempted in queue
    ckpt_depth: int = 0                 # depth the checkpoint resumes at
    preempted: int = 0                  # times this request was evicted
    shed: bool = False                  # dropped by load shedding (never ran)
    quoted_deadline_s: Optional[float] = None  # original SLO before a re-quote
    # ---- scheduler lifecycle stamps (queue-delay telemetry) ----
    arrival_step: Optional[int] = None
    first_compute_step: Optional[int] = None
    retire_step: Optional[int] = None
    arrival_s: float = 0.0                    # modeled clock at submit()
    admit_s: float = 0.0                      # modeled clock at lane admission
    retire_s: float = 0.0                     # modeled clock at retirement
    seq: int = 0                              # global submission order
    # per-layer off-ramp entropies observed while the sentence was in flight;
    # the DVFS controller replays this trace through Alg. 1
    entropy_trace: List[float] = field(default_factory=list)
    energy_j: Optional[float] = None    # modeled accelerator energy (DVFS)
    latency_s: Optional[float] = None   # modeled accelerator latency (DVFS)
    op_vdd: Optional[float] = None      # selected / slowest operating point
    op_freq_hz: Optional[float] = None


# unique per-server prefix for arbiter lane keys: several buckets (and, via a
# shared arbiter, several servers) can hold lanes in flight at once
_SERVER_IDS = itertools.count()

# admission/preemption lifecycle counters telemetry() forwards verbatim from
# the scheduler
_LIFECYCLE_KEYS = (
    "accepted", "rejected", "requoted", "shed",
    "preemptions", "restored_steps_saved", "accepted_slo_misses",
)


def _fold_miss(acc: Dict[str, Any], req: Request, latency_s: float, target_s: float) -> None:
    """The per-request deadline-miss rule: an explicit SLO is
    submission-anchored (modeled queue wait counts), a deadline-free request
    is judged against the admission-anchored controller target."""
    if req.deadline_s is not None:
        latency_s += req.admit_s - req.arrival_s        # queue wait
        limit = req.deadline_s
    else:
        limit = target_s
    if latency_s > limit * (1 + 1e-9):
        acc["deadline_misses"] += 1
        if req.deadline_s is not None:
            acc["accepted_slo_misses"] += 1


class ClassifierServer:
    """Continuation-batching early-exit classifier with static per-bucket
    shapes.

    ``dvfs``    — per-sentence Alg. 1 replay after retirement (single-stream).
    ``arbiter`` — shared-clock batched arbitration: one (V, f) per fused step.
    The two model different hardware assumptions; pass at most one.
    ``policy``  — scheduling policy for ``step()`` (default EDF + WRR).
    ``preempt`` — let the scheduler evict budget-free lanes for queued
    explicit-SLO requests via ``lane_checkpoint``/``lane_restore``; the
    checkpointed ``(h, kv_len)`` row goes back through ``lane_insert``.
    ``use_kernels`` — route the fused step's attention (when the config has
    no trained spans), layernorms, off-ramp entropy, activation quantization
    and pruned MLP tiles to the hand-written kernels (``kernels.dispatch``).
    The JAX package's ``use_pallas`` defaults to False because on its CPU
    the Pallas kernels run in interpret mode; here the default is True,
    because on the card the kernel route is the serving path.  False keeps
    the reference ops (the route the JAX package's ``use_pallas=False``
    takes).  On the CPU either route runs plain PyTorch.
    ``device`` — where params and lane state live: the card unless the
    caller asks for ``"cpu"``.
    ``task`` / ``residency`` / ``deployment`` — the task this server serves,
    the shared SRAM-over-eNVM working set (a refill of a non-resident task
    stalls the shared clock for its swap) and the task's compression
    deployment (cycles, quotes and lane energy priced on the compressed
    network).

    ``layer_calls`` telemetry counts *active* lane-layer executions.  The
    ``*_traces`` keys keep the JAX package's names for its one jit trace
    per bucket: here each counts the buckets whose step, embed or insert
    has run, one per bucket used however many requests it serves.
    """

    def __init__(
        self,
        model: Model,
        params: Any,
        batch_lanes: int = 8,
        dvfs: Optional["LatencyAwareDVFSController"] = None,
        arbiter: Optional["BatchedDVFSArbiter"] = None,
        buckets=None,
        policy: Optional[SchedulingPolicy] = None,
        preempt: bool = False,
        use_kernels: bool = True,
        device: DeviceLike = "cuda",
        task: Optional[str] = None,
        residency: Optional["TaskResidencyManager"] = None,
        deployment: Optional["TaskDeployment"] = None,
    ):
        if model.cfg.family != "albert":
            raise ValueError("the classifier server drives the albert family")
        if dvfs is not None and arbiter is not None:
            raise ValueError("pass either a per-sentence controller (dvfs=) or a shared-clock "
                             "arbiter (arbiter=), not both: they model different hardware")
        self.model = model
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.replicas = 1
        self.lanes = batch_lanes
        self.lanes_per_replica = batch_lanes
        self.cfg = model.cfg
        self.threshold = model.cfg.edgebert.early_exit.entropy_threshold
        self.dvfs = dvfs
        self.arbiter = arbiter
        # one clock domain per replica, as the admission and workload layers
        # read it: [arbiter] or []
        self.arbiters = [arbiter] if arbiter is not None else []
        self.use_kernels = use_kernels
        # static block-occupancy masks (and their CSR indices on the device)
        # for the shared encoder MLP, from the concrete post-pruning weights;
        # None entries keep a matmul dense
        self._block_masks = None
        if use_kernels and "mlp" in self.params.get("layer", {}):
            self._block_masks = dispatch.mlp_block_masks(self.params["layer"]["mlp"])
        self._sid = next(_SERVER_IDS)
        ctrl = self._ctrl
        # multi-task residency: a deployment reprices the hw model (cycles
        # and quotes through a controller over the compressed stats; lane
        # energy scaled by its power ratio at admit)
        self.task = task
        self.residency = residency
        self.deployment = deployment
        self._dep_ctrl = None
        self._energy_scale = 1.0
        if deployment is not None and ctrl is not None:
            from repro_torch.serving.residency import (      # lazy: engine <-> residency
                deployment_controller,
                deployment_energy_scale,
            )

            self._dep_ctrl = deployment_controller(ctrl, deployment)
            self._energy_scale = deployment_energy_scale(ctrl, deployment)
        self.sched = LaneScheduler(
            self.lanes, self, buckets=buckets, policy=policy,
            step_time_fn=self._step_time_s,
            # with a hw model every request carries at least the controller
            # target as an implicit deadline, so EDF slack decides which
            # bucket gets each time slice
            default_deadline_s=ctrl.target_latency_s if ctrl is not None else None,
            preempt=preempt,
        )
        # per-bucket engine state: {"h": [lanes, S, D], "len": [lanes],
        # "out": last step's host copies, "dt": last step's modeled time}
        self._bstate: Dict[int, Dict[str, Any]] = {}
        # buckets whose embed / step / insert has run (``*_traces`` telemetry)
        self._traces = {"embed": {}, "step": {}, "insert": {}}
        # arbiter counters attributable to THIS server's drains (the arbiter
        # itself is drain-global and may be shared across servers)
        self._arb_acc = {
            "op_switches": 0, "switch_time_s": 0.0,
            "switch_energy_j": 0.0, "total_energy_j": 0.0,
        }
        # incremental per-retiree accounting: telemetry() never rescans
        # ``done``, whose payloads poll() may drop
        self._acc = {
            "retired": 0, "exit_sum": 0.0, "energy_j": 0.0, "lat_max": 0.0,
            "deadline_misses": 0, "accepted_slo_misses": 0,
        }

    def _built(self, kind: str, S: int) -> None:
        """Count the bucket's step / embed / insert once, at first use."""
        self._traces[kind].setdefault(S, 1)

    # ---------------------------------------------------------- DVFS helpers
    @property
    def _ctrl(self) -> Optional["LatencyAwareDVFSController"]:
        return self.arbiter.c if self.arbiter is not None else self.dvfs

    def _cycles_for(self, bucket: int) -> Optional[float]:
        """Per-bucket layer cycles from the controller's hw stats rescaled to
        the bucket's sequence length; with a ``TaskDeployment`` its
        controller prices the compressed network instead."""
        ctrl = self._dep_ctrl if self._dep_ctrl is not None else self._ctrl
        return None if ctrl is None else ctrl.cycles_for_seq_len(bucket)

    def _step_time_s(self, bucket: int) -> float:
        """Nominal duration of one fused step (the bucket's layer time at the
        max operating point with a hw model, else 1.0 step units): the EDF
        slack estimate."""
        ctrl = self._ctrl
        if ctrl is None:
            return 1.0
        return self._cycles_for(bucket) / ctrl.max_op.freq_hz

    def step_dt_s(self, bucket: int) -> Optional[float]:
        """Modeled duration of the step just run (the arbiter's operating
        point period plus any switching stall), so the scheduler's clock
        tracks the clock deadlines are judged by."""
        if self.arbiter is None:
            return None
        st = self._bstate.get(bucket)
        return None if st is None else st.get("dt")

    def clock_s(self) -> Optional[float]:
        """The shared timeline: the arbiter's clock, which other servers on
        the same arbiter also advance."""
        return None if self.arbiter is None else self.arbiter.now_s

    def _arb_key(self, bucket: int, lane: int):
        return (self._sid, bucket, lane)

    def _explicit_budget_remaining(self, req: Request) -> Optional[float]:
        """What is left of an explicit, submission-anchored SLO after the
        request's time in queue (floored at a sliver: a late request races
        at max V/f and reports its miss)."""
        if req.deadline_s is None:
            return None
        spent_in_queue = self.sched.now_s - req.arrival_s
        return max(req.deadline_s - spent_in_queue, 1e-12)

    # ---------------------------------------------------------------- public
    def submit(self, req: Request):
        req.bucket = self.sched.submit(req)

    @property
    def done(self) -> Dict[int, Request]:
        return self.sched.done

    @property
    def pending(self) -> int:
        return self.sched.pending

    def step(self) -> Optional[StepReport]:
        """Advance one bucket by one fused step (see ``LaneScheduler.step``)."""
        return self.sched.step()

    def poll(self, *, pin: bool = False) -> List[Request]:
        """Requests retired since the last poll (completion order); their
        payloads leave ``done`` unless ``pin=True``."""
        return self.sched.poll(pin=pin)

    def run(self) -> Dict[str, float]:
        """Drain every bucket with continuation batching; returns telemetry."""
        self.sched.run()
        return self.telemetry()

    # ------------------------------------------------------- scheduler hooks
    def bucket_key(self, req: Request) -> int:
        return len(req.tokens)

    def bucket_begin(self, bucket: int) -> None:
        D = self.cfg.d_model
        self._bstate[bucket] = {
            "h": torch.zeros((self.lanes, bucket, D), dtype=self.params["embed"]["tok"].dtype,
                             device=self.device),
            "len": np.full(self.lanes, bucket, np.int32),
            "out": None,
        }

    def lane_load(self, bucket: int, lane: int, req: Request) -> None:
        st = self._bstate[bucket]
        toks = np.zeros(bucket, np.int64)
        toks[: len(req.tokens)] = req.tokens     # pad up to the bucket shape
        self._built("embed", bucket)
        self._built("insert", bucket)
        with torch.no_grad():
            h_new = step_math.classifier_embed(self.model, self.params,
                                               torch.from_numpy(toks[None]).to(self.device))
            step_math.lane_insert(st["h"], lane, h_new)
        st["len"][lane] = len(req.tokens)
        if self.residency is not None:
            # refilling a lane touches this task's weights: a miss swaps them
            # in from eNVM, and the stall burns time on the shared clock
            # before the lane's budget is computed
            stall = self.residency.acquire(self.task)
            if stall > 0.0 and self.arbiter is not None:
                self.arbiter.advance_to(self.arbiter.now_s + stall)
                self.sched.sync_clock()
        if self.arbiter is not None:
            self.arbiter.admit(
                self._arb_key(bucket, lane),
                deadline_s=self._explicit_budget_remaining(req),
                cycles_per_layer=self._cycles_for(bucket),
                energy_scale=self._energy_scale,
            )

    def lanes_step(self, bucket: int, active: np.ndarray):
        st = self._bstate[bucket]
        decision = None
        if self.arbiter is not None:
            # ONE (V, f) for this fused step over the active lanes; telemetry
            # deltas accrue here, so hand-stepped and run()-driven drains are
            # accounted alike, and the scheduler clock moves TO the arbiter's
            arb = self.arbiter
            before = arb.telemetry()
            keys = [self._arb_key(bucket, i) for i in range(self.lanes) if active[i]]
            floor = max((arb.required_hz(k) for k in keys), default=0.0)
            if keys:
                decision = arb.step(keys, floor_hz=floor)
            after = arb.telemetry()
            for k in self._arb_acc:
                self._arb_acc[k] += after[k] - before[k]
            st["dt"] = max(arb.now_s - self.sched.now_s, 0.0)
        self._built("step", bucket)
        args = (self.model, self.params, st["h"],
                torch.from_numpy(np.asarray(active, bool)).to(self.device),
                torch.from_numpy(st["len"]).to(self.device), float(self.threshold))
        with torch.no_grad():
            if self.use_kernels:
                # one device-to-host copy: the off-ramp head's packed rows
                h, packed = step_math.classifier_head_step(*args, block_masks=self._block_masks)
                lg, ent, retire = step_math.unpack_head(packed.cpu().numpy())
                retire = retire != 0
            else:
                h, lg, ent, retire = step_math.classifier_fused_step(*args, block_masks=self._block_masks)
                lg, ent, retire = lg.cpu().numpy(), ent.cpu().numpy(), retire.cpu().numpy()
        st["h"] = h
        st["out"] = (lg, ent, retire, decision)
        return st["out"]

    def lane_advance(self, bucket: int, lane: int, req: Request, out, depth: int) -> bool:
        _, ent, retire, _ = out
        req.entropy_trace.append(float(ent[lane]))
        if self.arbiter is not None and depth == 1:
            # first off-ramp evaluated: Alg. 1 line 2 prediction goes live
            self.arbiter.observe_entropy(self._arb_key(bucket, lane), float(ent[lane]))
        return bool(retire[lane]) or depth >= self.cfg.n_layers

    def lane_finish(self, bucket: int, lane: int, req: Request, depth: int) -> None:
        lg = self._bstate[bucket]["out"][0]
        req.result = lg[lane]
        req.exit_layer = depth
        req.finish_time = time.time()
        if self.arbiter is not None:
            rep = self.arbiter.retire(self._arb_key(bucket, lane), depth)
            req.energy_j = rep.energy_j
            req.latency_s = rep.latency_s
            req.op_vdd = rep.slowest_op.vdd
            req.op_freq_hz = rep.slowest_op.freq_hz
        elif self.dvfs is not None:
            # a per-request deadline overrides the controller target, minus
            # the time already spent in queue (the SLO is submission-
            # anchored, Alg. 1 budgets from compute start)
            target = None
            if req.deadline_s is not None:
                target = max(req.deadline_s - (req.admit_s - req.arrival_s), 1e-12)
            rep = self.dvfs.sentence_report(req.entropy_trace, exit_layer=depth,
                                            target_latency_s=target)
            req.energy_j = rep.energy_j
            req.latency_s = rep.latency_s
            req.op_vdd = rep.op.vdd
            req.op_freq_hz = rep.op.freq_hz
            # online calibration AFTER the report: a sentence's own exit must
            # not leak into its own prediction
            self.dvfs.observe_exit(req.entropy_trace[0], depth)
        self._account_retiree(req, depth)

    def _account_retiree(self, req: Request, depth: int) -> None:
        acc = self._acc
        acc["retired"] += 1
        acc["exit_sum"] += depth
        ctrl = self._ctrl
        if ctrl is None:
            return
        acc["energy_j"] += req.energy_j or 0.0
        acc["lat_max"] = max(acc["lat_max"], req.latency_s or 0.0)
        _fold_miss(acc, req, req.latency_s or 0.0, ctrl.target_latency_s)

    def bucket_end(self, bucket: int) -> None:
        del self._bstate[bucket]

    def lane_checkpoint(self, bucket: int, lane: int, req: Request):
        """Snapshot ``(h, kv_len)`` at the layer boundary (the scheduler
        keeps the depth) plus the arbiter's lane clock, so an evicted
        sentence resumes without re-running completed layers."""
        st = self._bstate[bucket]
        payload = {"h": st["h"][lane].clone(), "len": int(st["len"][lane])}
        if self.arbiter is not None:
            payload["clock"] = self.arbiter.checkpoint_lane(self._arb_key(bucket, lane))
        return payload

    def lane_restore(self, bucket: int, lane: int, req: Request, payload) -> None:
        """Reload a checkpointed sentence into a (possibly different) free
        lane through the bucket's insert: bit-exact."""
        st = self._bstate[bucket]
        step_math.lane_insert(st["h"], lane, payload["h"][None])
        st["len"][lane] = payload["len"]
        if self.arbiter is not None:
            self.arbiter.restore_lane(self._arb_key(bucket, lane), payload["clock"])

    def predict_remaining_steps(self, bucket: int, req: Request, depth: int) -> float:
        """EDF slack input: entropy-LUT predicted exit depth minus progress,
        from the same prediction the DVFS controller arbitrates with."""
        ctrl = self._ctrl
        return predicted_remaining_layers(
            req.entropy_trace, depth, self.cfg.n_layers,
            predict_fn=ctrl.predict if ctrl is not None else None,
        )

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, float]:
        st = self.sched.telemetry()
        acc = self._acc
        avg_exit = acc["exit_sum"] / acc["retired"] if acc["retired"] else 0.0
        out = {
            "sentences": st["sentences"],
            "layer_calls": st["lane_steps"],
            "dense_steps": st["dense_steps"],
            "avg_exit_layer": avg_exit,
            "runtime_savings": 1.0 - avg_exit / self.cfg.n_layers,
            "step_traces": sum(self._traces["step"].values()),
            "embed_traces": sum(self._traces["embed"].values()),
            "insert_traces": sum(self._traces["insert"].values()),
            "step_traces_per_bucket": dict(self._traces["step"]),
            "step_traces_per_bucket_replica": {
                f"{s}x{self.replicas}": n for s, n in sorted(self._traces["step"].items())
            },
            "replicas": self.replicas,
            "buckets_used": st["buckets_used"],
            "bucket_steps": st["bucket_steps"],
            "lane_occupancy": st["lane_occupancy"],
            "queue_delay_steps_p50": st["queue_delay_steps_p50"],
            "queue_delay_steps_p95": st["queue_delay_steps_p95"],
            "queue_delay_steps_p99": st["queue_delay_steps_p99"],
            "queue_delay_steps_max": st["queue_delay_steps_max"],
            **{k: st[k] for k in _LIFECYCLE_KEYS},
        }
        if self._ctrl is not None:
            out["energy_j"] = float(acc["energy_j"])
            out["modeled_latency_s"] = float(acc["lat_max"])
            out["deadline_misses"] = acc["deadline_misses"]
            out["accepted_slo_misses"] = acc["accepted_slo_misses"]
        if self.arbiter is not None:
            out["op_switches"] = self._arb_acc["op_switches"]
            out["switch_energy_j"] = self._arb_acc["switch_energy_j"]
            out["switch_time_s"] = self._arb_acc["switch_time_s"]
            out["arb_energy_j"] = self._arb_acc["total_energy_j"]
        return out


class DecoderServer:
    """Continuation-batching LM decode with PER-LANE cache positions and
    (optionally) PER-TOKEN entropy early exit under shared-clock DVFS.

    Every lane decodes at its own position, attending its own ``[0, pos]``
    cache window, so a refilled lane continues from its actual prompt end.
    Cache shapes bucket by prompt plus generation budget; the caches live in
    a bucket-keyed dict, since the scheduler time-slices across buckets.
    It drives the dense and MoE families; an MoE layer routes each lane on
    its own in the fused step and the lanes together in the prefill, as
    the JAX package's lane ``vmap`` and batched prefill do
    (``step_math.decoder_prefill``).

    ``exit_threshold`` — per-token early exit: the fused step runs
    ``Model.decode_step_ee`` over the lanes (after every layer the LM head
    is evaluated and a token whose entropy drops below the threshold
    freezes; the remaining layers still write its K/V rows), so a token
    that exits at layer k skips layers k+1..L on the modeled hardware while
    the step keeps its shapes.  Exit depths feed a
    ``PositionBinnedExitCalibrator`` (cold bins predict the full depth),
    and that one prediction drives the scheduler's EDF slack
    (``predict_remaining_steps``, in fractional full-depth steps), the
    arbiter's required frequency (``set_remaining_layers``) and the
    admission quote (``_cycles_for`` x predicted steps).
    ``arbiter`` — shared-clock DVFS: one (V, f) per fused step across the
    lanes the arbiter serves (classifier and decoder traffic arbitrate on
    one timeline when they share it); each token is charged at its realized
    exit depth and at this bucket's per-token layer cost.  Prefill is not
    charged, as in the paper's per-sentence accounting.
    ``spec_window`` / ``threshold_schedule`` — self-speculative decode: up
    to ``spec_window`` tokens per lane per fused step, each slot gated by
    its own threshold (``ExitThresholdSchedule``); accepted tokens are the
    ones the per-token path would produce.
    ``preempt`` — lanes checkpoint (cache row, position, pending token and
    the arbiter's lane clock) and restore into any free lane.
    ``use_kernels`` — the LM-head entropy goes to the softmax_entropy
    kernel's wide-row entry (the decoder's only kernel: its norms are RMS
    norms, its cache attention stays on the reference ops); the default is
    True, as in ``ClassifierServer``.  ``device`` — the card unless the
    caller asks for ``"cpu"``.  ``task`` / ``residency`` — multi-task
    residency, as in ``ClassifierServer``.

    The ``decode`` / ``prefill`` traces count the buckets whose decode step
    and prefill have run (one each per bucket used), under the JAX
    package's names for its one jit trace per bucket.
    """

    def __init__(
        self,
        model: Model,
        params: Any,
        batch_lanes: int = 4,
        max_seq: int = 256,
        eos_id: int = 2,
        buckets=None,
        policy: Optional[SchedulingPolicy] = None,
        preempt: bool = False,
        arbiter: Optional["BatchedDVFSArbiter"] = None,
        exit_threshold: Optional[float] = None,
        exit_calibrator: Optional[Any] = None,
        use_kernels: bool = True,
        replicas: int = 1,
        mesh=None,
        task: Optional[str] = None,
        residency: Optional["TaskResidencyManager"] = None,
        spec_window: int = 1,
        threshold_schedule: Optional[Any] = None,
        device: DeviceLike = "cuda",
    ):
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError("the decoder server drives the dense and MoE families")
        if replicas != 1 or mesh is not None:
            raise ValueError("one device, one replica: the sharded decoder server is not ported")
        if isinstance(arbiter, (list, tuple)):
            if len(arbiter) != 1:
                raise ValueError(f"need one arbiter per replica: got {len(arbiter)} for 1")
            arbiter = arbiter[0]
        self.model = model
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.task = task
        self.residency = residency
        self.replicas = 1
        self.lanes_per_replica = batch_lanes
        self.lanes = batch_lanes
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.n_layers = model.cfg.n_layers
        self.arbiters = [arbiter] if arbiter is not None else []
        self.arbiter = arbiter
        self.use_kernels = use_kernels
        self.spec_window = int(spec_window)
        if self.spec_window < 1:
            raise ValueError("spec_window must be >= 1")
        self.schedule = threshold_schedule
        if threshold_schedule is not None and exit_threshold is None:
            exit_threshold = threshold_schedule.base
        self.threshold = exit_threshold
        if self.spec_window > 1 and exit_threshold is None:
            raise ValueError("speculative decode drafts via the entropy off-ramp: spec_window > 1 "
                             "needs exit_threshold (or a threshold_schedule)")
        self._spec = exit_threshold is not None and (self.spec_window > 1 or threshold_schedule is not None)
        if exit_calibrator is None and threshold_schedule is not None and threshold_schedule.calibrator is not None:
            # the schedule's backing calibrator is the prediction chain
            exit_calibrator = threshold_schedule.calibrator
        if exit_threshold is not None and exit_calibrator is None:
            exit_calibrator = PositionBinnedExitCalibrator(self.n_layers, max_pos=max_seq)
        self.calib = exit_calibrator
        self._sid = next(_SERVER_IDS)
        ctrl = self._ctrl
        self.sched = LaneScheduler(
            self.lanes, self, buckets=buckets, policy=policy, preempt=preempt,
            step_time_fn=self._step_time_s,
            default_deadline_s=ctrl.target_latency_s if ctrl is not None else None,
        )
        self._bucketed = buckets is not None
        # per-bucket engine state: {"cache", "pos": [lanes], "cur": [lanes, 1],
        # "reqs": per-lane Request refs, "out", "keep", "dt"}
        self._bstate: Dict[int, Dict[str, Any]] = {}
        # buckets whose decode step / prefill has run; "decode_replica" keyed
        # by (bucket, replicas)
        self._traces = {"decode": {}, "prefill": {}, "decode_replica": {}}
        self._arb_acc = {
            "op_switches": 0, "switch_time_s": 0.0,
            "switch_energy_j": 0.0, "total_energy_j": 0.0,
        }
        # incremental per-retiree accounting (telemetry() never rescans
        # ``done``, whose payloads poll() may drop); one lane_step per lane
        # per fused step, adv_tokens the tokens actually appended
        self._acc = {
            "retired": 0, "tokens": 0, "token_layers": 0.0,
            "energy_j": 0.0, "lat_max": 0.0,
            "deadline_misses": 0, "accepted_slo_misses": 0,
            "lane_steps": 0, "adv_tokens": 0, "accepted_blocks": 0,
        }

    def _built(self, kind: str, bucket: int) -> None:
        """Count the bucket's decode step / prefill once, at first use."""
        self._traces[kind].setdefault(bucket, 1)
        if kind == "decode":
            self._traces["decode_replica"].setdefault((bucket, self.replicas), 1)

    # ---------------------------------------------------------- DVFS helpers
    @property
    def _ctrl(self) -> Optional["LatencyAwareDVFSController"]:
        return self.arbiter.c if self.arbiter is not None else None

    def _cycles_token_layer(self, bucket: int) -> Optional[float]:
        """Modeled cycles for ONE decode token through ONE layer at this
        bucket: the bucket's full-sequence layer cycles amortized per
        position."""
        ctrl = self._ctrl
        if ctrl is None:
            return None
        return ctrl.cycles_for_seq_len(bucket) / bucket

    def _cycles_for(self, bucket: int) -> Optional[float]:
        """Cycles of one FULL-DEPTH fused decode step (one token through all
        layers), the unit ``predict_remaining_steps`` counts in."""
        cyc = self._cycles_token_layer(bucket)
        return None if cyc is None else cyc * self.n_layers

    def _step_time_s(self, bucket: int) -> float:
        """Nominal duration of one full-depth fused decode step at the max
        operating point (1.0 step units without a hw model)."""
        ctrl = self._ctrl
        if ctrl is None:
            return 1.0
        return self._cycles_for(bucket) / ctrl.max_op.freq_hz

    def step_dt_s(self, bucket: int) -> Optional[float]:
        """Modeled duration of the step just run (arbiter op period at the
        realized exit depths plus any switching stall)."""
        if self.arbiter is None:
            return None
        st = self._bstate.get(bucket)
        return None if st is None else st.get("dt")

    def clock_s(self) -> Optional[float]:
        """The shared timeline: the arbiter's clock."""
        return None if self.arbiter is None else self.arbiter.now_s

    def _arb_key(self, bucket: int, lane: int):
        return (self._sid, bucket, lane)

    def lane_domain(self, lane: int) -> int:
        """Scheduler routing hook: the replica (clock domain) of a lane."""
        return lane // self.lanes_per_replica

    def _explicit_budget_remaining(self, req: Request) -> Optional[float]:
        """What is left of an explicit, submission-anchored SLO after the
        request's time in queue (floored at a sliver)."""
        if req.deadline_s is None:
            return None
        spent_in_queue = self.sched.now_s - req.arrival_s
        return max(req.deadline_s - spent_in_queue, 1e-12)

    def _predicted_layers_remaining(self, req: Request) -> float:
        """Predicted layers for ALL of this request's remaining tokens from
        the position-binned LUT (full depth per token when the calibrator is
        cold or per-token exit is off)."""
        start = len(req.generated)
        end = req.max_new_tokens
        if end <= start:                 # the retiring token is still due
            end = start + 1
        if self.calib is None:
            return float(end - start) * self.n_layers
        fast = getattr(self.calib, "predict_range", None)
        if fast is not None:             # vectorized: this runs per lane per step
            return fast(start, end)
        return predicted_token_layers(self.calib.predict, start, end, self.n_layers)

    def _lane_thresholds(self, bucket: int) -> np.ndarray:
        """Per-lane, per-slot threshold rows for one speculative step: slot
        j gates the token at generation index ``len(generated) + j``; the
        scalar threshold broadcasts, a schedule prices each position and the
        lane's last first-off-ramp entropy."""
        st = self._bstate[bucket]
        W = self.spec_window
        thr = np.full((self.lanes, W), self.threshold, np.float32)
        if self.schedule is not None:
            for i in range(self.lanes):
                req = st["reqs"][i]
                if req is None:
                    continue
                last_ent = req.entropy_trace[-1] if req.entropy_trace else None
                thr[i] = self.schedule.thresholds(len(req.generated), W, last_ent)
        return thr

    # ---------------------------------------------------------------- public
    def submit(self, req: Request):
        req.bucket = self.sched.submit(req)

    @property
    def done(self) -> Dict[int, Request]:
        return self.sched.done

    @property
    def pending(self) -> int:
        return self.sched.pending

    def step(self) -> Optional[StepReport]:
        return self.sched.step()

    def poll(self, *, pin: bool = False) -> List[Request]:
        return self.sched.poll(pin=pin)

    def run(self) -> Dict[str, float]:
        self.sched.run()
        return self.telemetry()

    # ------------------------------------------------------- scheduler hooks
    def bucket_key(self, req: Request) -> int:
        if not self._bucketed:
            return self.max_seq              # one cache of max_seq
        need = len(req.tokens) + req.max_new_tokens + 1
        if need > self.max_seq:
            raise ValueError(f"request needs {need} > max_seq {self.max_seq}")
        return need

    def bucket_begin(self, bucket: int) -> None:
        self._bstate[bucket] = {
            "cache": self.model.init_cache(self.lanes, bucket, device=self.device),
            "pos": np.zeros(self.lanes, np.int64),
            "cur": np.zeros((self.lanes, 1), np.int64),
            "reqs": [None] * self.lanes,
            "out": None,
        }

    def lane_load(self, bucket: int, lane: int, req: Request) -> None:
        st = self._bstate[bucket]
        toks = np.zeros(bucket, np.int64)
        toks[: len(req.tokens)] = req.tokens
        self._built("prefill", bucket)
        with torch.no_grad():
            step_math.decoder_prefill(self.model, self.params, st["cache"], toks, lane, len(req.tokens),
                                      use_kernels=self.use_kernels)
        st["pos"][lane] = len(req.tokens) - 1
        st["cur"][lane, 0] = req.tokens[-1]
        st["reqs"][lane] = req
        if self.residency is not None:
            # a miss swaps the task's weights in from eNVM: the stall burns
            # time on the shared clock before the lane's budget is computed
            stall = self.residency.acquire(self.task)
            if stall > 0.0 and self.arbiter is not None:
                self.arbiter.advance_to(self.arbiter.now_s + stall)
                self.sched.sync_clock()
        if self.arbiter is not None:
            key = self._arb_key(bucket, lane)
            self.arbiter.admit(key, deadline_s=self._explicit_budget_remaining(req),
                               cycles_per_layer=self._cycles_token_layer(bucket))
            self.arbiter.set_remaining_layers(key, self._predicted_layers_remaining(req))

    def lanes_step(self, bucket: int, active: np.ndarray):
        st = self._bstate[bucket]
        arb = self.arbiter
        if arb is not None:
            # every active lane's predicted remaining layers BEFORE the
            # shared-clock decision
            for i in range(self.lanes):
                if active[i] and st["reqs"][i] is not None:
                    arb.set_remaining_layers(self._arb_key(bucket, i),
                                             self._predicted_layers_remaining(st["reqs"][i]))
        self._built("decode", bucket)
        cur = torch.from_numpy(st["cur"]).to(self.device)
        pos = torch.from_numpy(st["pos"]).to(self.device)
        with torch.no_grad():
            if self._spec:
                # every lane drafts and verifies up to spec_window tokens; the
                # host cuts each lane's accepted prefix to what the request
                # and the cache have room for BEFORE the arbiter charges it
                thr = torch.from_numpy(self._lane_thresholds(bucket)).to(self.device)
                toks_d, logits, st["cache"], xl, fe, acc_m = step_math.decoder_decode_spec(
                    self.model, self.params, st["cache"], cur, pos, thr, self.spec_window,
                    eos_id=self.eos_id, use_kernels=self.use_kernels)
                spec_toks = toks_d.cpu().numpy()          # [lanes, W]
                exit_layers = xl.cpu().numpy()
                first_ent = fe.cpu().numpy()
                accepted = acc_m.cpu().numpy()
                keep = np.zeros(self.lanes, np.int32)
                for i in range(self.lanes):
                    req = st["reqs"][i]
                    if not active[i] or req is None:
                        continue
                    a = int(accepted[i].sum())            # >= 1: slot 0 is alive
                    room_req = req.max_new_tokens - len(req.generated)
                    room_cache = (bucket - 1) - int(st["pos"][i])
                    keep[i] = max(1, min(a, room_req, room_cache))
                st["keep"] = keep
            elif self.threshold is not None:
                logits, st["cache"], xl, fe = step_math.decoder_decode_ee(
                    self.model, self.params, st["cache"], cur, pos, self.threshold,
                    use_kernels=self.use_kernels)
                exit_layers = xl.cpu().numpy()
                first_ent = fe.cpu().numpy()
            else:
                logits, st["cache"] = step_math.decoder_decode(
                    self.model, self.params, st["cache"], cur, pos, use_kernels=self.use_kernels)
                exit_layers = np.full(self.lanes, self.n_layers, np.int32)
                first_ent = None
        if arb is not None:
            # one (V, f) across the stepped lanes, each token (or accepted
            # block) charged at its REALIZED exit depth; the deltas accrue
            # per server and the actual dt feeds the scheduler clock
            before = arb.telemetry()
            keys = [self._arb_key(bucket, i) for i in range(self.lanes) if active[i]]
            floor = max((arb.required_hz(k) for k in keys), default=0.0)
            if keys:
                if self._spec:
                    layers = {self._arb_key(bucket, i): int(exit_layers[i, : st["keep"][i]].sum())
                              for i in range(self.lanes) if active[i]}
                    tokens = {self._arb_key(bucket, i): int(st["keep"][i])
                              for i in range(self.lanes) if active[i]}
                else:
                    layers = {self._arb_key(bucket, i): int(exit_layers[i])
                              for i in range(self.lanes) if active[i]}
                    tokens = {self._arb_key(bucket, i): 1 for i in range(self.lanes) if active[i]}
                arb.step(keys, layers=layers, floor_hz=floor, tokens=tokens)
            after = arb.telemetry()
            for k in self._arb_acc:
                self._arb_acc[k] += after[k] - before[k]
            st["dt"] = max(arb.now_s - self.sched.now_s, 0.0)
        if self._spec:
            # tokens, depths and entropies on the host (needed to advance);
            # the block's logits stay on the device: only a retiring lane's
            # row is copied back
            st["out"] = (spec_toks, exit_layers, first_ent, logits)
        else:
            st["out"] = (
                logits[:, -1].argmax(dim=-1).cpu().numpy(),
                exit_layers,
                first_ent,
                # the EE path keeps the final-token logits on the device (a
                # retiring lane's row is copied in lane_finish); plain decode
                # keeps only the argmax
                logits[:, -1] if self.threshold is not None else None,
            )
        return st["out"]

    def lane_advance(self, bucket: int, lane: int, req: Request, out, depth: int) -> bool:
        st = self._bstate[bucket]
        toks, exit_layers, first_ent, _ = out
        acc = self._acc
        acc["lane_steps"] += 1
        if self._spec:
            # advance by the accepted prefix (cut in lanes_step: what the
            # arbiter was charged for); every accepted token's depth feeds
            # the calibrator at its OWN position (one observation per token)
            k = int(st["keep"][lane])
            acc["adv_tokens"] += k
            acc["accepted_blocks"] += 1
            for j in range(k):
                tok = int(toks[lane, j])
                req.generated.append(tok)
                xl = int(exit_layers[lane, j])
                req.token_exit_layers.append(xl)
                fe = float(first_ent[lane, j])
                req.entropy_trace.append(fe)
                if self.calib is not None:
                    self.calib.observe(len(req.generated) - 1, xl)
                if (self.schedule is not None and self.schedule.calibrator is not None
                        and self.schedule.calibrator is not self.calib):
                    self.schedule.observe(len(req.generated) - 1, fe, xl)
            st["pos"][lane] += k
            st["cur"][lane, 0] = int(toks[lane, k - 1])
            return (int(toks[lane, k - 1]) == self.eos_id
                    or len(req.generated) >= req.max_new_tokens
                    or int(st["pos"][lane]) >= bucket - 1)
        tok = int(toks[lane])
        acc["adv_tokens"] += 1
        req.generated.append(tok)
        xl = int(exit_layers[lane])
        req.token_exit_layers.append(xl)
        if first_ent is not None:
            req.entropy_trace.append(float(first_ent[lane]))
        if self.calib is not None:
            # observed AFTER the step: the token's own exit fed neither this
            # step's arbitration nor its own prediction
            self.calib.observe(len(req.generated) - 1, xl)
        st["pos"][lane] += 1                 # this lane's own position only
        st["cur"][lane, 0] = tok
        return (tok == self.eos_id
                or len(req.generated) >= req.max_new_tokens
                or int(st["pos"][lane]) >= bucket - 1)   # this lane's cache is full

    def lane_finish(self, bucket: int, lane: int, req: Request, depth: int) -> None:
        st = self._bstate[bucket]
        logits = st["out"][3]
        if logits is not None:               # EE path: one lane row to the host
            row = logits[lane, int(st["keep"][lane]) - 1] if self._spec else logits[lane]
            req.result = row.cpu().numpy()
        req.finish_time = time.time()
        st["reqs"][lane] = None
        acc = self._acc
        acc["retired"] += 1
        acc["tokens"] += len(req.token_exit_layers)
        acc["token_layers"] += float(sum(req.token_exit_layers))
        if self.arbiter is not None:
            # the lane's arbiter depth is the summed realized exit depth of
            # every token it generated (across preemption stints)
            rep = self.arbiter.retire(self._arb_key(bucket, lane), int(sum(req.token_exit_layers)))
            req.energy_j = rep.energy_j
            req.latency_s = rep.latency_s
            req.op_vdd = rep.slowest_op.vdd
            req.op_freq_hz = rep.slowest_op.freq_hz
            acc["energy_j"] += rep.energy_j
            acc["lat_max"] = max(acc["lat_max"], rep.latency_s)
            _fold_miss(acc, req, rep.latency_s, self.arbiter.c.target_latency_s)

    def bucket_end(self, bucket: int) -> None:
        del self._bstate[bucket]

    def lane_checkpoint(self, bucket: int, lane: int, req: Request):
        """Snapshot the lane's cache row, cache position and pending token,
        so a preempted decode resumes exactly where it stopped (its tokens
        and exit depths live on the request); with an arbiter, the lane
        clock is frozen alongside."""
        st = self._bstate[bucket]
        payload = {
            "cache": {k: v[:, lane].clone() for k, v in st["cache"].items()},
            "pos": int(st["pos"][lane]),
            "cur": int(st["cur"][lane, 0]),
        }
        st["reqs"][lane] = None
        if self.arbiter is not None:
            payload["clock"] = self.arbiter.checkpoint_lane(self._arb_key(bucket, lane))
        return payload

    def lane_restore(self, bucket: int, lane: int, req: Request, payload) -> None:
        """Write the checkpointed cache row back into a (possibly different)
        free lane of the bucket's cache, in place."""
        st = self._bstate[bucket]
        for k, row in payload["cache"].items():
            st["cache"][k][:, lane] = row
        st["pos"][lane] = payload["pos"]
        st["cur"][lane, 0] = payload["cur"]
        st["reqs"][lane] = req
        if self.arbiter is not None:
            self.arbiter.restore_lane(self._arb_key(bucket, lane), payload["clock"])

    def predict_remaining_steps(self, bucket: int, req: Request, depth: int) -> float:
        """EDF slack input in FRACTIONAL full-depth fused steps: the
        position-binned LUT's predicted layers for the remaining tokens over
        the full depth (the remaining-token count when per-token exit is
        off)."""
        if self.calib is None:
            return float(max(req.max_new_tokens - len(req.generated), 1))
        return max(self._predicted_layers_remaining(req) / self.n_layers,
                   1.0 / self.n_layers)              # the step that retires it

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, float]:
        st = self.sched.telemetry()
        acc = self._acc
        avg_exit = acc["token_layers"] / acc["tokens"] if acc["tokens"] else 0.0
        out = {
            "decode_steps": st["dense_steps"],
            "completed": st["sentences"],
            "sentences": st["sentences"],
            "tokens": acc["tokens"],
            "token_layer_calls": acc["token_layers"],
            "avg_token_exit_layer": avg_exit,
            "decode_runtime_savings": 1.0 - avg_exit / self.n_layers if acc["tokens"] else 0.0,
            # tokens appended per lane per fused step (exactly 1.0 for the
            # per-token paths)
            "spec_window": self.spec_window,
            "tokens_per_fused_step": acc["adv_tokens"] / acc["lane_steps"] if acc["lane_steps"] else 0.0,
            "avg_accepted_block": (acc["adv_tokens"] / acc["accepted_blocks"]
                                   if acc["accepted_blocks"] else 0.0),
            "decode_traces": sum(self._traces["decode"].values()),
            "prefill_traces": sum(self._traces["prefill"].values()),
            "decode_traces_per_bucket": dict(self._traces["decode"]),
            "step_traces": sum(self._traces["decode"].values()),
            "step_traces_per_bucket": dict(self._traces["decode"]),
            "step_traces_per_bucket_replica": {
                f"{b}x{r}": n for (b, r), n in sorted(self._traces["decode_replica"].items())
            },
            "replicas": self.replicas,
            "buckets_used": st["buckets_used"],
            "bucket_steps": st["bucket_steps"],
            "lane_occupancy": st["lane_occupancy"],
            "queue_delay_steps_p50": st["queue_delay_steps_p50"],
            "queue_delay_steps_p95": st["queue_delay_steps_p95"],
            "queue_delay_steps_p99": st["queue_delay_steps_p99"],
            "queue_delay_steps_max": st["queue_delay_steps_max"],
            **{k: st[k] for k in _LIFECYCLE_KEYS},
        }
        if self.arbiter is not None:
            out["energy_j"] = float(acc["energy_j"])
            out["modeled_latency_s"] = float(acc["lat_max"])
            out["deadline_misses"] = acc["deadline_misses"]
            out["accepted_slo_misses"] = acc["accepted_slo_misses"]
            out["op_switches"] = self._arb_acc["op_switches"]
            out["switch_energy_j"] = self._arb_acc["switch_energy_j"]
            out["switch_time_s"] = self._arb_acc["switch_time_s"]
            out["arb_energy_j"] = self._arb_acc["total_energy_j"]
        return out


def probe_exit_threshold(
    model: Model,
    params: Any,
    prompts,
    *,
    batch_lanes: int = 2,
    max_seq: int = 32,
    eos_id: int = -1,
    buckets=(16,),
    max_new_tokens: int = 5,
    quantile: float = 0.5,
    device: DeviceLike = "cuda",
) -> float:
    """Pick a decode off-ramp entropy threshold from observed traffic.

    Drains ``prompts`` through a throwaway ``DecoderServer`` whose threshold
    sits below any entropy (no token exits, but first-off-ramp telemetry is
    live) and cuts at the ``quantile`` of the observed readings, so the
    exit-enabled deployment spreads exits across layers: the decode
    analogue of the classifier's profiling-pass threshold."""
    probe = DecoderServer(
        model, params, batch_lanes=batch_lanes, max_seq=max_seq, eos_id=eos_id,
        buckets=buckets, exit_threshold=-1.0, device=device,
    )
    for i, p in enumerate(prompts):
        probe.submit(Request(uid=i, tokens=np.asarray(p, np.int32), max_new_tokens=max_new_tokens))
    probe.run()
    ents = [e for r in probe.done.values() for e in r.entropy_trace]
    if not ents:
        raise ValueError("probe produced no off-ramp readings")
    return float(np.quantile(ents, quantile))


class MultiTaskRouter:
    """One shared embedding table (the eNVM-resident, frozen, pruned
    weights) and per-task encoder/head weights; dispatches requests by task.

    Models the paper's measurement (Fig. 11): task switches swap SRAM-class
    weights only; the embedding is loaded once at power-on.  The table is
    moved to ``device`` once, before the task servers are built, so every
    task server's ``params["embed"]`` holds the same tensors.  A single
    ``arbiter`` may be shared by all task servers: the hardware has one
    LDO/ADPLL, and the shared modeled clock keeps advancing across task
    switches.
    """

    def __init__(
        self,
        model: Model,
        shared_embed: Any,
        task_params: Dict[str, Any],
        dvfs: Optional["LatencyAwareDVFSController"] = None,
        arbiter: Optional["BatchedDVFSArbiter"] = None,
        buckets=None,
        policy_factory: Optional[Any] = None,
        preempt: bool = False,
        residency: Optional["TaskResidencyManager"] = None,
        deployments: Optional[Dict[str, "TaskDeployment"]] = None,
        batch_lanes: int = 8,
        device: DeviceLike = "cuda",
    ):
        self.model = model
        self.device = resolve_device(device)
        self.shared_embed = tree_to(shared_embed, self.device)
        self.tasks: Dict[str, ClassifierServer] = {}
        self.switches = 0
        self.embed_reloads = 1          # power-on load only
        for name, tp in task_params.items():
            params = dict(tp, embed=self.shared_embed)
            # a factory, not a shared instance: policies carry per-scheduler
            # state (WRR credits) that must not leak between task servers
            self.tasks[name] = ClassifierServer(
                model, params, batch_lanes=batch_lanes,
                dvfs=dvfs, arbiter=arbiter, buckets=buckets,
                policy=policy_factory() if policy_factory is not None else None,
                preempt=preempt, device=self.device,
                task=name, residency=residency,
                deployment=(deployments or {}).get(name),
            )

    def submit(self, task: str, req: Request):
        self.tasks[task].submit(req)

    def run_all(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, server in self.tasks.items():
            # queued or mid-flight (a caller may have hand-stepped a server
            # and left lanes in flight): both need draining
            if not server.sched.idle:
                self.switches += 1
                out[name] = server.run()
        return out
