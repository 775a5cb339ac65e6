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

One device, one replica.  The sharded mesh path, the task/residency/
deployment options and the decoder server are not ported yet.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, tree_to
from repro_torch.core.early_exit import predicted_remaining_layers
from repro_torch.kernels import dispatch
from repro_torch.models.model import Model
from repro_torch.serving import step_math
from repro_torch.serving.scheduler import LaneScheduler, SchedulingPolicy, StepReport

if TYPE_CHECKING:  # typing only: dvfs is not a runtime dependency of the engine
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                  # [S] int32
    deadline_s: Optional[float] = None  # per-request SLO from SUBMISSION on the
                                        # modeled clock; None = controller target
    result: Optional[np.ndarray] = None
    exit_layer: Optional[int] = None
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
        self.cfg = model.cfg
        self.threshold = model.cfg.edgebert.early_exit.entropy_threshold
        self.dvfs = dvfs
        self.arbiter = arbiter
        self.use_kernels = use_kernels
        # static block-occupancy masks (and their CSR indices on the device)
        # for the shared encoder MLP, from the concrete post-pruning weights;
        # None entries keep a matmul dense
        self._block_masks = None
        if use_kernels and "mlp" in self.params.get("layer", {}):
            self._block_masks = dispatch.mlp_block_masks(self.params["layer"]["mlp"])
        self._sid = next(_SERVER_IDS)
        ctrl = self._ctrl
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
        the bucket's sequence length."""
        ctrl = self._ctrl
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
        if self.arbiter is not None:
            self.arbiter.admit(
                self._arb_key(bucket, lane),
                deadline_s=self._explicit_budget_remaining(req),
                cycles_per_layer=self._cycles_for(bucket),
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
