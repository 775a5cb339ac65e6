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
  retired lanes refill from the bucket queue between steps.  The albert
  family's lanes all run the one shared layer; the encoder family's
  (ModernBERT: unshared layers, an off-ramp each) run each lane's own next
  layer, at the depth the scheduler keeps, one layer call per depth group.
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
  lanes continue from their own prompt end) or, for RWKV6, a per-lane
  recurrent state zeroed at refill, EOS retirement and refill, a prefill
  per lane load; with ``exit_threshold=`` per-token entropy early
  exit on the LM head after every layer (``Model.decode_step_ee``), a
  position-binned exit LUT, shared-clock DVFS priced per token at its exit
  depth, and with ``spec_window > 1`` (or a ``threshold_schedule``)
  self-speculative decode.  ``probe_exit_threshold`` picks a threshold from
  observed traffic.

* Replicas (``replicas=`` / ``devices=``, both servers): ``replicas x
  batch_lanes`` lanes in contiguous slabs, lane ``i`` on replica ``i //
  lanes_per_replica``, each replica's lane state (and the decoder's cache
  rows) on its device, one params copy per distinct device, and one DVFS
  clock domain (``BatchedDVFSArbiter``) per replica with barrier-aware
  pacing.  A device list plays the part of the JAX package's mesh
  (``_resolve_devices``); the fused step runs each slab on its device
  (``step_math.sharded_*``), and admission quotes each replica and pins an
  accepted contract to one (``serving/admission.py``).
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, tree_to
from repro_torch.core.early_exit import (
    PositionBinnedExitCalibrator,
    predicted_remaining_layers,
    predicted_token_layers,
)
from repro_torch.kernels import dispatch
from repro_torch.models.model import DECODER_FAMILIES, Model
from repro_torch.serving import step_math, trace
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


def _expand_arbiters(arbiter, replicas: int) -> list:
    """The ``arbiter=`` argument as one arbiter per replica.

    Each replica is its own LDO/ADPLL clock domain: a single arbiter is kept
    for replica 0 and siblings sharing its controller (cycle model, DVFS
    table, online calibrator) are built for the rest, so every replica makes
    its own (V, f) decisions while pricing work identically.  A sequence is
    taken as it is (one arbiter per replica)."""
    if arbiter is None:
        return []
    if isinstance(arbiter, (list, tuple)):
        if len(arbiter) != replicas:
            raise ValueError(f"need one arbiter per replica: got {len(arbiter)} for {replicas}")
        return list(arbiter)
    if replicas == 1:
        return [arbiter]
    from repro_torch.serving.dvfs import BatchedDVFSArbiter

    return [arbiter] + [BatchedDVFSArbiter(arbiter.c) for _ in range(replicas - 1)]


def _resolve_devices(replicas: int, devices: Optional[Sequence[DeviceLike]],
                     device: DeviceLike) -> Tuple[int, List[torch.device]]:
    """The (replicas, devices) constructor pair as (replicas, one device per
    replica), the port of the JAX package's ``_resolve_mesh``: a device list
    plays the mesh's part.  ``devices`` alone sets the replica count, and
    both must agree when given.  Without a list, one replica runs on
    ``device``; ``replicas > 1`` on ``"cuda"`` takes ``cuda:0 .. cuda:R-1``
    and raises if fewer cards exist (it never stacks replicas on one card
    unasked), and on ``"cpu"`` takes R CPU replicas.  A list may name one
    device more than once (replicas sharing a card, as the JAX package's
    forced host devices share one CPU)."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if devices is None:
        dev = resolve_device(device)
        if replicas == 1 or dev.type == "cpu":
            devices = [dev] * replicas
        else:
            n = torch.cuda.device_count()
            if n < replicas:
                raise RuntimeError(f"replicas={replicas} needs {replicas} CUDA devices and {n} "
                                   "are present; pass devices= to name each replica's device "
                                   "(one card may be named more than once)")
            devices = [f"cuda:{i}" for i in range(replicas)]
    devs = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{d} named, but {torch.cuda.device_count()} CUDA devices are present")
        devs.append(d)
    if not devs:
        raise ValueError("devices= names no device")
    if replicas == 1:
        replicas = len(devs)
    if len(devs) != replicas:
        raise ValueError(f"{len(devs)} devices named but replicas={replicas}")
    return replicas, devs


def _per_device(devices: Sequence[torch.device], make) -> list:
    """``make(device)`` once per distinct device, one entry per replica:
    replicas on one device share the result."""
    made: Dict[torch.device, Any] = {}
    for d in devices:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in devices]


# fused steps the encoder's layer log keeps (``ClassifierServer.layer_log``)
LAYER_LOG_STEPS = 4096

# unique per-server prefix for arbiter lane keys: several buckets (and, via a
# shared arbiter, several servers) can hold lanes in flight at once
_SERVER_IDS = itertools.count()

# admission/preemption lifecycle counters telemetry() forwards verbatim from
# the scheduler
_LIFECYCLE_KEYS = (
    "accepted", "rejected", "requoted", "shed",
    "preemptions", "restored_steps_saved", "accepted_slo_misses",
)


def _synced(srv, device: torch.device, n: int = 1) -> None:
    """Count ``n`` blocking copies between the host and ``device`` in the
    server's ``host_syncs`` telemetry (on a CUDA device: on the CPU nothing
    waits)."""
    if device.type == "cuda":
        srv._host_syncs += n


def _arbitrate(srv, bucket: int, active: np.ndarray, step_slab) -> list:
    """One (V, f) per clock domain for a server's fused step: each replica's
    arbiter steps its own active slab (``step_slab(arbiter, replica,
    keys, floor_hz)``), at no point below the fleet's tightest lane
    requirement (the fleet's step lasts as long as its slowest domain),
    then every clock moves to the fleet's max: the replicas leave the
    step together, and waiting burns time, not operating-point state.
    Telemetry deltas accrue here, so hand-stepped and run()-driven
    drains are accounted alike, and the scheduler clock moves TO the
    arbiters'.  With one replica this is the single shared-clock
    arbitration.  Returns the decisions."""
    with trace.span("dvfs.arbitrate"):
        before = [a.telemetry() for a in srv.arbiters]
        L = srv.lanes_per_replica
        slabs = [(arb, [srv._arb_key(bucket, i) for i in range(r * L, (r + 1) * L) if active[i]])
                 for r, arb in enumerate(srv.arbiters)]
        floor = max((arb.required_hz(k) for arb, keys in slabs for k in keys), default=0.0)
        decisions = [step_slab(arb, r, keys, floor) for r, (arb, keys) in enumerate(slabs) if keys]
        t = max(a.now_s for a in srv.arbiters)
        for a in srv.arbiters:
            a.advance_to(t)
        for b4, a in zip(before, srv.arbiters):
            after = a.telemetry()
            for k in srv._arb_acc:
                srv._arb_acc[k] += after[k] - b4[k]
        srv._bstate[bucket]["dt"] = max(t - srv.sched.now_s, 0.0)
    return decisions


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
    ``replicas`` / ``devices`` — ``batch_lanes`` lanes per replica, each
    replica's slab ``[batch_lanes, S_bucket, D]`` on its device, one params
    copy and one set of block masks (with their CSR index and packed tiles)
    per distinct device, one clock domain per replica (``_resolve_devices``,
    ``_expand_arbiters``); lane ``i`` belongs to replica ``lane_domain(i)``.
    ``task`` / ``residency`` / ``deployment`` — the task this server serves,
    the shared SRAM-over-eNVM working set (a refill of a non-resident task
    stalls the shared clock for its swap) and the task's compression
    deployment (cycles, quotes and lane energy priced on the compressed
    network).

    ``layer_calls`` telemetry counts *active* lane-layer executions,
    ``lane_layers_global`` / ``lane_layers_local`` the same by the layer's
    kind of attention (every albert layer global), ``depth_groups`` the
    layer calls (one a step for the albert family's shared layer; one per
    depth among the active lanes for the encoder family's).  The
    ``*_traces`` keys keep the JAX package's names for its one jit trace
    per bucket: here each counts the buckets whose step, embed or insert
    has run, one per bucket used however many requests it serves, and
    ``step_traces_per_bucket_replica`` one per (bucket, replicas).
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
        replicas: int = 1,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if model.cfg.family not in ("albert", "encoder"):
            raise ValueError("the classifier server drives the albert and encoder families")
        if dvfs is not None and arbiter is not None:
            raise ValueError("pass either a per-sentence controller (dvfs=) or a shared-clock "
                             "arbiter (arbiter=), not both: they model different hardware")
        self.model = model
        self.replicas, self.devices = _resolve_devices(replicas, devices, device)
        self.device = self.devices[0]
        # one params copy per distinct device, shared by its replicas
        self._rparams = _per_device(self.devices, lambda d: tree_to(params, d))
        self.params = self._rparams[0]
        self.lanes_per_replica = batch_lanes
        self.lanes = batch_lanes * self.replicas
        self.cfg = model.cfg
        self.threshold = model.cfg.edgebert.early_exit.entropy_threshold
        self.dvfs = dvfs
        # one clock domain per replica, as the admission and workload layers
        # read it
        self.arbiters = _expand_arbiters(arbiter, self.replicas)
        self.arbiter = self.arbiters[0] if self.arbiters else None
        self.use_kernels = use_kernels
        # static block-occupancy masks (and their CSR indices and packed
        # tiles) for the shared encoder MLP, from the concrete post-pruning
        # weights, per replica (one set per distinct device); None entries
        # keep a matmul dense
        self._block_masks = [None] * self.replicas
        self._encoder = model.cfg.family == "encoder"
        self._n_classes = self.params["offramps"]["cls_b"].shape[-1] if self._encoder else None
        if use_kernels and self._encoder:
            # the encoder's unshared layers: one set of masks per layer
            masks = {id(p): [dispatch.mlp_block_masks(model._layer(p, i)[0]["mlp"])
                             for i in range(model.cfg.n_layers)] for p in self._rparams}
            self._block_masks = [masks[id(p)] for p in self._rparams]
        elif use_kernels and "mlp" in self.params.get("layer", {}):
            masks = {id(p): dispatch.mlp_block_masks(p["layer"]["mlp"]) for p in self._rparams}
            self._block_masks = [masks[id(p)] for p in self._rparams]
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
        self._host_syncs = 0             # blocking host <-> card copies (``_synced``)
        # lane loads stage token rows on the host, and ``_flush_loads``
        # embeds them before the step: the (bucket, replica) staging buffers
        # live as long as the server (page-locked allocation costs ms)
        self._stage: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._lane_loads = 0
        self._load_flushes = 0
        # layer calls by depth group (one group a step where every lane runs
        # the one shared layer), and lane-layers by kind of attention
        self._depth_groups = 0
        self._lane_layers = {"global": 0, "local": 0}
        # the encoder's last steps: (host ns as the step's outputs came back,
        # the layer each lane ran, -1 where idle), for readers that price a
        # step's work
        self.layer_log: deque = deque(maxlen=LAYER_LOG_STEPS)

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
        the same arbiter also advance; with replicated clock domains the
        fleet's (the max: ``lanes_step``'s barrier keeps them together)."""
        return max(a.now_s for a in self.arbiters) if self.arbiters else None

    def _arb_key(self, bucket: int, lane: int):
        return (self._sid, bucket, lane)

    def lane_domain(self, lane: int) -> int:
        """Scheduler routing hook: the replica (clock domain) a lane belongs
        to; slab r is the lanes replica r computes."""
        return lane // self.lanes_per_replica

    def _arb_of(self, lane: int) -> "BatchedDVFSArbiter":
        return self.arbiters[self.lane_domain(lane)]

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
        D, L = self.cfg.d_model, self.lanes_per_replica
        dtype = self.params["embed"]["tok"].dtype
        self._bstate[bucket] = {
            # one [lanes_per_replica, S, D] slab per replica, on its device
            "h": [torch.zeros((L, bucket, D), dtype=dtype, device=d) for d in self.devices],
            "len": np.full(self.lanes, bucket, np.int32),
            "out": None,
            # token rows staged per replica since the last flush
            "staged": [0] * self.replicas,
        }

    def _staging(self, bucket: int, r: int) -> Dict[str, Any]:
        """Replica ``r``'s staging buffers for ``bucket``: ``[lanes_per_replica,
        bucket]`` token rows and ``[lanes_per_replica]`` lane indices, int64,
        page-locked on a card (plain tensors on the CPU), with the event of
        their last flush's copies."""
        buf = self._stage.get((bucket, r))
        if buf is None:
            on_card = self.devices[r].type == "cuda"
            rows = torch.zeros((self.lanes_per_replica, bucket), dtype=torch.int64, pin_memory=on_card)
            lanes = torch.zeros(self.lanes_per_replica, dtype=torch.int64, pin_memory=on_card)
            buf = self._stage[(bucket, r)] = {
                "rows": rows, "lanes": lanes, "rows_np": rows.numpy(), "lanes_np": lanes.numpy(),
                "event": torch.cuda.Event() if on_card else None, "pending": False,
            }
        return buf

    def lane_load(self, bucket: int, lane: int, req: Request) -> None:
        """Stage the lane's token row, padded up to the bucket shape, on the
        host; ``_flush_loads`` embeds every staged row before the bucket's
        next step (or a checkpoint)."""
        with trace.span("engine.lane_load", req.uid):
            st = self._bstate[bucket]
            r, i = divmod(lane, self.lanes_per_replica)
            buf = self._staging(bucket, r)
            if buf["pending"]:
                # the last flush's copies read these buffers: after a step its
                # readback has waited on the stream, so only a flush by a
                # checkpoint can leave them running, and the wait counts then
                if not buf["event"].query():
                    _synced(self, self.devices[r])
                    buf["event"].synchronize()
                buf["pending"] = False
            k, n = st["staged"][r], len(req.tokens)
            buf["rows_np"][k, :n] = req.tokens
            buf["rows_np"][k, n:] = 0
            buf["lanes_np"][k] = i
            st["staged"][r] = k + 1
            self._lane_loads += 1
            self._built("embed", bucket)
            self._built("insert", bucket)
            st["len"][lane] = n
            with trace.span("dvfs.admit", req.uid):
                if self.residency is not None:
                    # refilling a lane touches this task's weights: a miss swaps them
                    # in from eNVM, and the stall burns time on the shared clock
                    # before the lane's budget is computed
                    stall = self.residency.acquire(self.task)
                    if stall > 0.0 and self.arbiters:
                        arb = self._arb_of(lane)
                        arb.advance_to(arb.now_s + stall)
                        self.sched.sync_clock()
                if self.arbiters:
                    self._arb_of(lane).admit(
                        self._arb_key(bucket, lane),
                        deadline_s=self._explicit_budget_remaining(req),
                        cycles_per_layer=self._cycles_for(bucket),
                        energy_scale=self._energy_scale,
                    )

    def _flush_loads(self, bucket: int) -> None:
        """Embed the bucket's staged token rows into their lanes: per replica
        with k staged rows, one copy of the rows and one of the lane indices
        (non-blocking, from the pinned buffers), one embedding over [k, S] and
        one indexed insert.  Each row gets the bits it gets embedded alone."""
        st = self._bstate[bucket]
        if not any(st["staged"]):
            return
        with trace.span("engine.load_flush"), torch.no_grad():
            for r, k in enumerate(st["staged"]):
                if not k:
                    continue
                dev, buf = self.devices[r], self._stage[(bucket, r)]
                toks = buf["rows"][:k].to(dev, non_blocking=True)
                lanes = buf["lanes"][:k].to(dev, non_blocking=True)
                if buf["event"] is not None:
                    buf["event"].record(torch.cuda.current_stream(dev))
                    buf["pending"] = True
                h_new = step_math.classifier_embed(self.model, self._rparams[r], toks)
                step_math.lanes_insert(st["h"][r], lanes, h_new)
                st["staged"][r] = 0
            self._load_flushes += 1

    def lanes_step(self, bucket: int, active: np.ndarray):
        with trace.span("engine.lanes_step"):
            # the embedding's device work overlaps the arbiter's host Python
            self._flush_loads(bucket)
            st = self._bstate[bucket]
            decision = None
            if self.arbiters:
                decisions = _arbitrate(self, bucket, active,
                                       lambda arb, r, keys, floor: arb.step(keys, floor_hz=floor))
                decision = decisions[0] if len(decisions) == 1 else (tuple(decisions) or None)
            self._built("step", bucket)
            if self._encoder:
                lg, ent, retire = self._encoder_step(bucket, np.asarray(active, bool))
                st["out"] = (lg, ent, retire, decision)
                return st["out"]
            self._depth_groups += 1
            self._lane_layers["global"] += int(np.count_nonzero(active))
            args = (self.model, self._rparams, st["h"], np.asarray(active, bool), st["len"],
                    float(self.threshold))
            for d in set(self.devices):
                _synced(self, d, 2)                  # slab_inputs' copies of active and lengths
            with torch.no_grad():
                if self.use_kernels:
                    # one device-to-host copy: the off-ramp heads' packed rows
                    h, packed = step_math.sharded_classifier_head_step(*args, block_masks=self._block_masks)
                    _synced(self, self.device)
                    with trace.span("step.readback"):
                        packed = packed.cpu().numpy()
                    lg, ent, retire = step_math.unpack_head(packed)
                    retire = retire != 0
                else:
                    h, lg, ent, retire = step_math.sharded_classifier_fused_step(
                        *args, block_masks=self._block_masks)
                    _synced(self, self.device, 3)
                    with trace.span("step.readback"):
                        lg, ent, retire = lg.cpu().numpy(), ent.cpu().numpy(), retire.cpu().numpy()
            st["h"] = h
            st["out"] = (lg, ent, retire, decision)
        return st["out"]

    def _encoder_step(self, bucket: int, active: np.ndarray):
        """The encoder family's fused step: each active lane runs its own
        next layer, the one the scheduler's depth (``lane_depths``, read and
        never copied) says.  Per replica, the lanes are grouped by depth
        (``step_math.depth_groups``), one blocking copy takes the lanes'
        lengths and the grouped lane order to the card, and each group runs
        its layer and that layer's off-ramp (``step_math.encoder_group_step``,
        an ``engine.layer_group`` span each); then the packed off-ramp rows
        of every lane come back in one copy.  Returns (logits, entropy,
        retire) on the host, idle lanes' rows zero."""
        st, L = self._bstate[bucket], self.lanes_per_replica
        depth = self.sched.lane_depths(bucket)
        layers = np.full(self.lanes, -1, np.int16)
        parts = []
        with torch.no_grad():
            for r, dev in enumerate(self.devices):
                lo = r * L
                order, groups = step_math.depth_groups(depth[lo:lo + L], active[lo:lo + L])
                h = st["h"][r]
                packed = torch.zeros((L, self._n_classes + 2), dtype=torch.float32, device=dev)
                if groups:
                    x = torch.as_tensor(np.concatenate([st["len"][lo:lo + L], order]).astype(np.int64)).to(dev)
                    _synced(self, dev)
                    lens, lanes = x[:L], x[L:]
                    for layer, a, b in groups:
                        with trace.span("engine.layer_group", layer):
                            step_math.encoder_group_step(
                                self.model, self._rparams[r], h, lanes[a:b], lens, layer, float(self.threshold),
                                packed, use_kernels=self.use_kernels,
                                block_masks=self._block_masks[r][layer] if self._block_masks[r] else None)
                        self._depth_groups += 1
                        self._lane_layers["global" if self.model.is_global(layer) else "local"] += b - a
                        layers[lo + order[a:b]] = layer
                parts.append(packed)
            packed = step_math.gather(parts)
            _synced(self, self.device)
            with trace.span("step.readback"):
                packed = packed.cpu().numpy()
        self.layer_log.append((time.perf_counter_ns(), layers))
        lg, ent, retire = step_math.unpack_head(packed)
        return lg, ent, retire != 0

    def lane_advance(self, bucket: int, lane: int, req: Request, out, depth: int) -> bool:
        _, ent, retire, _ = out
        req.entropy_trace.append(float(ent[lane]))
        if self.arbiters and depth == 1:
            # first off-ramp evaluated: Alg. 1 line 2 prediction goes live
            with trace.span("dvfs.retire", req.uid):
                self._arb_of(lane).observe_entropy(self._arb_key(bucket, lane), float(ent[lane]))
        return bool(retire[lane]) or depth >= self.cfg.n_layers

    def lane_finish(self, bucket: int, lane: int, req: Request, depth: int) -> None:
        lg = self._bstate[bucket]["out"][0]
        req.result = lg[lane]
        req.exit_layer = depth
        req.finish_time = time.time()
        if self.arbiters:
            with trace.span("dvfs.retire", req.uid):
                rep = self._arb_of(lane).retire(self._arb_key(bucket, lane), depth)
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
        sentence resumes without re-running completed layers.  The clock
        payload is relative (remaining budget and elapsed run time), so it
        restores onto any replica's arbiter."""
        self._flush_loads(bucket)               # a lane still staged has its row
        st = self._bstate[bucket]
        r, i = divmod(lane, self.lanes_per_replica)
        payload = {"h": st["h"][r][i].clone(), "len": int(st["len"][lane])}
        if self.arbiters:
            payload["clock"] = self._arb_of(lane).checkpoint_lane(self._arb_key(bucket, lane))
        return payload

    def lane_restore(self, bucket: int, lane: int, req: Request, payload) -> None:
        """Reload a checkpointed sentence into a (possibly different) free
        lane, on any replica, through the bucket's insert: bit-exact (a copy
        between devices moves the bits unchanged)."""
        with trace.span("engine.lane_load", req.uid):
            st = self._bstate[bucket]
            r, i = divmod(lane, self.lanes_per_replica)
            step_math.lane_insert(st["h"][r], i, payload["h"].to(self.devices[r])[None])
            st["len"][lane] = payload["len"]
            if self.arbiters:
                with trace.span("dvfs.admit", req.uid):
                    self._arb_of(lane).restore_lane(self._arb_key(bucket, lane), payload["clock"])

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
            "host_syncs": self._host_syncs,
            "lane_loads": self._lane_loads,
            "load_flushes": self._load_flushes,
            "depth_groups": self._depth_groups,
            "lane_layers_global": self._lane_layers["global"],
            "lane_layers_local": self._lane_layers["local"],
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


# the families whose decode state is recurrent, zeroed at refill
RECURRENT_FAMILIES = ("ssm", "hybrid")
# the families served in plain decode only: no per-token exit in the JAX package
PLAIN_DECODE_FAMILIES = RECURRENT_FAMILIES + ("encdec", "vlm")


class DecoderServer:
    """Continuation-batching LM decode with PER-LANE cache positions and
    (optionally) PER-TOKEN entropy early exit under shared-clock DVFS.

    Every lane decodes at its own position, attending its own ``[0, pos]``
    cache window, so a refilled lane continues from its actual prompt end.
    Cache shapes bucket by prompt plus generation budget; the caches live in
    a bucket-keyed dict, since the scheduler time-slices across buckets.
    It drives the dense, MoE, ssm, hybrid, encdec and vlm families; an MoE layer
    routes each lane on its own in the fused step and the lanes together in
    the prefill, as the JAX package's lane ``vmap`` and batched prefill do
    (``step_math.decoder_prefill``).  The ssm family (RWKV6) carries a
    recurrent state per lane instead of KV rows (the bucket then bounds
    only the positions), and the hybrid family (zamba2) a conv and SSM
    state per block beside the shared attention block's KV rows: plain
    decode only for both, as in the JAX package, with or without an
    arbiter or residency.  The encdec and vlm families are served as the
    JAX server serves them, in plain decode: a request carries no encoder
    or image input, the bucket's cache comes from ``init_cache`` and the
    prefill runs ``decode_step`` alone, so their cross layers attend to the
    cache's zero cross or image K/V, which the server never writes.  Their
    KV rows are not recurrent state, so a refill does not zero them.

    A refilled lane's recurrent state is zeroed before its prefill, so a
    request's tokens do not depend on the request the lane served before.
    Here the port departs from the JAX server on purpose: that one starts
    the prefill from whatever state the lane holds (harmless for KV rows,
    which the new request overwrites, not for a recurrent state), so its
    RWKV6 and zamba2 output depends on the lane's history.  The two agree
    on every request that is the first in its lane, and the port agrees
    with the JAX model's own ``init_cache`` -> prefill -> ``decode_step``
    contract on every request.

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
    kernel's wide-row entry, and a LayerNorm decoder's pre-norms and final
    norms (minitron-8b's; the ssm family's final norm alone) to the
    layernorm kernel, as the JAX package routes ``use_pallas`` (RMS norms
    have no kernel, cache attention stays on the reference ops, so the
    hybrid and vlm families launch none; whisper's final LayerNorm of every
    ``decode_step`` takes it, the prefill's steps too); the default is True, as in
    ``ClassifierServer``.  ``device`` — the card
    unless the caller asks for ``"cpu"``.  ``task`` / ``residency`` —
    multi-task residency, as in ``ClassifierServer``.
    ``replicas`` / ``devices`` — ``batch_lanes`` lanes per replica, each
    replica's cache rows (axis 1 of every cache leaf) and params copy on
    its device, one clock domain per replica, as in ``ClassifierServer``;
    the prefill routes an MoE lane with the whole fleet's lanes, as the
    JAX package's sharded server's prefill does, and with activation
    quantization on takes one AF bias over them (an ssm or hybrid lane's
    prefill reads every replica's live rows: ``step_math.decoder_prefill``).
    EdgeBERT's activation quantization and spans are served as the JAX
    server serves them, on every family; the dense and MoE layers'
    quantization takes the quantize kernel with ``use_kernels``.

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
        devices: Optional[Sequence[DeviceLike]] = None,
        task: Optional[str] = None,
        residency: Optional["TaskResidencyManager"] = None,
        spec_window: int = 1,
        threshold_schedule: Optional[Any] = None,
        device: DeviceLike = "cuda",
    ):
        family = model.cfg.family
        if family not in DECODER_FAMILIES:
            raise ValueError("the decoder server drives the dense, MoE, ssm, hybrid, encdec and vlm families")
        if family in PLAIN_DECODE_FAMILIES and (exit_threshold is not None or threshold_schedule is not None
                                                or spec_window != 1):
            raise ValueError(f"the {family} family has no per-token exit: no exit_threshold, threshold_schedule "
                             "or spec_window > 1")
        self.model = model
        self.replicas, self.devices = _resolve_devices(replicas, devices, device)
        self.device = self.devices[0]
        # one params copy per distinct device, shared by its replicas
        self._rparams = _per_device(self.devices, lambda d: tree_to(params, d))
        self.params = self._rparams[0]
        self.task = task
        self.residency = residency
        self.lanes_per_replica = batch_lanes
        self.lanes = batch_lanes * self.replicas
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.n_layers = model.cfg.n_layers
        self.arbiters = _expand_arbiters(arbiter, self.replicas)
        self.arbiter = self.arbiters[0] if self.arbiters else None
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
        # blocking host <-> card copies (``_synced``); the model's own copies
        # of host scalars (a prefill token's position, the exit threshold)
        # are not counted
        self._host_syncs = 0

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
        """The shared timeline: the arbiter's clock (the fleet's max with
        replicated clock domains)."""
        return max(a.now_s for a in self.arbiters) if self.arbiters else None

    def _arb_key(self, bucket: int, lane: int):
        return (self._sid, bucket, lane)

    def lane_domain(self, lane: int) -> int:
        """Scheduler routing hook: the replica (clock domain) of a lane."""
        return lane // self.lanes_per_replica

    def _arb_of(self, lane: int) -> "BatchedDVFSArbiter":
        return self.arbiters[self.lane_domain(lane)]

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
            # one cache per replica, its slab's rows on its device
            "cache": [self.model.init_cache(self.lanes_per_replica, bucket, device=d) for d in self.devices],
            "pos": np.zeros(self.lanes, np.int64),
            "cur": np.zeros((self.lanes, 1), np.int64),
            "reqs": [None] * self.lanes,
            "out": None,
        }

    def lane_load(self, bucket: int, lane: int, req: Request) -> None:
        with trace.span("engine.lane_load", req.uid):
            st = self._bstate[bucket]
            r, i = divmod(lane, self.lanes_per_replica)
            cache = st["cache"][r]
            toks = np.zeros(bucket, np.int64)
            toks[: len(req.tokens)] = req.tokens
            self._built("prefill", bucket)
            with torch.no_grad():
                if self.model.cfg.family in RECURRENT_FAMILIES:
                    # a fresh recurrent state, on the replica's device: the
                    # request before it in this lane leaves its state behind
                    # (see the class docstring); the hybrid family's KV rows go
                    # too, which changes nothing (rows past the lane's position
                    # are masked)
                    for v in cache.values():
                        v[:, i].zero_()
                if len(req.tokens) > 1:
                    _synced(self, self.devices[r])   # the prompt row, from pageable memory
                step_math.decoder_prefill(self.model, self._rparams[r], cache, toks, i, len(req.tokens),
                                          use_kernels=self.use_kernels, group=(self.lanes, lane),
                                          fleet=st["cache"])
            st["pos"][lane] = len(req.tokens) - 1
            st["cur"][lane, 0] = req.tokens[-1]
            st["reqs"][lane] = req
            with trace.span("dvfs.admit", req.uid):
                if self.residency is not None:
                    # a miss swaps the task's weights in from eNVM: the stall burns
                    # time on the shared clock before the lane's budget is computed
                    stall = self.residency.acquire(self.task)
                    if stall > 0.0 and self.arbiters:
                        arb = self._arb_of(lane)
                        arb.advance_to(arb.now_s + stall)
                        self.sched.sync_clock()
                if self.arbiters:
                    key, arb = self._arb_key(bucket, lane), self._arb_of(lane)
                    arb.admit(key, deadline_s=self._explicit_budget_remaining(req),
                              cycles_per_layer=self._cycles_token_layer(bucket))
                    arb.set_remaining_layers(key, self._predicted_layers_remaining(req))

    def lanes_step(self, bucket: int, active: np.ndarray):
        with trace.span("engine.lanes_step"):
            return self._lanes_step(bucket, active)

    def _lanes_step(self, bucket: int, active: np.ndarray):
        st = self._bstate[bucket]
        if self.arbiters:
            # every active lane's predicted remaining layers BEFORE the
            # shared-clock decision
            with trace.span("dvfs.arbitrate"):
                for i in range(self.lanes):
                    if active[i] and st["reqs"][i] is not None:
                        self._arb_of(i).set_remaining_layers(self._arb_key(bucket, i),
                                                             self._predicted_layers_remaining(st["reqs"][i]))
        self._built("decode", bucket)
        args = (self.model, self._rparams, st["cache"], st["cur"], st["pos"])
        for d in set(self.devices):
            # slab_inputs' copies: tokens and positions (and the speculative
            # thresholds)
            _synced(self, d, 3 if self._spec else 2)
        with torch.no_grad():
            if self._spec:
                # every lane drafts and verifies up to spec_window tokens; the
                # host cuts each lane's accepted prefix to what the request
                # and the cache have room for BEFORE the arbiter charges it
                toks_d, logits, st["cache"], xl, fe, acc_m = step_math.sharded_decoder_decode_spec(
                    *args, self._lane_thresholds(bucket), self.spec_window,
                    eos_id=self.eos_id, use_kernels=self.use_kernels)
                _synced(self, self.device, 4)
                with trace.span("step.readback"):
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
                logits, st["cache"], xl, fe = step_math.sharded_decoder_decode_ee(
                    *args, self.threshold, use_kernels=self.use_kernels)
                _synced(self, self.device, 2)
                with trace.span("step.readback"):
                    exit_layers = xl.cpu().numpy()
                    first_ent = fe.cpu().numpy()
            else:
                logits, st["cache"] = step_math.sharded_decoder_decode(*args, use_kernels=self.use_kernels)
                exit_layers = np.full(self.lanes, self.n_layers, np.int32)
                first_ent = None
        if self.arbiters:
            # one (V, f) per clock domain across its stepped lanes, each
            # token (or accepted block) charged at its REALIZED exit depth
            # (the decision was made from the predictions above), the
            # clocks barrier-synced as in ClassifierServer.lanes_step
            L = self.lanes_per_replica

            def step_slab(arb, r, keys, floor):
                lanes = [i for i in range(r * L, (r + 1) * L) if active[i]]
                if self._spec:
                    layers = {self._arb_key(bucket, i): int(exit_layers[i, : st["keep"][i]].sum())
                              for i in lanes}
                    tokens = {self._arb_key(bucket, i): int(st["keep"][i]) for i in lanes}
                else:
                    layers = {self._arb_key(bucket, i): int(exit_layers[i]) for i in lanes}
                    tokens = {self._arb_key(bucket, i): 1 for i in lanes}
                return arb.step(keys, layers=layers, floor_hz=floor, tokens=tokens)

            _arbitrate(self, bucket, active, step_slab)
        if self._spec:
            # tokens, depths and entropies on the host (needed to advance);
            # the block's logits stay on the device: only a retiring lane's
            # row is copied back
            st["out"] = (spec_toks, exit_layers, first_ent, logits)
        else:
            _synced(self, self.device)
            with trace.span("step.readback"):
                tokens = logits[:, -1].argmax(dim=-1).cpu().numpy()
            st["out"] = (
                tokens,
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
            _synced(self, self.device)
            with trace.span("step.readback", req.uid):
                req.result = row.cpu().numpy()
        req.finish_time = time.time()
        st["reqs"][lane] = None
        acc = self._acc
        acc["retired"] += 1
        acc["tokens"] += len(req.token_exit_layers)
        acc["token_layers"] += float(sum(req.token_exit_layers))
        if self.arbiters:
            # the lane's arbiter depth is the summed realized exit depth of
            # every token it generated (across preemption stints)
            with trace.span("dvfs.retire", req.uid):
                rep = self._arb_of(lane).retire(self._arb_key(bucket, lane), int(sum(req.token_exit_layers)))
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
        """Snapshot the lane's cache row (KV rows or recurrent state), cache
        position and pending token, so a preempted decode resumes exactly
        where it stopped (its tokens and exit depths live on the request);
        with an arbiter, the lane clock is frozen alongside."""
        st = self._bstate[bucket]
        r, i = divmod(lane, self.lanes_per_replica)
        payload = {
            "cache": {k: v[:, i].clone() for k, v in st["cache"][r].items()},
            "pos": int(st["pos"][lane]),
            "cur": int(st["cur"][lane, 0]),
        }
        st["reqs"][lane] = None
        if self.arbiters:
            payload["clock"] = self._arb_of(lane).checkpoint_lane(self._arb_key(bucket, lane))
        return payload

    def lane_restore(self, bucket: int, lane: int, req: Request, payload) -> None:
        """Write the checkpointed cache row back into a (possibly different)
        free lane of the bucket's cache, on any replica, in place (a copy
        between devices moves the bits unchanged)."""
        with trace.span("engine.lane_load", req.uid):
            st = self._bstate[bucket]
            r, i = divmod(lane, self.lanes_per_replica)
            for k, row in payload["cache"].items():
                st["cache"][r][k][:, i] = row.to(self.devices[r])
            st["pos"][lane] = payload["pos"]
            st["cur"][lane, 0] = payload["cur"]
            st["reqs"][lane] = req
            if self.arbiters:
                with trace.span("dvfs.admit", req.uid):
                    self._arb_of(lane).restore_lane(self._arb_key(bucket, lane), payload["clock"])

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
            "host_syncs": self._host_syncs,
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
