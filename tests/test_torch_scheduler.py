"""The port's lane scheduler against the JAX package's.

Both are numpy and Python only; the port keeps a copy.  Here the same fake
engine hooks (no model: each request retires after a depth fixed by its uid,
with EDF slack predictions, checkpoint and restore, and a modeled step time
per bucket) drive both schedulers through the same submissions, some of them
mid-drain, and every ``StepReport``, every hook call and the telemetry must
come out equal.
"""
import numpy as np
import pytest

from repro.serving import scheduler as jsched
from repro.serving.engine import Request as JRequest
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.engine import Request as TRequest


class _FakeEngine:
    """Hooks with no device: request ``uid`` retires at depth
    ``1 + uid % 5``; every call is logged."""

    def __init__(self, dt=None):
        self.log = []
        self.dt = dt

    def bucket_key(self, req):
        return len(req.tokens)

    def bucket_begin(self, bucket):
        self.log.append(("begin", bucket))

    def lane_load(self, bucket, lane, req):
        self.log.append(("load", bucket, lane, req.uid))

    def lanes_step(self, bucket, active):
        self.log.append(("step", bucket, tuple(bool(a) for a in active)))
        return None

    def lane_advance(self, bucket, lane, req, out, depth):
        return depth >= 1 + req.uid % 5

    def lane_finish(self, bucket, lane, req, depth):
        req.exit_layer = depth
        self.log.append(("finish", bucket, lane, req.uid, depth))

    def bucket_end(self, bucket):
        self.log.append(("end", bucket))

    def predict_remaining_steps(self, bucket, req, depth):
        return max(5.0 - depth, 1.0)

    def lane_checkpoint(self, bucket, lane, req):
        self.log.append(("ckpt", bucket, lane, req.uid))
        return {"uid": req.uid}

    def lane_restore(self, bucket, lane, req, payload):
        assert payload["uid"] == req.uid
        self.log.append(("restore", bucket, lane, req.uid))

    def step_dt_s(self, bucket):
        return None if self.dt is None else self.dt * bucket


_POLICIES = {
    "edf": lambda m: m.EDFPolicy(),
    "wrr": lambda m: m.WeightedRoundRobinPolicy(),
    "fifo": lambda m: m.FIFOPolicy(),
}


def _drive(mod, Request, policy, preempt, dt):
    eng = _FakeEngine(dt)
    sched = mod.LaneScheduler(
        3, eng, buckets=(8, 16, 32), policy=_POLICIES[policy](mod),
        step_time_fn=(lambda b: 1.0) if dt is None else (lambda b: dt * b),
        default_deadline_s=None if dt is None else 40 * dt * 32, preempt=preempt,
    )
    rng = np.random.default_rng(0)
    lengths = rng.integers(2, 33, 24)

    def req(uid, deadline=None):
        return Request(uid=uid, tokens=np.zeros(int(lengths[uid % 24]), np.int32), deadline_s=deadline)

    for uid in range(12):
        sched.submit(req(uid, None if uid % 4 else float(6 + uid)))
    reports, polled = [], []
    uid = 12
    while True:
        rep = sched.step()
        if rep is None:
            break
        reports.append((rep.bucket, rep.n_active, [r.uid for r in rep.retired]))
        if len(reports) % 3 == 0 and uid < 24:         # mid-drain arrivals
            sched.submit(req(uid, float(3 + uid % 7) * (1.0 if dt is None else dt * 32)))
            uid += 1
        if len(reports) % 5 == 0:
            polled.append(sorted(r.uid for r in sched.poll()))
    tele = sched.telemetry()
    return reports, polled, eng.log, tele, uid, sched.now_s


@pytest.mark.parametrize("policy", ["edf", "wrr", "fifo"])
@pytest.mark.parametrize("preempt", [False, True])
@pytest.mark.parametrize("dt", [None, 1e-4])
def test_same_step_reports_as_jax(policy, preempt, dt):
    j = _drive(jsched, JRequest, policy, preempt, dt)
    t = _drive(tsched, TRequest, policy, preempt, dt)
    assert t[0] == j[0]                 # StepReports, in order
    assert t[1] == j[1]                 # poll() batches
    assert t[2] == j[2]                 # every hook call
    assert t[3].keys() == j[3].keys()
    for k in t[3]:
        assert t[3][k] == pytest.approx(j[3][k], rel=1e-12), k
    assert t[5] == pytest.approx(j[3]["modeled_now_s"], rel=1e-12) and j[5] == j[3]["modeled_now_s"]
    assert t[4] == j[4] > 12 and sum(len(r[2]) for r in j[0]) == j[4]   # every request retired
    if preempt and policy == "fifo":   # FIFO leaves explicit SLOs queued behind busy lanes
        assert t[3]["preemptions"] >= 1 and any(e[0] == "restore" for e in t[2])


def test_shed_oldest_and_bucket_for_match():
    js, ts = (m.LaneScheduler(2, _FakeEngine(), buckets=(8, 16)) for m in (jsched, tsched))
    for s, R in ((js, JRequest), (ts, TRequest)):
        for uid in range(6):
            s.submit(R(uid=uid, tokens=np.zeros(3 + 2 * uid, np.int32)))
    assert [r.uid for r in ts.shed_oldest(8, 2)] == [r.uid for r in js.shed_oldest(8, 2)]
    assert ts.pending == js.pending
    for key in (1, 8, 9, 16):
        assert ts.bucket_for(key) == js.bucket_for(key)
    with pytest.raises(ValueError, match="largest bucket"):
        ts.bucket_for(17)
