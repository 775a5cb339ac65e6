"""The check catches a broken timed path: each fault the cells can have is
planted in the port's fused step, a whole run is driven at smoke size on
the CPU (no card is looked for), and ``correct`` comes out false.

The faults: a step that returns its state unchanged; half of the lanes
left out (their results taken from what the step did not compute, or from
another lane); an answer or a token altered where the step produces it;
for the classifier also an exit decided one layer late, the answer taken
from the layer before the exit, and one lane's state kept through its
second layer.  The cells run on one card: no exchange between cards exists
to leave out."""
import numpy as np
import pytest
import torch

from portbench import harness, spec


class Lanes:
    """Each lane's depth, the previous step's retire flags and logits, per
    bucket, as the server sees them: a lane retires where its flag says so
    or at the last layer, and its next sentence starts at depth 0."""

    def __init__(self):
        self.by_bucket = {}

    def of(self, S, lanes, width):
        if S not in self.by_bucket:
            self.by_bucket[S] = {"depth": np.zeros(lanes, int), "flag": np.zeros(lanes),
                                 "logits": np.zeros((lanes, width))}
        return self.by_bucket[S]


def classifier_fault(kind):
    from repro_torch.serving import step_math

    orig = step_math.sharded_classifier_head_step
    lanes = Lanes()

    def broken(model, params, h, active, lengths, threshold, *, block_masks=None):
        if kind == "half":
            active = np.asarray(active, bool).copy()
            active[len(active) // 2:] = False
        h_new, packed = orig(model, params, h, active, lengths, threshold, block_masks=block_masks)
        if kind == "state":
            return h, packed
        if kind == "answer":
            packed = packed.clone()
            packed[0, :-1] += 0.05            # lane 0's logits and entropy
        if kind in ("exit_late", "answer_before", "lane_state_l2"):
            act = np.asarray(active, bool)
            st = lanes.of(h[0].shape[1], len(act), packed.shape[1] - 2)      # one slab: one card
            st["depth"][act] += 1
            cur = packed.detach().cpu().numpy().astype(np.float64)
            out = cur.copy()
            if kind == "exit_late":           # each lane's retire flag one step late
                out[:, -1] = np.where(act, st["flag"], cur[:, -1])
                st["flag"] = np.where(act, cur[:, -1], st["flag"])
            if kind == "answer_before":       # the logits of the step before, where there was one
                prev = act & (st["depth"] > 1)
                out[prev, :-2] = st["logits"][prev]
                st["logits"][act] = cur[act, :-2]
            if kind == "lane_state_l2" and act[0] and st["depth"][0] == 2:
                h_new = [t.clone() for t in h_new]
                h_new[0][0] = h[0][0]         # lane 0 keeps its state through its second layer
            done = act & ((out[:, -1] != 0) | (st["depth"] >= model.cfg.n_layers))
            st["depth"][done] = 0
            st["flag"][done] = 0
            packed = torch.as_tensor(out, dtype=packed.dtype, device=packed.device)
        return h_new, packed

    return "sharded_classifier_head_step", broken


def decoder_fault(kind):
    from repro_torch.serving import step_math

    orig = step_math.sharded_decoder_decode_ee

    def broken(model, params, caches, tokens, pos, threshold, *, use_kernels=False):
        if kind == "state":
            scratch = [{k: v.clone() for k, v in c.items()} for c in caches]
            logits, _, xl, fe = orig(model, params, scratch, tokens, pos, threshold, use_kernels=use_kernels)
            return logits, caches, xl, fe
        logits, caches, xl, fe = orig(model, params, caches, tokens, pos, threshold, use_kernels=use_kernels)
        logits = logits.clone()
        if kind == "half":
            logits[logits.shape[0] // 2:] = logits[:1]
        if kind == "token":
            logits[:, :, 5] += 100.0          # every lane: a lane whose request finishes in the window shows it
        return logits, caches, xl, fe

    return "sharded_decoder_decode_ee", broken


CLASSIFIER_FAULTS = ("state", "half", "answer", "exit_late", "answer_before", "lane_state_l2")
CASES = [("albert-backlog-long", classifier_fault, k) for k in CLASSIFIER_FAULTS] + \
        [("deepseek7b-decode-ee", decoder_fault, k) for k in ("state", "half", "token")]


def test_sound_runs_are_correct(smoke_root):
    for cell in ("albert-backlog-long", "deepseek7b-decode-ee"):
        assert harness.run_cell(spec.load_cell(cell, smoke_root), 41, 1.0, False, "cpu")["correct"]


@pytest.mark.parametrize("cell,make,kind", CASES, ids=[f"{c}-{k}" for c, _, k in CASES])
def test_a_broken_step_is_not_correct(smoke_root, monkeypatch, cell, make, kind):
    from repro_torch.serving import step_math

    name, broken = make(kind)
    monkeypatch.setattr(step_math, name, broken)
    r = harness.run_cell(spec.load_cell(cell, smoke_root), 41, 1.0, False, "cpu")
    assert not r["correct"], r["checks"]
