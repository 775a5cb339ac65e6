"""Each plain reference held against the port, ``repro_torch``, at smoke
size on the CPU: a whole run of each cell (the port's server driven by the
harness, then the check) reads what float32 rounding leaves."""
import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.families import albert
from portbench.reference import albert_ref


@pytest.mark.parametrize("cell", ["albert-serve-poisson", "albert-backlog-long", "deepseek7b-decode-ee"])
def test_cell_agrees_with_its_reference(smoke_root, cell):
    r = harness.run_cell(spec.load_cell(cell, smoke_root), 2 ** 31 + 77, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["readings"]["checked"] > 0
    if "tok_gap" in r["readings"]:
        assert r["readings"]["tok_gap"] <= 1e-5 and r["readings"]["ent_gap"] <= 1e-5
    else:
        # after layer 1 an AdaptivFloat flip (one grid step where the two
        # sides' float32 sums straddle a rounding boundary) reaches the next
        # layers: a few 1e-4 at this size
        assert r["readings"]["ent1_gap"] <= 1e-5 and r["readings"]["ent2_gap"] <= 1e-3


def test_classifier_reference_against_the_port_layer_by_layer(smoke_root):
    """Every layer's off-ramp entropy and logits of the port's served
    sentences (threshold below any entropy: full depth) against the
    reference's, sentences of two buckets."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ClassifierServer, Request

    cell = spec.load_cell("albert-backlog-long", smoke_root)
    cfg = cell.config
    params = albert.make_weights(cfg, 5, "cpu")
    pc = albert.port_config(cfg)
    srv = ClassifierServer(build_model(pc.with_edgebert(early_exit=pc.edgebert.early_exit.__class__(
        enabled=True, entropy_threshold=-1.0, num_classes=3))), params, batch_lanes=4,
        buckets=tuple(cfg["server"]["buckets"]), device="cpu")
    g = np.random.default_rng(3)
    toks = [g.integers(3, 512, n).astype(np.int32) for n in (5, 16, 17, 32, 9, 30)]
    for i, t in enumerate(toks):
        srv.submit(Request(uid=i, tokens=t))
    srv.run()
    lg, ent = albert.ref_traces(cfg, params, toks, "cpu")
    for i in range(len(toks)):
        req = srv.done[i]
        assert req.exit_layer == cfg["model"]["n_layers"]
        np.testing.assert_allclose(req.entropy_trace, ent[i], atol=2e-6)
        np.testing.assert_allclose(req.result, lg[i, -1], atol=2e-5)


def test_exit_rule():
    ent = torch.tensor([[0.9, 0.2, 0.9], [0.4, 0.9, 0.9], [0.9, 0.9, 0.9]])     # [L, B]
    assert albert_ref.exit_layers(ent, 0.45).tolist() == [2, 1, 3]
