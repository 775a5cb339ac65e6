"""``sharding/dtensor_forms.py`` on real values: the dry run's steps on
DTensors over four ``gloo`` ranks against the plain model on the same
numbers (``tests/torch_dtensor_workers.py`` runs the ranks and says how the
plain side groups its rows).

The cases cover every form: attention with rows and heads sharded
(deepseek-7b), query heads in groups that share gathered KV heads
(qwen3-moe on a 4-way model axis, 2 KV heads), a cache sharded on the
sequence and merged across key blocks (qwen3-moe decode on 1 x 4, whose KV
heads do not divide the model axis; zamba2 decode at batch 1, whose
sequence goes over the data axis), the sequence-parallel residual
(deepseek-7b under ``sequence_parallel``, and its decode step, whose one
token stays whole), the MoE region with experts
split over the model axis (qwen3-moe) and with the experts' hidden dim
split (qwen2-moe's 6 experts on 4 ranks, its shared expert), the WKV
(rwkv6), the LM loss over a vocabulary split on the model axis, per-shard
microbatches, cache writes by scatter, and the cross K/V projected per
layer from the encoder's frames or the image (whisper, the vlm).

Tolerances: 1e-5 of each value's largest magnitude (at least 1) for
losses, logits, caches and updated params, and 1e-5 of each gradient
leaf's own largest magnitude, or 4x the plain step's own change under a
1e-7 relative change of its params where that is larger: the per-shard
sums and all-reduces round in another order, and the smoke rwkv6's
gradients move by 7e-4 of their magnitude under that nudge.  Its time mix
alone is held at 1e-5.
"""
import json
import time

import pytest
import torch.multiprocessing as mp

import torch_dtensor_workers as W

RANKS = 4
SPAWN_TIMEOUT_S = 300
TOL = 1e-5
SENSITIVITY_FACTOR = 4

# forms each case must have run (beyond the microbatch split of every train case)
TARGETS = {
    "deepseek_7b/train/2x2": ("_attention_sharded", "_lm_loss_sharded", "_sp_constrain"),
    "deepseek_7b/train_sp/2x2": ("_attention_sharded", "_lm_loss_sharded", "_sp_constrain"),
    "deepseek_7b/prefill/2x2": ("_attention_sharded", "_write_rows"),
    "deepseek_7b/decode/2x2": ("_attention_sharded", "_write_rows"),
    "deepseek_7b/decode_sp/2x2": ("_attention_sharded", "_sp_constrain"),
    "qwen3_moe_235b/train/2x2": ("_apply_moe_dtensor", "_attention_sharded", "_lm_loss_sharded"),
    "qwen3_moe_235b/train/1x4": ("_apply_moe_dtensor", "_attention_sharded", "_split_heads"),
    "qwen3_moe_235b/decode/1x4": ("_apply_moe_dtensor", "_attention_key_blocks", "_write_rows_sharded"),
    "qwen2_moe_a2p7b/train/1x4": ("_apply_moe_dtensor", "_attention_sharded"),
    "rwkv6_7b/train/2x2": ("_wkv_sharded", "_lm_loss_sharded"),
    "rwkv6_7b/decode/2x2": ("_wkv_sharded",),
    "rwkv6_7b/tmix/2x2": ("_wkv_sharded",),
    "zamba2_1p2b/train/2x2": ("_attention_sharded", "_lm_loss_sharded"),
    "zamba2_1p2b/decode/2x2": ("_attention_sharded", "_write_rows"),
    "zamba2_1p2b/decode_b1/2x2": ("_attention_key_blocks", "_write_rows_sharded"),
    "whisper_medium/prefill/2x2": ("_per_layer_proj", "_attention_sharded", "_write_rows"),
    "llama3_2_vision_90b/prefill/2x2": ("_per_layer_proj", "_attention_sharded", "_write_rows"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """rank 0's record of every case (the other ranks ran the same)."""
    out = tmp_path_factory.mktemp("dtensor_forms")
    ctx = mp.start_processes(W.run_rank, args=(RANKS, str(out / "store"), str(out)), nprocs=RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {RANKS} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return json.loads((out / "results.json").read_text())


def test_every_case_has_targets():
    assert sorted(TARGETS) == sorted(W.CASES)


@pytest.mark.parametrize("case", list(W.CASES))
def test_sharded_step_matches_the_plain_model(results, case):
    r = results[case]
    assert "error" not in r, r.get("error")
    for group, errs in r["errors"].items():
        tol = TOL
        if group == "grads" and "sensitivity" in r:
            tol = max(TOL, SENSITIVITY_FACTOR * r["sensitivity"])
        bad = {leaf: err for leaf, err in errs.items() if not err <= tol}
        assert not bad, f"{group} beyond {tol:.1e}: {bad}"


@pytest.mark.parametrize("case", list(W.CASES))
def test_case_runs_the_forms_it_covers(results, case):
    calls = results[case]["calls"]
    missing = [f for f in TARGETS[case] if not calls[f]]
    if W.CASES[case][2] == "train":
        missing += [] if calls["_microbatch"] else ["_microbatch"]
    assert not missing, f"{case} never called {missing}: {calls}"
