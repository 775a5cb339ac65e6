"""The benchmark's own arithmetic on the CPU: traffic from the seed, order
statistics over every sample, the counts behind its shares, the exit
threshold, the AdaptivFloat grid of the reference and the trace's
reduction."""
import json
import math
import statistics

import numpy as np
import pytest
import torch

from portbench import peaks, stats, tracing, work
from portbench.families import albert
from portbench.gen import make
from portbench.gen.draws import Stratified, inverse_cdf, rng
from portbench.reference import af
from conftest import ROOT


def traffic(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["albert-serve-poisson", "albert-backlog-long", "deepseek7b-decode-ee"])
def test_same_seed_same_trace(name):
    def trace(seed):
        t = make(traffic(name), seed, 30000)
        out = []
        for _ in range(300):
            spec = t.next_request()
            out.append((spec["tokens"].tolist(), spec.get("max_new_tokens"),
                        t.next_gap_s() if t.open_loop else None))
        return out

    big = 2 ** 31 + 12345
    assert trace(big) == trace(big)
    assert trace(big) != trace(big + 1)


def test_a_block_holds_the_same_sizes_for_every_seed():
    dist = {"dist": "lognormal", "median": 40, "sigma": 0.6, "min": 8, "max": 128}
    sa, sb = Stratified(dist, 64, rng(1, 1)), Stratified(dist, 64, rng(2 ** 33, 1))
    a, b = [sa() for _ in range(64)], [sb() for _ in range(64)]
    assert a != b
    a, b = sorted(a), sorted(b)
    assert a == b
    assert 8 <= a[0] and a[-1] <= 128
    assert np.median(a) == pytest.approx(40, abs=2)


def test_uniform_and_exponential_strata():
    u = inverse_cdf({"dist": "uniform", "min": 96, "max": 128}, (np.arange(33) + 0.5) / 33)
    assert sorted(u.tolist()) == list(range(96, 129))
    e = inverse_cdf({"dist": "exponential", "mean": 0.002}, (np.arange(4096) + 0.5) / 4096)
    assert e.mean() == pytest.approx(0.002, rel=2e-3)


def test_poisson_rate_is_the_files():
    t = make(traffic("albert-serve-poisson"), 7, 30000)
    gaps = [t.next_gap_s() for _ in range(256 * 8)]
    assert 1.0 / np.mean(gaps) == pytest.approx(t.rate_per_s, rel=2e-3)


def test_percentile_is_over_all_samples():
    values = list(range(1, 100)) + [10_000]
    assert stats.percentile(values, 95) == pytest.approx(np.percentile(values, 95))
    # the one far value moves the 99th percentile: nothing is dropped first
    assert stats.percentile(values, 99) == pytest.approx(np.percentile(values, 99))
    assert stats.percentile(values, 99) > 100
    assert stats.percentile([], 95) is None


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 30.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


M_ALBERT = {"d_model": 768, "d_ff": 3072, "n_heads": 12, "head_dim": 64, "num_classes": 3, "embed_dim": 128}
M_DENSE = {"n_layers": 30, "d_model": 4096, "d_ff": 11008, "n_heads": 32, "n_kv_heads": 32, "head_dim": 128,
           "vocab_size": 102400}


def test_block_sparse_counts_by_hand():
    w = work.albert_step_kernel_work(M_ALBERT, 128, [128] * 64, 0.5)
    flops, nbytes = w["block_sparse_matmul"]
    M = 64 * 128
    assert flops == 2 * (2 * M * 768 * 3072 * 0.5)
    assert nbytes == 2 * (4 * M * (768 + 3072) + 4 * 0.5 * 768 * 3072)


def test_a_share_of_the_roofline_is_at_most_one_on_a_hand_case():
    """A block-sparse call at M = 8192 needs 9.66e9 operations and 1.3055e8
    bytes: 38.97 us at 3.35 TB/s, which bounds it (9.8 us at 989 TFLOP/s).
    A call that takes 38.97 us is at 100%; one that took twice that, at 50%."""
    flops, nbytes = (v / 2 for v in work.albert_step_kernel_work(M_ALBERT, 128, [128] * 64, 0.5)["block_sparse_matmul"])
    least = peaks.roofline_s(flops, nbytes)
    assert least == pytest.approx(nbytes / 3.35e12)
    assert least == pytest.approx(38.97e-6, rel=1e-3)
    assert least / (2 * least) == 0.5
    for v in work.albert_step_kernel_work(M_ALBERT, 32, [8, 32, 17], 0.5).values():
        assert peaks.roofline_s(*v) > 0


def test_decode_step_bytes_by_hand():
    """A fused deepseek-7b step over one lane at position 9 whose token
    exits at layer 30: 6.476e9 layer weights and 30 LM heads of 4.194e8,
    with the RMSNorms, the lane's 10 K/V rows per layer and its embedding
    row, all float32."""
    layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    want = 4 * (30 * (layer + 2 * 4096) + 30 * (4096 * 102400 + 4096) + 30 * 2 * 10 * 4096 + 4096)
    assert work.dense_step_bytes(M_DENSE, [9], 30) == want
    # the bytes bound the step: at most 100% of the roofline at the step's own time
    least = peaks.roofline_s(work.dense_token_flops(M_DENSE, 10, 30), want)
    assert least == pytest.approx(want / 3.35e12)
    assert least / 0.0823 <= 1.0


def test_model_flops_by_hand():
    m = dict(M_ALBERT)
    one = work.albert_sentence_flops(m, 10, 1, 1.0)
    assert one == (2 * 10 * 128 * 768 + 2 * 10 * 4 * 768 ** 2 + 4 * 100 * 768 + 4 * 10 * 768 * 3072
                   + 2 * 768 ** 2 + 2 * 768 * 3)
    assert work.dense_token_flops(M_DENSE, 1, 0) == 30 * (2 * (4 * 4096 ** 2 + 3 * 4096 * 11008) + 4 * 4096)


def test_threshold_gives_the_mean_exit_layer():
    g = np.random.default_rng(0)
    ent = np.sort(g.uniform(0.5, 1.1, (400, 12)), axis=1)[:, ::-1]
    for target in (4.0, 8.0, 10.5):
        thr = albert.threshold_for(ent, target)
        assert albert.mean_exit(ent, thr) <= target
        assert albert.mean_exit(ent, thr - 1e-4) > target - 0.05
        assert np.abs(ent[:, :-1] - thr).min() > 0


def test_af_grid_by_hand():
    """AF(8, 3): 4 mantissa bits; amax 3.0 puts the top binade at 2 and the
    bias at 2 - 7 = -6."""
    x = torch.tensor([3.0, 1.0, 1.03125, 1.09375, -2.9, 3.9, 2 ** -6 * 1.03, 2 ** -8])
    q = af.quantize(x, 8, 3, torch.tensor(3.0))
    assert q.tolist() == [3.0, 1.0, 1.0, 1.125, -2.875, 3.875, 2 ** -6 * 1.0625, 0.0]


class _Window:
    def __init__(self, evs, host0, host1, epoch_minus_host):
        self._evs, self.host0, self.host1, self.epoch_minus_host = evs, host0, host1, epoch_minus_host

    def events(self):
        return self._evs


def test_trace_reduction_busy_idle_and_gaps():
    """The profiler's clock 1000 ns ahead of the host's.  Two kernels
    overlap (100-300, 200-400) and one runs 600-700 in a window of 1000:
    busy 400, idle 600, split by the host spans open then; a kernel before
    the window is left out."""
    evs = [(900, 950, "k0"), (1100, 1300, "k1"), (1200, 1400, "k2"), (1600, 1700, "k1")]
    spans = tracing.Spans(True)
    spans.outer = [(0, 500, "step"), (500, 900, "poll")]
    spans.inner = [(400, 500, "lanes_step")]
    s = tracing.summary(_Window(evs, 0, 1000, 1000), spans)
    assert s["busy_s"] == pytest.approx(400e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    gaps = dict(s["idle_gaps"])
    assert gaps["step"] == pytest.approx(100e-9)
    assert gaps["lanes_step"] == pytest.approx(100e-9)
    assert gaps["poll"] == pytest.approx(300e-9)
    assert gaps["outside any span"] == pytest.approx(100e-9)
    assert sum(gaps.values()) == pytest.approx(600e-9)
    ops = dict(s["device_ops"])
    assert ops["k1"] == pytest.approx(300e-9) and ops["k2"] == pytest.approx(200e-9) and "k0" not in ops
    assert 0 < s["busy_s"] / s["window_s"] <= 1
    assert tracing.busy_inside(s["busy"], [(0, 250)]) == pytest.approx(150e-9)
