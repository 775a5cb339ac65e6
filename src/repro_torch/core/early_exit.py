"""Entropy-based early exit (paper §III-A, Fig. 4; DeeBERT-style off-ramps).

One shared off-ramp (pooler d x d + classifier d x C) is evaluated after
every encoder block; a sentence exits when H(logits) < T_E.  The port's
encoder family (ModernBERT) has one off-ramp per layer in its own head form
(``Model.encoder_offramp``), as DeeBERT gives each unshared layer its
own.

Two parts, as in the JAX package's ``core/early_exit.py``:

* tensor functions on the off-ramp: ``offramp_logits``, ``exit_all_layers``
  (the dense all-layers sweep), ``exit_decisions``, ``select_exit_logits``;
* the host-side exit-layer predictor behind the DVFS controller (paper
  Alg. 1): ``ExitPredictor``, ``fit_exit_predictor``, ``predict_exit_layer``,
  ``OnlineExitCalibrator`` and the scheduler's ``predicted_remaining_layers``;
  and its decoder form, keyed by decode position: the
  ``PositionBinnedExitCalibrator``, the ``ExitThresholdSchedule`` of the
  self-speculative decode and ``predicted_token_layers``; numpy only,
  copied from the JAX package.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.entropy import entropy_from_logits


class OfframpParams(NamedTuple):
    pooler_w: torch.Tensor   # [d, d]
    pooler_b: torch.Tensor   # [d]
    cls_w: torch.Tensor      # [d, C]
    cls_b: torch.Tensor      # [C]


def offramp_logits(h: torch.Tensor, p: OfframpParams) -> torch.Tensor:
    """h: [..., seq, d] -> logits [..., C].  CLS pooling (token 0) + tanh."""
    cls = h[..., 0, :]
    pooled = torch.tanh(cls @ p.pooler_w + p.pooler_b)
    return pooled @ p.cls_w + p.cls_b


def exit_all_layers(
    layer_fn: Callable[[int, torch.Tensor], torch.Tensor],
    n_layers: int,
    h0: torch.Tensor,
    offramp: OfframpParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer; return (all_logits [L, B, C], all_entropy [L, B])."""
    h = h0
    logits, ents = [], []
    for i in range(n_layers):
        h = layer_fn(i, h)
        lg = offramp_logits(h, offramp)
        logits.append(lg)
        ents.append(entropy_from_logits(lg))
    return torch.stack(logits), torch.stack(ents)


def exit_decisions(
    entropies: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer entropies [L, B] -> (exit layer per sample, 1-based; one-hot
    [L, B] of the (layer, sample) that produced the final prediction)."""
    L = entropies.shape[0]
    below = entropies < threshold
    below[-1] = True                       # force exit at the last layer
    exit_layer = torch.argmax(below.to(torch.int32), dim=0)   # first True
    onehot = F.one_hot(exit_layer, L).T.to(entropies.dtype)
    return exit_layer + 1, onehot


def select_exit_logits(all_logits: torch.Tensor, exit_layer_1based: torch.Tensor) -> torch.Tensor:
    """all_logits [L, B, C], exit_layer [B] -> [B, C]."""
    idx = (exit_layer_1based - 1).long()
    return all_logits[idx, torch.arange(all_logits.shape[1], device=all_logits.device)]


# ---------------------------------------------------------------------------
# Exit-layer prediction (paper Alg. 1: LUT indexed by the first off-ramp's
# entropy, the signal driving sentence-level DVFS)
# ---------------------------------------------------------------------------


class ExitPredictor(NamedTuple):
    """Binned LUT: first-off-ramp entropy -> expected total exit layer."""

    bin_edges: np.ndarray    # [n_bins - 1] interior entropy bin edges
    bin_exit: np.ndarray     # [n_bins] expected exit layer (1-based, float)


def fit_exit_predictor(
    first_layer_entropy: np.ndarray,
    exit_layers: np.ndarray,
    n_bins: int = 16,
    quantile: Optional[float] = None,
) -> ExitPredictor:
    """Calibrate the LUT from a profiling run.

    ``quantile=None`` stores each bin's mean exit layer; a quantile stores
    that quantile instead (conservative prediction).  Empty bins are filled
    by interpolation between their filled neighbours.
    """
    e = np.asarray(first_layer_entropy, np.float64).ravel()
    x = np.asarray(exit_layers, np.float64).ravel()
    assert e.shape == x.shape and e.size > 0
    lo, hi = float(e.min()), float(e.max())
    if hi <= lo:
        hi = lo + 1e-6
    edges = np.linspace(lo, hi, n_bins + 1)[1:-1]
    idx = np.digitize(e, edges)
    mean = np.full(n_bins, np.nan)
    for b in range(n_bins):
        sel = idx == b
        if sel.any():
            mean[b] = (
                x[sel].mean() if quantile is None else np.quantile(x[sel], quantile)
            )
    filled = ~np.isnan(mean)
    centers = np.arange(n_bins, dtype=np.float64)
    mean = np.interp(centers, centers[filled], mean[filled])
    return ExitPredictor(bin_edges=edges, bin_exit=mean)


def predict_exit_layer(predictor: ExitPredictor, entropy: float) -> float:
    """Expected total exit layer (1-based) for a sentence whose first
    off-ramp entropy is ``entropy``."""
    b = int(np.digitize([float(entropy)], predictor.bin_edges)[0])
    return float(predictor.bin_exit[b])


class OnlineExitCalibrator:
    """Streaming exit-layer LUT: a bounded window of exit layers per entropy
    bin, re-estimating each bin's quantile on every observation.  Bins with
    no observations predict the full ``n_layers`` (conservative cold start).
    """

    def __init__(
        self,
        n_layers: int,
        *,
        lo: float = 0.0,
        hi: float = 1.1,
        n_bins: int = 16,
        quantile: float = 1.0,
        window: int = 256,
    ):
        assert hi > lo and n_bins >= 1 and window >= 1
        assert 0.0 <= quantile <= 1.0
        self.n_layers = int(n_layers)
        self.quantile = float(quantile)
        self.bin_edges = np.linspace(lo, hi, n_bins + 1)[1:-1]
        self._windows = [deque(maxlen=window) for _ in range(n_bins)]
        self.bin_exit = np.full(n_bins, float(n_layers))
        self.count = 0

    def observe(self, first_entropy: float, exit_layer: int) -> None:
        """Fold one retired sentence into its bin's running quantile."""
        b = int(np.digitize([float(first_entropy)], self.bin_edges)[0])
        w = self._windows[b]
        w.append(float(np.clip(exit_layer, 1, self.n_layers)))
        self.bin_exit[b] = float(np.quantile(np.asarray(w), self.quantile))
        self.count += 1

    def predict(self, first_entropy: float) -> float:
        b = int(np.digitize([float(first_entropy)], self.bin_edges)[0])
        return float(self.bin_exit[b])

    def predictor(self) -> ExitPredictor:
        """Snapshot as an ``ExitPredictor`` LUT."""
        return ExitPredictor(
            bin_edges=self.bin_edges.copy(), bin_exit=self.bin_exit.copy()
        )


class PositionBinnedExitCalibrator(OnlineExitCalibrator):
    """Token-level variant of the online LUT: keyed by DECODE POSITION bin.

    The classifier's Alg. 1 predictor maps a sentence's first-off-ramp
    entropy to its exit layer.  Autoregressive decode has no single "first
    off-ramp" per request — every generated token takes its own off-ramp
    walk — but token exit depth correlates strongly with the token's
    POSITION in the generation (early tokens copy prompt structure and exit
    shallow; later tokens carry more uncertainty), so the decode-side LUT
    bins on position instead: ``observe(position, exit_layer)`` folds a
    generated token into its position bin's running quantile and
    ``predict(position)`` reads it back.  Machinery (bounded windows,
    per-bin quantiles, conservative full-depth cold start) is inherited
    unchanged from ``OnlineExitCalibrator`` — position is just a different
    scalar key into the same SRAM-table image.
    """

    def __init__(
        self,
        n_layers: int,
        *,
        max_pos: int = 256,
        n_bins: int = 8,
        quantile: float = 1.0,
        window: int = 256,
    ):
        assert max_pos >= 1
        super().__init__(
            n_layers, lo=0.0, hi=float(max_pos), n_bins=n_bins,
            quantile=quantile, window=window,
        )

    def predict_range(self, pos_start: int, pos_end: int) -> float:
        """Vectorized ``predicted_token_layers`` over [pos_start, pos_end):
        one digitize over the position range instead of a per-token Python
        loop — the serving engine refreshes every active lane's remainder
        each fused step, so this is hot-path."""
        if pos_end <= pos_start:
            return 0.0
        idx = np.digitize(np.arange(pos_start, pos_end, dtype=np.float64),
                          self.bin_edges)
        return float(np.clip(self.bin_exit[idx], 1.0, self.n_layers).sum())

    def bin_fill_counts(self) -> np.ndarray:
        """Observations currently held per position bin — the speculative
        decode regression signal: a server that folds one depth per accepted
        BLOCK (instead of one per accepted TOKEN) starves the bins covering
        positions inside accepted prefixes, visible here as empty windows."""
        return np.array([len(w) for w in self._windows], dtype=np.int64)


class ExitThresholdSchedule:
    """Per-position / per-entropy-band generalization of the scalar exit
    threshold (the knob ``decode_step_ee`` compares off-ramp entropy to).

    The scalar threshold treats every decode position identically, but token
    confidence is strongly position-dependent (the same structure the
    ``PositionBinnedExitCalibrator`` exploits for depth prediction): early
    continuation tokens copy prompt structure and can afford a LOOSER
    threshold (exit more, draft more under speculation), while
    high-uncertainty stretches warrant a tighter one.  The schedule is a
    piecewise-constant multiplier surface over (position bin, entropy band)
    applied to a ``base`` threshold:

      * ``position_edges`` / ``position_scales`` — multiplier by decode
        position (``len(scales) == len(edges) + 1``, digitize semantics);
      * ``band_edges`` / ``band_scales`` — multiplier by the lane's LAST
        observed first-off-ramp entropy (a cheap per-lane confidence proxy:
        a lane that just read a confident ramp speculates harder);
      * a ``PositionBinnedExitCalibrator`` may back the schedule: ``observe``
        forwards every accepted token's realized depth into the calibrator
        (the one prediction chain stays shared), and ``from_calibrator``
        derives position scales from the warmed bins.

    With no edges the schedule is CONSTANT and ``threshold_at(p) == base``
    exactly, so the degenerate schedule is bit-identical to the scalar
    threshold — the parity anchor the speculative-decode tests pin.
    """

    def __init__(
        self,
        base: float,
        *,
        position_edges=(),
        position_scales=(1.0,),
        band_edges=(),
        band_scales=(1.0,),
        calibrator: Optional["PositionBinnedExitCalibrator"] = None,
        min_threshold: float = 0.0,
        max_threshold: Optional[float] = None,
    ):
        self.base = float(base)
        self.position_edges = np.asarray(position_edges, np.float64)
        self.position_scales = np.asarray(position_scales, np.float64)
        self.band_edges = np.asarray(band_edges, np.float64)
        self.band_scales = np.asarray(band_scales, np.float64)
        assert self.position_scales.size == self.position_edges.size + 1, (
            "need len(position_scales) == len(position_edges) + 1"
        )
        assert self.band_scales.size == self.band_edges.size + 1, (
            "need len(band_scales) == len(band_edges) + 1"
        )
        self.calibrator = calibrator
        self.min_threshold = float(min_threshold)
        self.max_threshold = max_threshold

    @classmethod
    def from_calibrator(
        cls,
        base: float,
        calibrator: "PositionBinnedExitCalibrator",
        *,
        loosen: float = 1.25,
        tighten: float = 0.85,
        **kwargs,
    ) -> "ExitThresholdSchedule":
        """Derive position scales from a (partially) warmed calibrator: bins
        whose running quantile predicts a SHALLOW exit (< half depth) are
        confident regions and loosen the threshold; bins predicting deep
        exits tighten it; cold bins (still at the conservative full depth)
        keep the base — a cold calibrator yields the constant schedule."""
        n_layers = float(calibrator.n_layers)
        scales = []
        for pred in calibrator.bin_exit:
            if pred >= n_layers - 1e-9:          # cold or genuinely full-depth
                scales.append(1.0)
            elif pred <= n_layers / 2.0:
                scales.append(float(loosen))
            else:
                scales.append(float(tighten))
        return cls(
            base,
            position_edges=calibrator.bin_edges.copy(),
            position_scales=np.asarray(scales),
            calibrator=calibrator,
            **kwargs,
        )

    def _clip(self, t: np.ndarray) -> np.ndarray:
        hi = np.inf if self.max_threshold is None else self.max_threshold
        return np.clip(t, self.min_threshold, hi)

    def thresholds(
        self, pos_start: int, count: int, last_entropy: Optional[float] = None
    ) -> np.ndarray:
        """Vectorized thresholds for positions [pos_start, pos_start+count)
        — the per-slot threshold row a speculative fused step consumes
        (slot j speculates the token at position ``pos_start + j``)."""
        positions = np.arange(pos_start, pos_start + count, dtype=np.float64)
        if self.position_edges.size:
            scale = self.position_scales[
                np.digitize(positions, self.position_edges)
            ]
        else:
            scale = np.full(count, self.position_scales[0])
        if self.band_edges.size and last_entropy is not None:
            b = int(np.digitize([float(last_entropy)], self.band_edges)[0])
            scale = scale * self.band_scales[b]
        return self._clip(self.base * scale).astype(np.float32)

    def threshold_at(
        self, position: int, last_entropy: Optional[float] = None
    ) -> float:
        return float(self.thresholds(position, 1, last_entropy)[0])

    def observe(
        self, position: int, first_entropy: float, exit_layer: int
    ) -> None:
        """Fold one ACCEPTED token's realized depth into the backing
        calibrator (every accepted token, not one per block — the bin-fill
        regression the speculative tests pin)."""
        if self.calibrator is not None:
            self.calibrator.observe(position, exit_layer)


def predicted_token_layers(
    predict_fn: Callable[[int], float],
    pos_start: int,
    pos_end: int,
    n_layers: int,
) -> float:
    """Predicted TOTAL layers for the tokens at positions [pos_start, pos_end).

    ``predict_fn`` is a per-position exit-depth predictor (e.g.
    ``PositionBinnedExitCalibrator.predict``); each position's prediction is
    clamped to ``[1, n_layers]`` so a cold calibrator quotes the conservative
    full depth for every remaining token.  This is the decode-side analogue
    of ``predicted_remaining_layers``: the scheduler's EDF slack, the DVFS
    arbiter's required frequency, and the admission feasibility quote all
    consume it, so the three layers budget decode work off ONE prediction
    chain.
    """
    if pos_end <= pos_start:
        return 0.0
    total = 0.0
    for t in range(int(pos_start), int(pos_end)):
        total += float(np.clip(predict_fn(t), 1.0, n_layers))
    return total


def predicted_remaining_layers(
    entropy_trace,
    depth: int,
    n_layers: int,
    *,
    predict_fn: Optional[Callable[[float], float]] = None,
) -> float:
    """Remaining encoder layers a sentence is predicted to need: the
    scheduler's EDF slack input.  ``predict_fn`` maps a first off-ramp
    entropy to a predicted total exit layer (the DVFS controller's
    ``predict``, so EDF and the frequency decision share one prediction).
    Before the first off-ramp, or without ``predict_fn``, the prediction is
    the full depth; a sentence that ran past its predicted exit reverts to
    the full depth (the DVFS escalation guard).  At least 1."""
    if len(entropy_trace) == 0 or predict_fn is None:
        p = float(n_layers)
    else:
        p = float(predict_fn(float(entropy_trace[0])))
    p = float(np.clip(p, 1.0, n_layers))
    if depth >= p - 1e-9:                 # overran the prediction: escalate
        return max(float(n_layers) - depth, 1.0)
    return max(p - depth, 1.0)
