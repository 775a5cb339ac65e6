"""Entropy-based early exit (paper §III-A, Fig. 4; DeeBERT-style off-ramps).

One shared off-ramp (pooler d x d + classifier d x C) is evaluated after
every encoder block; a sentence exits when H(logits) < T_E.

Two parts, as in the JAX package's ``core/early_exit.py``:

* tensor functions on the off-ramp: ``offramp_logits``, ``exit_all_layers``
  (the dense all-layers sweep), ``exit_decisions``, ``select_exit_logits``;
* the host-side exit-layer predictor behind the DVFS controller (paper
  Alg. 1): ``ExitPredictor``, ``fit_exit_predictor``, ``predict_exit_layer``,
  ``OnlineExitCalibrator`` and the scheduler's ``predicted_remaining_layers``,
  numpy only.
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
