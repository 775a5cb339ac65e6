"""Operations and bytes of the encoder family's work (ModernBERT: global
and windowed attention, a GeGLU MLP, an off-ramp after every layer),
counted from the configuration's shapes and the requests' sizes, never
from what an implementation launches.  Bytes are float32 (4 each): each
input read once, each output written once.  Pruned weights count only
their nonzero tiles (``density``)."""
from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np

F32 = 4


def is_global(m: Dict, layer: int) -> bool:
    return layer % m["global_every"] == 0


@lru_cache(maxsize=4096)
def visible_pairs(S: int, kv: int, half: int = -1) -> int:
    """(query, key) pairs attention needs for ``S`` queries at positions
    0 .. S-1 against keys 0 .. kv-1: every key (``half`` < 0), or the keys
    within ``half`` positions of the query."""
    if half < 0:
        return S * kv
    i = np.arange(S, dtype=np.int64)
    return int(np.clip(np.minimum(kv, i + half + 1) - np.maximum(0, i - half), 0, None).sum())


def attention_pairs(m: Dict, layer: int, S: int, kv: int) -> int:
    return visible_pairs(S, kv, -1 if is_global(m, layer) else m["local_window"] // 2)


def doc_flops(m: Dict, n: int, depth: int, density: float) -> float:
    """One document of ``n`` real tokens through ``depth`` layers: q, k, v
    and o, the attention each layer's kind needs (scores and the weighted
    sum), the GeGLU MLP's nonzero tiles (``Wi`` d -> 2 ff, ``Wo`` ff -> d)
    and the off-ramp on the CLS row after each layer (dense d x d and the
    classifier)."""
    d, ff, C = m["d_model"], m["d_ff"], m["num_classes"]
    linear = 2.0 * n * (4 * d * d + 3 * d * ff * density)
    ramp = 2.0 * d * d + 2.0 * d * C
    return sum(linear + 4.0 * attention_pairs(m, i, n, n) * d + ramp for i in range(depth))


def span_call(m: Dict, layer: int, S: int, kv: int) -> tuple:
    """(operations, bytes) of one lane's span-attention call at ``layer``
    over a bucket of ``S`` positions whose first ``kv`` are the document's:
    every query row against the keys its layer's kind lets it see below
    kv; q and the output of S rows, k and v of kv rows."""
    hd = m["n_heads"] * m["head_dim"]
    return 4.0 * attention_pairs(m, layer, S, kv) * hd, (2 * S + 2 * kv) * hd * F32
