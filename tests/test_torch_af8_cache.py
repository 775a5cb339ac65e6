"""The AF8 KV cache (``kv_cache_dtype="af8"``: uint8 AdaptivFloat codes
with a static exponent bias) on the decoders whose decode paths run it
beside the dense and vlm families (``test_torch_decode.py``,
``test_torch_vlm.py``): the MoE decoder (qwen2-moe-a2.7b), the LayerNorm
dense decoder (minitron-8b), the hybrid (zamba2-1.2b: the shared block's
cache) and the encoder-decoder (whisper-medium: the self-attention cache
and the encoder's cross K/V), each at its smoke config in float32.

Port against the JAX package: ``init_cache`` -> ``prefill`` over a 6-token
prompt -> 3 ``decode_step``s, the same JAX params bridged across and the
tokens and frames made by numpy from a seed.  Every AF8 code in the cache
equal, every float leaf of the cache (recurrent states, the cross K/V)
and the logits within the decode tests' 1e-5 (1e-4 for the hybrid, whose
SSD sums reach ~20, as in ``test_torch_train_forwards.py``).  The decode
steps run the JAX model's batched call (``per_lane=False``), so the MoE
layer routes the lanes together in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.models.model import build_model as t_build

ARCHS = ["qwen2_moe_a2p7b", "minitron_8b", "zamba2_1p2b", "whisper_medium"]
ATOL = {"zamba2_1p2b": 1e-4}
B, PROMPT, STEPS, MAX_SEQ = 2, 6, 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_cache(got, want, atol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].numpy().dtype == w.dtype, k
        if w.dtype == np.uint8:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_af8_cache_prefill_and_decode_match_jax(arch):
    jcfg, tcfg = (dataclasses.replace(get(arch), dtype="float32", remat_policy="none", kv_cache_dtype="af8")
                  for get in (j_smoke, t_smoke))
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (B, PROMPT + STEPS))
    aux = None
    if tcfg.family == "encdec":
        aux = {"enc_input": (rng.standard_normal((B, tcfg.enc_seq_len, tcfg.d_model)) * 0.1).astype(np.float32)}
    atol = ATOL.get(arch, 1e-5)

    jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ, device="cpu")
    assert any(np.asarray(v).dtype == np.uint8 for v in jc.values())
    _check_cache(tc, jc, 0.0)
    with torch.no_grad():
        jl, jc = jm.prefill(jp, jnp.asarray(tokens[:, :PROMPT]), jc,
                            aux=None if aux is None else {k: jnp.asarray(v) for k, v in aux.items()})
        tl, tc = tm.prefill(tp, torch.as_tensor(tokens[:, :PROMPT]), tc,
                            aux=None if aux is None else {k: torch.as_tensor(v) for k, v in aux.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
        _check_cache(tc, jc, atol)
        for step in range(PROMPT, PROMPT + STEPS):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, step:step + 1]), step)
            tl, tc = tm.decode_step(tp, tc, torch.as_tensor(tokens[:, step:step + 1]), step, per_lane=False)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0, err_msg=f"step {step}")
            _check_cache(tc, jc, atol)
    # the codes hold the prompt and the steps: nonzero up to the last position
    kv = "k" if "k" in jc else next(k for k, v in jc.items() if np.asarray(v).dtype == np.uint8)
    assert np.asarray(jc[kv])[..., :PROMPT + STEPS, :, :].any()
