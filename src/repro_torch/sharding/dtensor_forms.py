"""The model's ops in forms that run on DTensors, swapped in for the length
of a ``with installed(cfg):`` block.  The dry run traces its steps inside
one (``launch/dryrun.py``); ``tests/test_torch_dtensor_forms.py`` holds
them against the plain model on real values over four ``gloo`` ranks.

The model code holds one path, written for plain tensors.  DTensor's
sharding rules cannot run some of its ops as written: einsums that fold a
sharded batch and a sharded head dim into one bmm batch dim, the MoE
routing's data-dependent gathers, a softmax over a sharded vocabulary, an
indexed write into a sharded cache, a view that splits a dim sharded into
more pieces than it has heads.  Here each such op runs rank by rank on its
local shards (``local_map``), or has its layout spelled out first.  Each
form calls the op it replaces on plain tensors and the original op itself
when its input is not a DTensor.  The swapped names:

* ``models.layers.attention``: ``_attention_sharded`` (and, under
  ``cfg.fused_attention``, its ops filed under ``fused_attn_kernel`` in the
  op analysis, the JAX package's named scope, on any input);
* ``models.layers._split_heads``, ``models.layers._write_rows``,
  ``models.model._per_layer_proj``;
* ``models.model.Model._sp_constrain``: the residual stream's layout
  between blocks (the JAX package's ``_sp_constrain``);
* ``models.moe.apply_moe``: ``_apply_moe_dtensor``;
* ``models.rwkv6._wkv_recurrent`` and ``_wkv_chunked``: ``_wkv_sharded``;
* ``training.losses.lm_loss``: ``_lm_loss_sharded``;
* ``training.train_loop._microbatch``: each rank's rows split.

Gradients follow DTensor's convention: one global loss, a replicated
leaf's per-rank gradients ``Partial`` and summed where they are next
needed.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from typing import Dict, Iterator, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_INSTALLED = False


# ---------------------------------------------------------------------------
# Gradient layout helpers for local_map regions
# ---------------------------------------------------------------------------


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.contiguous()


def contiguous_grad(*xs: torch.Tensor):
    """``xs`` unchanged, their gradients made contiguous: a function run
    through ``local_map`` hands its inputs' local gradients to DTensor,
    which takes a local tensor's layout to be the global one's (a permuted
    gradient from an einsum then fails the next ``view``)."""
    out = tuple(_ContiguousGrad.apply(x) if x is not None and x.requires_grad else x for x in xs)
    return out if len(out) > 1 else out[0]


class _GradPlacements(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def grad_placements(x, placements):
    """DTensor ``x`` unchanged, its gradient laid out as ``placements``
    before it goes further back: DTensor may leave a partial gradient
    reduce-scattered onto a dim that the function which made ``x`` (a
    ``local_map`` region) does not shard."""
    return _GradPlacements.apply(x, tuple(placements)) if x.requires_grad else x


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attention_sharded(attention, q, k, v, *, causal, span_z, span_ramp, q_block, kv_block, kv_len, q_offset,
                       window=None):
    """``attention`` on DTensors, rank by rank through ``local_map``.  Per
    mesh dim: rows stay where it shards q's batch; heads stay where it
    shards q's heads and the KV heads divide it too (each rank's query
    heads then read only its KV heads), or where it shards q's heads into
    groups that share KV heads (fewer KV heads than ranks: K and V are
    gathered and each rank reads its group's); where it shards the keys'
    sequence (a cache whose KV heads do not divide the model axis), every
    rank attends all query heads to its block of keys and the blocks are
    merged flash-decode style (an all-reduce of the running max, then of
    the rescaled sums and outputs); every other mesh dim is gathered first.
    A hard ``window`` (the encoder family's, which no mesh traces) has no
    form here."""
    if window is not None:
        raise NotImplementedError("attention with a hard window has no DTensor form")
    mesh, B, H, KV = q.device_mesh, q.shape[0], q.shape[2], k.shape[2]
    G = H // KV
    qp, kvp, kvg, rowp, headp, split, grouped = [], [], [], [], [], [], []
    for i, (pl, kpl) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        h_loc = H // n
        if pl == Shard(0) and k.shape[0] == B:
            qp.append(Shard(0)); kvp.append(Shard(0)); rowp.append(Shard(0)); headp.append(Replicate())
        elif kpl == Shard(1) and span_z is None:
            qp.append(Replicate()); kvp.append(Shard(1)); rowp.append(Replicate()); headp.append(Replicate())
            split.append(i)
        elif pl == Shard(2) and KV % n == 0:
            qp.append(Shard(2)); kvp.append(Shard(2)); rowp.append(Replicate()); headp.append(Shard(0))
        elif pl == Shard(2) and H % n == 0 and (h_loc % G == 0 or G % h_loc == 0) and not grouped:
            # fewer KV heads than ranks: each rank's query heads read the
            # KV heads of their group, taken from the replicated K and V
            qp.append(Shard(2)); kvp.append(Replicate()); rowp.append(Replicate()); headp.append(Shard(0))
            grouped.append(i)
        else:
            qp.append(Replicate()); kvp.append(Replicate()); rowp.append(Replicate()); headp.append(Replicate())
        kvg.append(Partial() if grouped and grouped[-1] == i else kvp[-1])
    rep = [Replicate()] * mesh.ndim

    def per_row(t):
        """A per-row [B] (or one-for-all [1]) argument as a DTensor and its placements."""
        if t is None:
            return None, None
        t = torch.as_tensor(t, device=q.device).reshape(-1)
        t = t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep, run_check=False)
        return t, (tuple(rowp) if t.shape[0] == B else tuple(rep))

    kvl, kvl_p = per_row(kv_len)
    qo, qo_p = per_row(q_offset)
    sz, sz_p = (None, None) if span_z is None else (span_z, tuple(headp))

    def local(q, k, v, kvl, qo, sz):
        q, k, v = contiguous_grad(q, k, v)
        if grouped:
            lo = mesh.get_local_rank(grouped[0]) * q.shape[2] // G
            n_kv = max(q.shape[2] // G, 1)
            k, v = k[:, :, lo:lo + n_kv], v[:, :, lo:lo + n_kv]
        if split:
            return _attention_key_blocks(q, k, v, mesh, split, causal=causal, kv_len=kvl,
                                         q_offset=0 if qo is None else qo)
        # one query tile: the same FLOPs and score bytes as q_block's tiles,
        # in a fraction of the ops a trace has to dispatch
        return attention(q, k, v, causal=causal, span_z=sz, span_ramp=span_ramp, q_block=q.shape[1],
                         kv_block=kv_block, kv_len=kvl, q_offset=0 if qo is None else qo)

    fn = local_map(local, out_placements=(tuple(qp),),
                   in_placements=(tuple(qp), tuple(kvp), tuple(kvp), kvl_p, qo_p, sz_p),
                   in_grad_placements=(tuple(qp), tuple(kvg), tuple(kvg), kvl_p, qo_p, sz_p),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, kvl, qo, sz)


def _attention_key_blocks(q, k, v, mesh, split, *, causal, kv_len, q_offset):
    """One rank's part of attention over keys sharded on the sequence by the
    mesh dims ``split`` (slowest first): its block of keys at their global
    positions, merged with the other ranks' blocks over those dims.  The
    math is ``attention``'s short path (a masked softmax, fully masked rows
    giving zeros)."""
    import torch.distributed._functional_collectives as funcol

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, dev = H // KV, q.device
    block = 0
    for i in split:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    k_pos = block * Sk + torch.arange(Sk, device=dev)
    kvl = None if kv_len is None else torch.as_tensor(kv_len, device=dev).reshape(-1)
    q_pos = torch.as_tensor(q_offset, device=dev).reshape(-1, 1) + torch.arange(Sq, device=dev)
    s = torch.einsum("bqkgd,bskd->bqkgs", (q.float() / math.sqrt(hd)).reshape(B, Sq, KV, G, hd), k.float())
    valid = (k_pos[None, None, :] < (kvl.reshape(-1, 1, 1) if kvl is not None else math.inf))
    if causal:
        valid = valid & (q_pos[:, :, None] >= k_pos[None, None, :])
    s = torch.where(valid.expand(B, Sq, Sk)[:, :, None, None, :], s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    for i in split:
        m = funcol.all_reduce(m, "max", (mesh, i))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m), torch.zeros_like(s))
    l, o = p.sum(dim=-1, keepdim=True), torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    for i in split:
        l, o = funcol.all_reduce(l, "sum", (mesh, i)), funcol.all_reduce(o, "sum", (mesh, i))
    return (o / l.clamp_min(1e-20)).reshape(B, Sq, H, hd).to(q.dtype)


def _split_heads(split_heads, t, n: int, hd: int):
    """[..., n * hd] -> [..., n, hd].  Where a mesh dim shards the last dim
    into a count that does not divide n (8 KV heads on a 16-way model
    axis), that mesh dim is gathered first: each rank then holds every KV
    head, as Megatron replicates KV heads below the tensor-parallel
    degree."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        pl = [Replicate() if p == Shard(t.ndim - 1) and n % mesh.size(i) else p for i, p in enumerate(t.placements)]
        if tuple(pl) != tuple(t.placements):
            t = t.redistribute(mesh, pl)
    return split_heads(t, n, hd)


def _write_rows(write_rows, c, rows, cols, val) -> None:
    """``c[rows, cols] = val`` into a DTensor cache as a scatter along the
    sequence dim, which DTensor runs on each rank's shard of the batch and
    heads (an indexed write would gather the cache first); a cache sharded
    on the sequence goes to ``_write_rows_sharded``."""
    if not isinstance(c, DTensor):
        write_rows(c, rows, cols, val)
    elif any(getattr(p, "dim", None) == 1 for p in c.placements):
        _write_rows_sharded(c, cols, val)
    else:
        c.scatter_(1, cols[:, :, None, None].expand(val.shape), val)


def _write_rows_sharded(c, cols, val) -> None:
    """The write into a DTensor cache whose sequence a mesh dim shards: each
    rank writes the positions that fall in its block (``local_map``),
    keeping its other rows."""
    mesh = c.device_mesh
    if not isinstance(cols, DTensor):
        cols = DTensor.from_local(cols, mesh, [Replicate()] * mesh.ndim, run_check=False)
    seq = [i for i, p in enumerate(c.placements) if p == Shard(1)]
    v_p = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in c.placements)
    i_p = tuple(p if p == Shard(0) else Replicate() for p in c.placements)

    def local(c, cols, val):
        S_loc, block = c.shape[1], 0
        for i in seq:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        at = cols - block * S_loc
        inside = ((at >= 0) & (at < S_loc))[:, :, None, None]
        idx = at.clamp(0, S_loc - 1)[:, :, None, None].expand(val.shape)
        c.scatter_(1, idx, torch.where(inside, val, c.gather(1, idx)))
        return c

    local_map(local, out_placements=(tuple(c.placements),), in_placements=(tuple(c.placements), i_p, v_p),
              device_mesh=mesh, redistribute_inputs=True)(c, cols, val)


def _per_layer_proj(per_layer_proj, x, w):
    """x [B, S, d] through each of the stacked projections w [L, d, k] ->
    [L, B, S, k], one matmul per layer (DTensor's rules cannot fold a
    sharded batch into the einsum's product)."""
    if not isinstance(x, DTensor):
        return per_layer_proj(x, w)
    return torch.stack([x @ w[i] for i in range(w.shape[0])])


# ---------------------------------------------------------------------------
# The residual stream's layout
# ---------------------------------------------------------------------------


def _sp_constrain(model, h):
    """[B, S, D] keeps B sharded over the mesh's batch axes
    (``sp_batch_axes`` under ``sequence_parallel``) and S sharded over
    ``model`` under ``sequence_parallel`` (Megatron-SP) where the axis
    divides it, replicated over it otherwise (a decode step's one token):
    the Megatron layout XLA's partitioner keeps between blocks, which
    DTensor's rules need spelled out (they cannot run a matmul over
    batch x sequence when both are sharded)."""
    if not isinstance(h, DTensor) or h.ndim != 3:
        return h
    cfg, mesh = model.cfg, h.device_mesh
    batch_axes = cfg.sp_batch_axes if cfg.sequence_parallel else ("pod", "data")
    placements, n_batch = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == "model":
            sp = cfg.sequence_parallel and h.shape[1] % mesh.size(i) == 0
            placements.append(Shard(1) if sp else Replicate())
        elif name in batch_axes and h.shape[0] % (n_batch * mesh.size(i)) == 0:
            n_batch *= mesh.size(i)
            placements.append(Shard(0))
        else:
            placements.append(Replicate())
    return h.redistribute(mesh, placements)


# ---------------------------------------------------------------------------
# MoE, RWKV6's WKV, the LM loss, microbatches
# ---------------------------------------------------------------------------


def _apply_moe_dtensor(p, x, cfg, capacity_factor: float, grouped: bool):
    """The MoE layer on DTensors, each rank on its own shards through
    ``local_map``: the JAX package's ``shard_map`` dispatch
    (``moe_shardmap_dispatch``), whose routing is per batch shard, for any
    config.  Each rank routes its batch shard against the full router,
    capacity from the local token count.  On the model axis the rules
    either shard the experts (E % m == 0: each rank runs its E / m experts'
    assignments, as ``apply_moe_shardmap``) or the experts' hidden dim
    (qwen2-moe's 60 experts on 16 ranks: each rank runs every expert's
    slice of it); either way the rank's output is a partial sum over the
    model axis, which DTensor reduces where it is next needed.  The aux
    loss is the mean of the batch shards'; qwen2's shared expert runs on
    the DTensors outside the region.  (``apply_moe_shardmap`` itself is
    not called here: its transposes follow the per-rank loss of a plain
    data-parallel step, where the step averages the gradients.)"""
    from repro_torch.models.moe import _moe_tokens, _shared_expert

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.size(names.index("model")) if "model" in names else 1
    E = cfg.n_experts
    ep = E % m == 0
    e_loc = E // m if ep else E
    e_off = mesh.get_local_rank("model") * e_loc if ep and m > 1 else 0
    w_dims = {"w_gate": -3, "w_up": -3, "w_down": -3} if ep else {"w_gate": -1, "w_up": -1, "w_down": -2}

    def pl(batch, model):
        return tuple(model if n == "model" else batch for n in names)

    keys = ("router", "w_gate", "w_up", "w_down")
    in_p = {"router": pl(Replicate(), Replicate())}
    grad_p = {"router": pl(Partial(), Partial())}
    for k, dim in w_dims.items():
        in_p[k] = pl(Replicate(), Shard(p[k].ndim + dim))
        grad_p[k] = pl(Partial(), Shard(p[k].ndim + dim))

    def local(xl, router, w_gate, w_up, w_down):
        xl, router, w_gate, w_up, w_down = contiguous_grad(xl, router, w_gate, w_up, w_down)
        lp = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        B_l, S, d = xl.shape
        xt = xl if grouped else xl.reshape(1, B_l * S, d)
        y, aux = _moe_tokens(lp, xt, cfg, capacity_factor, local_expert_range=(e_off, e_loc) if ep else None)
        return y.reshape(B_l, S, d), (aux.mean() / m).reshape(1)

    # the aux loss leaves as one entry per batch shard, then their mean.
    # Every model rank computes its shard's aux loss alike; each hands out a
    # 1 / m part of it, so that its gradient, which every rank's router and
    # input take in full, counts once when their partials are summed
    fn = local_map(local, out_placements=(pl(Shard(0), Partial()), pl(Shard(0), Partial())),
                   in_placements=(pl(Shard(0), Replicate()),) + tuple(in_p[k] for k in keys),
                   in_grad_placements=(pl(Shard(0), Partial()),) + tuple(grad_p[k] for k in keys),
                   device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(x, *(p[k] for k in keys))
    aux = aux.mean()
    if "shared" in p:
        # the flat tokens' gradient gathered back to whole rows before the
        # reshape's backward (DTensor may reduce-scatter it over the tokens)
        xt = grad_placements(x.reshape(-1, x.shape[-1]), pl(Shard(0), Replicate()))
        y = y + _shared_expert(p["shared"], xt).reshape(x.shape)
    return y, aux


def _wkv_sharded(wkv, r, k, v, w, u, init_state):
    """``wkv(r, k, v, w, u, init_state)`` (either form) rank by rank through
    ``local_map``: the recurrence is independent per batch row and head, so
    rows stay on the mesh dims that shard r's batch and heads on those that
    shard its heads, and every other mesh dim is gathered first.  DTensor's
    own rules cannot run the einsums, which fold a sharded batch and a
    sharded head dim into one bmm batch dim."""
    mesh = r.device_mesh
    x_p, u_p, u_g, s_p = [], [], [], []
    for pl in r.placements:
        rows, heads = pl == Shard(0), pl == Shard(2)
        x_p.append(Shard(0) if rows else Shard(2) if heads else Replicate())
        u_p.append(Shard(0) if heads else Replicate())
        u_g.append(Partial() if rows else Shard(0) if heads else Replicate())
        s_p.append(Shard(0) if rows else Shard(1) if heads else Replicate())
    x_p, u_p, u_g, s_p = tuple(x_p), tuple(u_p), tuple(u_g), tuple(s_p)
    s0_p = None if init_state is None else s_p

    def local(r, k, v, w, u, s0):
        return wkv(*contiguous_grad(r, k, v, w, u), s0)

    fn = local_map(local, out_placements=(x_p, s_p), in_placements=(x_p, x_p, x_p, x_p, u_p, s0_p),
                   in_grad_placements=(x_p, x_p, x_p, x_p, u_g, s0_p), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(r, k, v, w, u, init_state)


def _lm_loss_sharded(logits, tokens) -> Tuple[torch.Tensor, Dict]:
    """``lm_loss`` on DTensors: the logits' vocab shard moves to the
    sequence dim (one all-to-all, each rank then holds whole rows of the
    vocabulary), each rank sums its rows' NLL and hits through
    ``local_map``, and the sums are reduced.  Position s predicts token
    s + 1; the last position's target wraps and is masked out, so the mean
    is over B x (S - 1) as in the plain loss.  DTensor's rules cannot run a
    softmax, gather or argmax over a sharded vocabulary."""
    mesh = logits.device_mesh
    B, S, V = logits.shape
    rows, sums = [], []
    for i, pl in enumerate(logits.placements):
        if pl == Shard(0):
            rows.append(Shard(0))
        elif pl == Shard(2) and S % mesh.size(i) == 0:
            rows.append(Shard(1))
        else:
            rows.append(Replicate())
        sums.append(Replicate() if rows[-1] == Replicate() else Partial())
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    ok = DTensor.from_local((torch.arange(S, device=tokens.device) < S - 1).float().expand(B, S), mesh,
                            [Replicate()] * mesh.ndim, run_check=False)

    def local(lg, tg, ok):
        lg = contiguous_grad(lg).float()
        nll = -torch.gather(torch.log_softmax(lg, dim=-1), -1, tg[..., None])[..., 0]
        return (nll * ok).sum(), ok.sum(), ((lg.argmax(-1) == tg).float() * ok).sum()

    pl_rows = tuple(rows)
    fn = local_map(local, out_placements=(tuple(sums),) * 3,
                   in_placements=(pl_rows, pl_rows, pl_rows), device_mesh=mesh, redistribute_inputs=True)
    nll, count, hits = fn(logits, tgt, ok)
    loss = nll / count
    return loss, {"loss": loss, "acc": hits / count}


def _microbatch(microbatch, v, k: int, i: int):
    """Microbatch ``i`` of ``k`` of a DTensor batch (rows sharded over the
    data axes), split within each shard (each rank takes the i-th block of
    its own rows), so that every microbatch keeps the batch's sharding,
    where a block of global rows would sit on a few data ranks.  The mean
    over the k microbatches is the plain split's."""
    if not isinstance(v, DTensor):
        return microbatch(v, k, i)
    pl = tuple(v.placements)
    return local_map(lambda t: t.reshape((k, t.shape[0] // k) + tuple(t.shape[1:]))[i].contiguous(),
                     out_placements=(pl,), in_placements=(pl,), device_mesh=v.device_mesh)(v)


# ---------------------------------------------------------------------------
# The swap
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def installed(cfg) -> Iterator[None]:
    """The forms above in place of the model's ops inside the block, for
    models of ``cfg`` (its ``fused_attention`` labels the attention's ops);
    the originals back on exit.  Not reentrant."""
    global _INSTALLED
    from repro_torch.hwmodel.op_analysis import scope
    from repro_torch.models import layers, model, moe, rwkv6
    from repro_torch.training import losses, train_loop

    if _INSTALLED:
        raise RuntimeError("dtensor_forms.installed is already active")
    fused = bool(getattr(cfg, "fused_attention", False))
    orig = {
        (layers, "attention"): layers.attention,
        (layers, "_split_heads"): layers._split_heads,
        (layers, "_write_rows"): layers._write_rows,
        (model, "_per_layer_proj"): model._per_layer_proj,
        (model.Model, "_sp_constrain"): model.Model.__dict__["_sp_constrain"],
        (moe, "apply_moe"): moe.apply_moe,
        (rwkv6, "_wkv_recurrent"): rwkv6._wkv_recurrent,
        (rwkv6, "_wkv_chunked"): rwkv6._wkv_chunked,
        (losses, "lm_loss"): losses.lm_loss,
        (train_loop, "_microbatch"): train_loop._microbatch,
    }
    attention, recurrent, chunked = layers.attention, rwkv6._wkv_recurrent, rwkv6._wkv_chunked
    apply_moe, lm_loss = moe.apply_moe, losses.lm_loss

    defaults = {n: a.default for n, a in inspect.signature(attention).parameters.items()
                if a.kind == a.KEYWORD_ONLY and a.default is not a.empty}

    def attention_form(q, k, v, **kw):
        with scope("fused_attn_kernel") if fused else contextlib.nullcontext():
            if isinstance(q, DTensor):
                return _attention_sharded(attention, q, k, v, **{**defaults, **kw})
            return attention(q, k, v, **kw)

    def apply_moe_form(p, x, cfg, capacity_factor=1.25, *, grouped=None):
        if not isinstance(x, DTensor):
            return apply_moe(p, x, cfg, capacity_factor, grouped=grouped)
        return _apply_moe_dtensor(p, x, cfg, capacity_factor,
                                  cfg.moe_grouped_dispatch if grouped is None else grouped)

    def recurrent_form(r, k, v, w, u, init_state=None):
        if not isinstance(r, DTensor):
            return recurrent(r, k, v, w, u, init_state=init_state)
        return _wkv_sharded(lambda *a: recurrent(*a[:5], init_state=a[5]), r, k, v, w, u, init_state)

    def chunked_form(r, k, v, w, u, chunk, init_state=None):
        if not isinstance(r, DTensor):
            return chunked(r, k, v, w, u, chunk, init_state=init_state)
        return _wkv_sharded(lambda *a: chunked(*a[:5], chunk, init_state=a[5]), r, k, v, w, u, init_state)

    def lm_loss_form(logits, tokens):
        return _lm_loss_sharded(logits, tokens) if isinstance(logits, DTensor) else lm_loss(logits, tokens)

    forms = {
        (layers, "attention"): attention_form,
        (layers, "_split_heads"): lambda t, n, hd, f=layers._split_heads: _split_heads(f, t, n, hd),
        (layers, "_write_rows"): lambda c, r, cl, v, f=layers._write_rows: _write_rows(f, c, r, cl, v),
        (model, "_per_layer_proj"): lambda x, w, f=model._per_layer_proj: _per_layer_proj(f, x, w),
        (model.Model, "_sp_constrain"): _sp_constrain,
        (moe, "apply_moe"): apply_moe_form,
        (rwkv6, "_wkv_recurrent"): recurrent_form,
        (rwkv6, "_wkv_chunked"): chunked_form,
        (losses, "lm_loss"): lm_loss_form,
        (train_loop, "_microbatch"): lambda v, k, i, f=train_loop._microbatch: _microbatch(f, v, k, i),
    }
    _INSTALLED = True
    try:
        for (owner, name), form in forms.items():
            setattr(owner, name, form)
        yield
    finally:
        for (owner, name), fn in orig.items():
            setattr(owner, name, fn)
        _INSTALLED = False
