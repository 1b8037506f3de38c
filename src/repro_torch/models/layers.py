"""Layer building blocks, in PyTorch: ``src/repro/models/layers.py`` —
``dense_init``, ``layernorm`` and ``rmsnorm``, the activations (``act_fn``,
with the tanh-approximated GELU), RoPE, ``chunked_attention``, the
online-softmax attention the transformer models train through,
``decode_attention`` against a KV cache, the mixture-of-experts FFN
(``moe_ffn``: a top-k router, then a sorted grouped product, or across the
ranks of a mesh the expert-parallel dispatch) and Multi-head Latent
Attention (``mla_attention``: a latent KV cache, absorbed decode)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist.group_ops import all_gather, all_reduce, group_size
from ..dist.sharding import NO_SHARDING, ShardingRules

NEG_INF = float(np.finfo(np.float32).min)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights times ``scale`` (default ``1/sqrt(fan_in)``), drawn
    from ``gen`` on the generator's device. The numbers differ from the
    reference's ``jax.random`` ones; the distribution is the same."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (population variance), returned
    in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = ((x - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32)
           + beta.to(torch.float32))
    return out.to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in f32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * gamma.to(torch.float32)).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (nemotron)."""
    return torch.square(torch.relu(x))


def act_fn(name: str):
    return {"relu": torch.relu, "gelu": gelu, "silu": F.silu, "relu2": _relu2}[name]


def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The rotation
    in f32 on the halves of D, the result in ``x``'s dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks inside a loop over Q chunks,
    the reference's ``chunked_attention``: f32 scores scaled by
    ``1/sqrt(D)``, masked scores at the f32 minimum, GQA, the output in q's
    dtype. Differentiable; each Q chunk's body is recomputed in the
    backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so no (q_chunk, k_chunk) score block is kept.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D). On the meta device (the dry run, which counts
    a step's collectives) the whole sequence is one chunk: nothing is
    computed there, and chunks would only repeat the bookkeeping.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if q.device.type == "meta":
        q_chunk, k_chunk = max(Sq, 8), max(Sk, 8)
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    orig_Sq, orig_Sk = Sq, Sk
    q_chunk = min(q_chunk, max(Sq, 8))
    k_chunk = min(k_chunk, max(Sk, 8))
    if Sq % q_chunk:
        q = F.pad(q, (0, 0, 0, 0, 0, q_chunk - Sq % q_chunk))
        Sq = q.shape[1]
    if Sk % k_chunk:
        pad = (0, 0, 0, 0, 0, k_chunk - Sk % k_chunk)
        k, v = F.pad(k, pad), F.pad(v, pad)
        Sk = k.shape[1]
    nq, nk = Sq // q_chunk, Sk // k_chunk
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def q_body(qc, qi):
        qg = qc.reshape(B, q_chunk, Hkv, G, D).to(torch.float32)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, D), device=q.device)
        for ki in range(nk):
            kc = kf[:, ki * k_chunk:(ki + 1) * k_chunk]
            vc = vf[:, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc) * scale
            kpos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            if orig_Sk != Sk:  # zero-padded keys must not enter the softmax
                s = torch.where(kpos < orig_Sk, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)   # (B,Hkv,G,qc,D)
        return out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, D).to(q.dtype)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(q_body, qc, qi, use_reentrant=False))
        else:
            outs.append(q_body(qc, qi))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out[:, :orig_Sq]


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single(-few)-token decode attention against a KV cache, the
    reference's arithmetic: the cache cast to f32, scores scaled by
    ``1/sqrt(D)``, positions at or past ``cache_len`` at the f32 minimum, a
    softmax over the whole cache.

    q: (B, Tq, Hq, D); caches: (B, Smax, Hkv, D); cache_len: an int, () or
    (B,) — the number of valid cache positions. Returns (B, Tq, Hq, D) in
    q's dtype."""
    B, Tq, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Tq, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.to(torch.float32)) * scale
    pos = torch.arange(Smax, device=q.device)
    valid = pos[None, :] < torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v_cache.to(torch.float32))
    return out.reshape(B, Tq, Hq, D).to(q.dtype)


# ------------------------------------------------------------------- MoE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    gated: bool = True  # SwiGLU experts
    capacity_factor: float = 2.0  # expert-parallel dispatch buffer (φ)
    dispatch: str = "auto"        # auto | dense | ep (expert-parallel over a mesh)


def moe_params_init(gen: torch.Generator, d_model: int,
                    cfg: MoEConfig) -> Dict[str, torch.Tensor]:
    E, F_ = cfg.n_experts, cfg.d_ff
    p = dict(router=dense_init(gen, (d_model, E)),
             w_up=dense_init(gen, (E, d_model, F_)),
             w_down=dense_init(gen, (E, F_, d_model), scale=1.0 / np.sqrt(F_)))
    if cfg.gated:
        p["w_gate"] = dense_init(gen, (E, d_model, F_))
    return p


def _grouped_dot(a: torch.Tensor, w: torch.Tensor, sizes, compute_dtype) -> torch.Tensor:
    """The reference's ``_ragged_dot_f32``: rows of ``a`` (m, K) in
    consecutive groups of ``sizes`` (one a expert), group e times ``w[e]``
    (E, K, N), operands rounded to ``compute_dtype`` and products summed in
    f32 → (m, N) f32. One product a non-empty group, on f32 copies of the
    rounded operands (the products of bf16 values are exact in f32), so
    the result is not rounded to the compute dtype as a bf16 matmul's
    would be. XLA computes the reference's; it has no Pallas kernel."""
    a = a.to(compute_dtype).to(torch.float32)
    # unbind and split: one stack and one cat in the backward, not a
    # full-sized zero gradient a group
    ws = w.to(compute_dtype).to(torch.float32).unbind(0)
    outs = [part @ ws[e] for e, part in enumerate(a.split(sizes)) if sizes[e]]
    if not outs:
        return a.new_zeros((0, w.shape[-1]))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _moe_local(xf, ids, weights, w_up, w_gate, w_down, act, compute_dtype):
    """Grouped-product MoE on the local tokens: the (token, slot) pairs
    sorted by expert (stable, as ``jnp.argsort``), one product a group, no
    capacity and no drops. The combine adds each token's k weighted
    outputs in the sorted order — by expert, as the reference's
    ``.at[tok].add`` does — through the inverse permutation: a gather and
    k - 1 adds, no atomics."""
    n, d = xf.shape
    k = ids.shape[-1]
    E = w_up.shape[0]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = torch.div(order, k, rounding_mode="floor")
    xs = xf[tok].to(compute_dtype)
    sizes = torch.bincount(flat, minlength=E).tolist()
    h = _grouped_dot(xs, w_up, sizes, compute_dtype)
    if w_gate is not None:
        h = act(_grouped_dot(xs, w_gate, sizes, compute_dtype)) * h
    else:
        h = act(h)
    y = _grouped_dot(h.to(compute_dtype), w_down, sizes, compute_dtype)
    wsort = weights.reshape(-1)[order].to(torch.float32)
    contrib = y * wsort[:, None]
    # pair (token i, slot j) sits at sorted position inv[i*k + j]; a token's
    # positions ascending are the reference's order of adds
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(inv.reshape(n, k), dim=-1).values
    out = contrib[pos[:, 0]]
    for j in range(1, k):
        out = out + contrib[pos[:, j]]
    return out


def _moe_router(xf, router, top_k):
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return probs, weights, ids


def _moe_aux_loss(probs, ids, n_experts):
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(ids[:, 0], n_experts).to(torch.float32), dim=0)
    return n_experts * torch.sum(me * ce)


def _moe_ep_cell(x_l, router, w_up, w_gate, w_down, *, cfg: MoEConfig, act,
                 compute_dtype, j: int):
    """The reference's per-(data, model)-cell expert-parallel MoE on this
    rank's tokens ``x_l`` (n_l, d) and its ``model`` index ``j``'s experts
    (``w_up`` and ``w_gate`` (E_l, d, F), ``w_down`` (E_l, F, d)):
    route every token, then for each local expert gather up to capacity C
    of the tokens routed to it, first come in token order, run plain
    products in ``compute_dtype``, and add the gated outputs back. Tokens
    past C are dropped (GShard-style capacity φ = cfg.capacity_factor).
    → (this rank's partial output (n_l, d) f32, touched (E,) f32 of its
    tokens, its aux loss), before any reduction."""
    n_l, d = x_l.shape
    e_local = w_up.shape[0]
    probs, weights, ids = _moe_router(x_l, router, cfg.top_k)
    cap = max(int(cfg.capacity_factor * n_l * cfg.top_k / cfg.n_experts), 8)
    cap = min(cap, n_l)
    out = x_l.new_zeros((n_l, d), dtype=torch.float32)
    with torch.no_grad():
        touched = torch.zeros((cfg.n_experts,), dtype=torch.float32, device=x_l.device)
        touched[ids.reshape(-1)] = 1.0

    cd = compute_dtype
    xc = x_l.to(cd)
    order = torch.arange(n_l, device=x_l.device)
    for el in range(e_local):
        mask = ids == j * e_local + el
        gate = torch.sum(weights * mask, dim=-1)          # (n_l,)
        sel = torch.any(mask, dim=-1)
        # deterministic first-come capacity: tokens in sequence order
        prio = torch.where(sel, order, n_l + order)
        idx = torch.argsort(prio)[:cap]
        valid = sel[idx]
        xs = xc[idx]                                      # (C, d)
        h = xs @ w_up[el].to(cd)
        if w_gate is not None:
            h = act(xs @ w_gate[el].to(cd)).to(cd) * h
        else:
            h = act(h).to(cd)
        ys = (h @ w_down[el].to(cd)).to(torch.float32)
        scale = (gate[idx] * valid)[:, None]
        out = out.index_add(0, idx, ys * scale)
    return out, touched, _moe_aux_loss(probs, ids, cfg.n_experts)


def _gather_d(w: torch.Tensor, axis: int, group, compute_dtype) -> torch.Tensor:
    """``w``'s d_model shard all-gathered over ``group`` along ``axis``,
    cast to ``compute_dtype`` before the gather: the gathered copy is
    transient compute input, so it travels at the compute width. The
    backward reduce-scatters the cotangent (``dist.group_ops``)."""
    return all_gather(w.to(compute_dtype), group, dim=axis)


def _moe_ep(x, params, cfg: MoEConfig, act, compute_dtype, rules: ShardingRules,
            combine: Optional[Callable] = None):
    """Expert parallelism across the ranks of ``rules.mesh``. ``x`` is this
    rank's shard of the tokens along the rules' batch axes; activations
    are the same on every ``model`` rank of one batch shard, so no token
    moves between ranks: the rank of ``model`` index j owns experts
    j·E_l … (j+1)·E_l − 1 (E_l = E / model), runs them on its tokens
    (``_moe_ep_cell``), and the partial outputs are summed over the
    ``model`` subgroup; the touched masks are summed, and the aux losses
    averaged, over ``model`` and the batch axes. ``params`` hold the
    router whole and this rank's E_l experts, as the reference's
    ``shard_map`` cell receives them; under rules that shard ``d_model``
    (pure FSDP) they hold this rank's d_model shard of those experts,
    gathered in ``compute_dtype`` before use.

    Gradients. The sums are differentiable: the backward of each is the
    same sum of the cotangents. The loss meant is the mean of the ranks'
    losses (a rank's loss is its batch shard's mean plus the aux term, so
    the ``model`` ranks of a shard compute equal ones). Its gradient with
    respect to a parameter is the sum of that parameter's gradient over
    the ranks that hold a copy of it, divided by the world size: for a
    parameter every rank holds (the router, everything outside the MoE)
    the mean over all ranks; for expert j's weights the sum over the
    batch axes' ranks of ``model`` index j, over the world size. The
    collectives are ``dist.group_ops``', so a recording mesh counts them.

    ``combine`` (the tensor-parallel train step's, ``dist.tensor_parallel``)
    sums the partial outputs over ``model`` in its place, in ``x``'s dtype:
    a reduce-scatter back to the rank's sequence slice, or an all-reduce
    whose backward passes the cotangent through. The loss meant is then
    one global loss that every rank holds: the aux losses' sum passes its
    cotangent through too, and a parameter's gradient on a rank is its
    part of the global one (``configs._families.lm_grad_axes``)."""
    mesh = rules.mesh
    if mesh is None or not getattr(mesh, "has_group", False):
        raise ValueError(
            "expert-parallel MoE dispatch ('ep') runs across the ranks of a mesh "
            "that carries a torch.distributed group (launch.mesh.make_host_mesh); "
            f"these rules' mesh is {mesh!r}. Use dispatch 'dense' on one process")
    if "model" not in mesh.shape:
        raise ValueError(f"expert-parallel MoE needs a 'model' axis; mesh {mesh!r}")
    model_n = mesh.shape["model"]
    E = cfg.n_experts
    if E % model_n:
        raise ValueError(f"{E} experts do not split over model = {model_n}")
    e_local = E // model_n
    j = mesh.axis_index("model")
    B, S, d = x.shape

    for name in ("w_up", "w_gate", "w_down") if cfg.gated else ("w_up", "w_down"):
        if params[name].shape[0] != e_local:
            raise ValueError(f"{name} holds {params[name].shape[0]} experts: this rank "
                             f"owns {e_local} of {E} (model index {j})")
    w_up, w_down, w_gate = params["w_up"], params["w_down"], params.get("w_gate")
    fsdp_axes = rules.axes_for("d_model", d) or ()
    if fsdp_axes:
        g = mesh.group_for(fsdp_axes)
        w_up = _gather_d(w_up, 1, g, compute_dtype)
        w_down = _gather_d(w_down, 2, g, compute_dtype)
        if w_gate is not None:
            w_gate = _gather_d(w_gate, 1, g, compute_dtype)

    out, touched, aux = _moe_ep_cell(x.reshape(-1, d), params["router"], w_up, w_gate,
                                     w_down, cfg=cfg, act=act,
                                     compute_dtype=compute_dtype, j=j)
    batch_axes = tuple(a for a in (rules.axes_for("batch") or ()) if a != "model")
    reduce_group = mesh.group_for(("model",) + batch_axes)
    if combine is not None:
        out = combine(out.reshape(B, S, d).to(x.dtype))
        touched = all_reduce(touched, reduce_group)
        aux = all_reduce(aux, reduce_group, backward="identity") / group_size(reduce_group)
        return out, touched > 0, aux
    out = all_reduce(out, mesh.group_for(("model",)))
    touched = all_reduce(touched, reduce_group)
    aux = all_reduce(aux, reduce_group) / group_size(reduce_group)
    return out.reshape(B, S, d).to(x.dtype), touched > 0, aux


def moe_dispatch(cfg: MoEConfig, rules: ShardingRules) -> str:
    """The dispatch ``moe_ffn`` takes: ``cfg.dispatch``, with ``auto``
    resolved to ``ep`` under a mesh whose ``model`` axis is wider than 1
    and divides the experts, to ``dense`` otherwise."""
    dispatch = cfg.dispatch
    if dispatch not in ("auto", "dense", "ep"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    mesh = rules.mesh
    model_n = mesh.shape.get("model", 1) if mesh is not None else 1
    if dispatch == "auto":
        dispatch = ("ep" if mesh is not None and model_n > 1
                    and cfg.n_experts % model_n == 0 else "dense")
    return dispatch


def moe_ffn(x, params, cfg: MoEConfig, *, act: Callable = F.silu,
            compute_dtype=torch.bfloat16, rules: ShardingRules = NO_SHARDING, tp=None):
    """Mixture-of-experts FFN → (output, expert-touched mask (E,), aux loss).

    Two dispatch paths, as the reference's:
      * ``dense`` — the only one without a mesh: router logits and softmax
        in f32, top-k, the weights renormalized; the three grouped
        products with operands in ``compute_dtype`` and f32 results;
        ``act(gate) * up`` in f32, cast to ``compute_dtype`` before the
        down product; the combine in f32, the output cast to ``x``'s dtype.
        Exact, no drops.
      * ``ep`` — expert parallelism across the ranks of ``rules.mesh``
        (``_moe_ep``): capacity-bounded local dispatch, no token exchange,
        a sum over the ``model`` ranks. It needs a mesh that carries a
        process group and raises without one; it never falls back to
        ``dense``.
    ``auto`` takes ``ep`` under a mesh whose ``model`` axis is wider than 1
    and divides the experts, ``dense`` otherwise.

    The touched mask feeds Check-N-Run's tracker: with top-k routing only
    the routed experts change in an interval, so expert blocks checkpoint
    incrementally like embedding rows.

    ``tp`` (``dist.tensor_parallel``, a rank of the tensor-parallel train
    step): ``x`` is the residual's layout there. ``ep`` takes the rank's
    data shard whole (``tp.enter``) and leaves through ``tp.leave``;
    ``dense`` (experts that do not split over ``model``) runs on the
    rank's own tokens, its touched masks summed and its aux losses
    averaged over the ranks that hold other tokens."""
    B, S, d = x.shape
    dispatch = moe_dispatch(cfg, rules)
    if dispatch == "ep" and tp is not None:
        return _moe_ep(tp.enter(x), params, cfg, act, compute_dtype, rules, combine=tp.leave)
    if dispatch == "ep":
        return _moe_ep(x, params, cfg, act, compute_dtype, rules)
    xf = x.reshape(-1, d)
    probs, weights, ids = _moe_router(xf, params["router"], cfg.top_k)
    out = _moe_local(xf, ids, weights, params["w_up"], params.get("w_gate"),
                     params["w_down"], act, compute_dtype)
    with torch.no_grad():
        touched = torch.zeros((cfg.n_experts,), dtype=torch.bool, device=x.device)
        touched[ids.reshape(-1)] = True
    aux_loss = _moe_aux_loss(probs, ids, cfg.n_experts)
    if tp is not None:
        group = tp.world if tp.sp else tp.data
        touched = all_reduce(touched.to(torch.float32), group) > 0
        aux_loss = tp.sum_over(aux_loss, spread=tp.sp) / group_size(group)
    return out.reshape(B, S, d).to(x.dtype), touched, aux_loss


# ------------------------------------------------------------------- MLA


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


def mla_params_init(gen: torch.Generator, d_model: int, n_heads: int,
                    cfg: MLAConfig) -> Dict[str, torch.Tensor]:
    H = n_heads
    dev = gen.device
    return dict(
        w_dq=dense_init(gen, (d_model, cfg.q_lora_rank)),
        q_norm=torch.ones((cfg.q_lora_rank,), device=dev),
        w_uq=dense_init(gen, (cfg.q_lora_rank, H, cfg.qk_nope_dim + cfg.qk_rope_dim)),
        w_dkv=dense_init(gen, (d_model, cfg.kv_lora_rank)),
        kv_norm=torch.ones((cfg.kv_lora_rank,), device=dev),
        w_kpe=dense_init(gen, (d_model, cfg.qk_rope_dim)),
        w_uk=dense_init(gen, (cfg.kv_lora_rank, H, cfg.qk_nope_dim)),
        w_uv=dense_init(gen, (cfg.kv_lora_rank, H, cfg.v_head_dim)),
        w_o=dense_init(gen, (H, cfg.v_head_dim, d_model)),
    )


def mla_attention(x, params, cfg: MLAConfig, n_heads: int, positions, *,
                  causal: bool = True, compute_dtype=torch.bfloat16,
                  cache: Optional[Dict[str, torch.Tensor]] = None, cache_len=None,
                  attention: Callable = chunked_attention, tp=None):
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3) → (y, cache).

    Caches only the kv latent (``ckv``, kv_lora_rank wide) and the shared
    rope key (``kpe``). Without a cache (training, prefill) k_nope and v
    are expanded per head, the rope key broadcast to every head, v padded
    to the qk head dim, and the heads go through ``attention``
    (``chunked_attention``, or the flash kernel at prefill); the output is
    sliced back to v's head dim. With a cache (decode) the new latents are
    written into it in place at ``cache_len`` and the scores and values are
    taken against the latents directly (W_uk absorbed into q, W_uv applied
    after), in f32 with the f32 minimum past the valid length.

    ``tp`` (a rank of the tensor-parallel train step,
    ``dist.tensor_parallel``): ``x`` is the residual's layout there. Where
    the heads shard, the latent projections (``w_dq``, ``q_norm``,
    ``w_dkv``, ``kv_norm``, ``w_kpe``, replicated) run on the data shard's
    whole sequence, the rank's heads of ``w_uq``, ``w_uk`` and ``w_uv``
    expand them, and ``w_o`` is row-parallel; where they do not, every
    rank attends with every head and keeps its own query positions."""
    if tp is not None:
        return _mla_tp(x, params, cfg, positions, compute_dtype, causal, tp), None
    B, S, d = x.shape
    cd = compute_dtype
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope, ckv_new, kpe_new = mla_project(x, params, cfg, positions, cd)

    if cache is not None:
        # in place: the values of the reference's dynamic_update_slice
        cache["ckv"][:, cache_len:cache_len + S] = ckv_new.to(cache["ckv"].dtype)
        cache["kpe"][:, cache_len:cache_len + S] = kpe_new.to(cache["kpe"].dtype)
        ckv, kpe = cache["ckv"], cache["kpe"]
        Smax = ckv.shape[1]
        scale = 1.0 / np.sqrt(nope + rope)
        q_abs = torch.einsum("bthd,rhd->bthr", q_nope, params["w_uk"].to(cd))
        ckv32 = ckv.to(torch.float32)
        s = (torch.einsum("bthr,bsr->bhts", q_abs.to(torch.float32), ckv32)
             + torch.einsum("bthd,bsd->bhts", q_rope.to(torch.float32),
                            kpe.to(torch.float32))) * scale
        pos = torch.arange(Smax, device=x.device)
        valid = pos[None, :] < torch.as_tensor(cache_len + S, device=x.device).reshape(-1, 1)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out_lat = torch.einsum("bhts,bsr->bthr", p, ckv32)
        out = torch.einsum("bthr,rhd->bthd", out_lat.to(cd), params["w_uv"].to(cd))
        new_cache = cache
    else:
        new_cache = dict(ckv=ckv_new, kpe=kpe_new)
        qfull, kfull, vpad = mla_expand(q_nope, q_rope, ckv_new, kpe_new, params, n_heads, cd)
        out = attention(qfull, kfull, vpad, causal=causal)[..., :cfg.v_head_dim]
    y = torch.einsum("bshd,hdm->bsm", out.to(cd), params["w_o"].to(cd))
    return y.to(x.dtype), new_cache


def _mla_tp(x, params, cfg: MLAConfig, positions, compute_dtype, causal, tp):
    cd = compute_dtype
    xf = tp.enter(x) if tp.heads else tp.whole(x)
    q_nope, q_rope, ckv, kpe = mla_project(xf, params, cfg, positions, cd)
    qfull, kfull, vpad = mla_expand(q_nope, q_rope, ckv, kpe, params,
                                    params["w_uk"].shape[1], cd)
    out = chunked_attention(qfull, kfull, vpad, causal=causal)[..., :cfg.v_head_dim]
    if not tp.heads:
        out = tp.own(out)
    y = torch.einsum("bshd,hdm->bsm", out.to(cd), params["w_o"].to(cd))
    return (tp.leave(y) if tp.heads else y).to(x.dtype)


def mla_project(x, params, cfg: MLAConfig, positions, compute_dtype):
    """MLA's projections of a normed input (B, S, d) → (q_nope, q_rope
    (B, S, H, nope / rope), the kv latent ``ckv`` (B, S, r), the rope key
    ``kpe`` (B, S, rope)), in ``compute_dtype``, q_rope and kpe rotated."""
    cd = compute_dtype
    xc = x.to(cd)
    cq = rmsnorm(xc @ params["w_dq"].to(cd), params["q_norm"])
    q = torch.einsum("bsr,rhd->bshd", cq, params["w_uq"].to(cd))
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions)
    ckv = rmsnorm(xc @ params["w_dkv"].to(cd), params["kv_norm"])
    kpe = apply_rope((xc @ params["w_kpe"].to(cd))[:, :, None, :], positions)[:, :, 0, :]
    return q_nope, q_rope, ckv, kpe


def mla_expand(q_nope, q_rope, ckv, kpe, params, n_heads: int, compute_dtype):
    """Prefill's per-head attention inputs from MLA's projections: q
    (B, S, H, nope + rope), k with k_nope expanded from the latent and the
    rope key broadcast to every head, v expanded and zero-padded to the qk
    head dim (one head dim for the attention kernel)."""
    cd = compute_dtype
    B, S, rope = kpe.shape
    k_nope = torch.einsum("bsr,rhd->bshd", ckv.to(cd), params["w_uk"].to(cd))
    v = torch.einsum("bsr,rhd->bshd", ckv.to(cd), params["w_uv"].to(cd))
    k_rope = kpe[:, :, None, :].to(cd).expand(B, S, n_heads, rope)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    kfull = torch.cat([k_nope, k_rope], dim=-1)
    return qfull, kfull, v_pad_to(v, kfull.shape[-1])


def v_pad_to(v: torch.Tensor, d: int) -> torch.Tensor:
    """``v`` zero-padded along its last axis to ``d``."""
    if v.shape[-1] == d:
        return v
    return F.pad(v, (0, d - v.shape[-1]))
