"""Per-layer blocks: GQA attention (with qwen3's qk_norm, RoPE or
Qwen2-VL's M-RoPE, local attention over a sliding window, and enc-dec
cross-attention over precomputed K/V), deepseek-v2's MLA (low-rank
compressed KV), the SwiGLU / GeGLU FFN, the MoE block
(top-k routing, per-row capacity, shared experts), RWKV6's time mix (wkv)
and channel mix, and recurrentgemma's RG-LRU block.

Every ``*_init`` builds the params of all layers at once, stacked on a
leading ``layers`` dim (``lead``), with the JAX reference's names and
layouts, each leaf of rank >= 2 drawn in ``dtype`` (fp32 by default) and
the others in fp32 (``common.param_dtype``). Every ``*_apply`` takes one
layer's params. ``attn_apply`` and ``mla_apply`` handle both full-sequence
(prefill) and single-token decode (``cache`` + ``pos``) modes, ``rwkv_apply`` and
``rglru_apply`` full-sequence and single-token decode (``state``).
Products whose operands differ in type go through ``common.einsum``, which
promotes as the reference's ``jnp.einsum`` does.

Every ``*_axes`` gives one layer's logical axes as the reference's init
returns them. Under ``sharding.use_rules`` over a mesh (DTensors), the
reference's ``constrain`` points redistribute, weight products take
``sharding.sharded_einsum`` (through ``common.einsum``) or, for the head
projections and the unembedding, ``project``, and every kernel call
(flash, dispatch and combine, both scans) runs on each rank's shard
through ``sharding.local_call``: ``attend``, ``_moe_shuffle``, ``_wkv``
and the RG-LRU scan. Without a mesh each of these is the plain call.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from ..kernels.linear_scan.ops import diag_scan, gla_scan
from ..kernels.shuffle_dispatch.ops import combine, compute_slots, dispatch
from ..sharding import (constrain, constrain_seq, coordinate, is_sharded,
                        local_call, local_placements, partial_on,
                        sharded_axes)
from .. import trace
from .common import (_const, apply_mrope, apply_rope, dense_init, einsum,
                     gelu, gen_device, layer_norm, normal, param_dtype,
                     rms_norm, sigmoid, silu, softplus, yarn_freqs,
                     yarn_mscale)


def _ones(gen: torch.Generator, shape, dtype=None) -> torch.Tensor:
    return torch.ones(shape, dtype=param_dtype(shape, dtype),
                      device=gen_device(gen))


def _zeros(gen: torch.Generator, shape, dtype=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=param_dtype(shape, dtype),
                       device=gen_device(gen))


def _normal(gen: torch.Generator, shape, scale: float,
            dtype=None) -> torch.Tensor:
    """N(0, scale^2) drawn in ``param_dtype(shape, dtype)``."""
    return normal(gen, shape, param_dtype(shape, dtype)).mul_(scale)


def _norm_init(cfg: ArchConfig, d: int, gen: torch.Generator,
               lead: Tuple[int, ...] = (), dtype=None
               ) -> Optional[torch.Tensor]:
    if cfg.norm == "nonparam_ln":
        return None
    return _ones(gen, (*lead, d), dtype)


def _norm_axes(cfg: ArchConfig):
    return None if cfg.norm == "nonparam_ln" else ("embed_vec",)


def apply_norm(cfg: ArchConfig, w, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, w)
    if cfg.norm == "layernorm":
        return layer_norm(x, w)
    if cfg.norm == "nonparam_ln":
        return layer_norm(x, None)
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# GQA attention (dense / qwen3 qk_norm / mrope / cross-attention)
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ArchConfig,
              lead: Tuple[int, ...] = (), dtype=None) -> Dict:
    """``dtype``: the type of the leaves of rank >= 2 (fp32 if None)."""
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    wt = dtype or torch.float32
    p = {
        "wq": dense_init(gen, d, (H, hd), lead=lead, dtype=wt),
        "wk": dense_init(gen, d, (KH, hd), lead=lead, dtype=wt),
        "wv": dense_init(gen, d, (KH, hd), lead=lead, dtype=wt),
        "wo": _normal(gen, (*lead, H, hd, d), 1.0 / math.sqrt(H * hd), wt),
        "norm": _norm_init(cfg, d, gen, lead, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones(gen, (*lead, hd), dtype)
        p["k_norm"] = _ones(gen, (*lead, hd), dtype)
    return p


def attn_axes(cfg: ArchConfig) -> Dict:
    """One layer's logical axes, leaf for leaf as the reference's
    ``attn_init`` returns them."""
    a = {"wq": ("embed", "heads", None), "wk": ("embed", "kv", None),
         "wv": ("embed", "kv", None), "wo": ("heads", None, "embed"),
         "norm": _norm_axes(cfg)}
    if cfg.qk_norm:
        a["q_norm"] = a["k_norm"] = (None,)
    return a


def project(h, w, eq: str, axis: str):
    """``einsum(eq, h, w)`` of activations h [B, T, d] and a weight w [d,
    n, ...] whose dim 1 has the logical axis ``axis`` (the heads of q, k
    and v; the vocabulary of the unembedding). Under a mesh, a
    column-parallel product through ``local_call``: h with its batch on
    "batch" and d whole, w with d whole and dim 1 on ``axis`` where it
    divides, the output's batch and dim 2 sharded alike. DTensor's own
    choice for these products may shard the flattened heads over more
    ranks than there are heads (glm4-9b's 2 kv heads over 4 "model"
    ranks), which it then cannot split, or take the unembedding's
    gradient over the whole vocabulary on every rank."""
    if not is_sharded(h):
        return einsum(eq, h, w)
    B, T, _ = h.shape
    hp = local_placements(("batch", None, None), h.shape)
    wp = local_placements((None, axis) + (None,) * (w.dim() - 2), w.shape)
    op = local_placements(("batch", None, axis) + (None,) * (w.dim() - 2),
                          (B, T) + tuple(w.shape[1:]))
    # each rank's dh covers its part of dim 1 only, its dw its batch rows
    grads = (partial_on(hp, sharded_axes(wp, 1)),
             partial_on(wp, sharded_axes(hp, 0)))
    return local_call(lambda a, b: einsum(eq, a, b), (h, w), (hp, wp), op,
                      grads)


def embed(table, ids):
    """``table[ids]``. Under a mesh, through ``local_call``: the ids on
    their "batch" axes, the table's rows on "vocab" where it divides; each
    rank looks up the ids in its own rows (zeros for the others') and the
    ranks' rows sum, a partial sum over the vocabulary's axes. DTensor's
    own strategy for the lookup's backward (``index_put``) fails in some
    versions (2.11)."""
    if not is_sharded(table):
        return table[ids]
    V, d = table.shape
    tp = local_placements(("vocab", None), table.shape)
    ip = local_placements(("batch", None), ids.shape)
    vocab = sharded_axes(tp, 0)
    out = partial_on(local_placements(("batch", None, None),
                                      (*ids.shape, d)), vocab)

    def run(t, i):
        if not vocab:
            return t[i]
        (axis,) = vocab
        n = t.shape[0]
        j = i - coordinate(axis) * n
        hit = (j >= 0) & (j < n)
        return t[j.clamp(0, n - 1)] * hit[..., None].to(t.dtype)
    # each rank's rows get the gradient of its batch shard only
    return local_call(run, (table, ids), (tp, ip), out,
                      (partial_on(tp, sharded_axes(ip, 0)), ip))


def _rope(cfg: ArchConfig, x, positions):
    """RoPE (positions [..., T]) or M-RoPE (positions [B, 3, T]) of x [B, T,
    H, hd] as ``cfg.rope`` says; x as it is for "none"."""
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, theta=cfg.rope_theta)
    if cfg.rope != "none":
        raise ValueError(f"unknown rope {cfg.rope!r}")
    return x


def _rope_qk(cfg: ArchConfig, q, k, positions):
    return _rope(cfg, q, positions), _rope(cfg, k, positions)


def attn_apply(p, x, *, cfg: ArchConfig, positions, causal: bool = True,
               cache: Optional[Dict] = None, pos: Optional[int] = None,
               attn_impl: str = "kernel",
               kv_memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """x: [B, T, d]. Full mode when cache is None; decode otherwise.

    In decode mode the new k/v are written into ``cache`` in place (the
    reference returns an updated copy); the returned cache is the same
    dict. ``kv_memory``: precomputed head-major (k, v) [B, KH, S, hd] for
    cross-attention (enc-dec): no k/v projection, no rope, no mask, and
    the plain ``attention_ref``, as the reference runs it."""
    x = constrain_seq(x)  # seq-parallel residual stream (fsdp_tp_sp only)
    h = apply_norm(cfg, p.get("norm"), x)
    q = project(h, p["wq"], "btd,dhk->bthk", "heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if kv_memory is not None:
        qh = q.transpose(1, 2)
        kh, vh = kv_memory
        o = attend(attention_ref, qh, kh.to(qh.dtype), vh.to(qh.dtype),
                   causal=False)
        y = einsum("bthk,hkd->btd", o.transpose(1, 2), p["wo"])
        return x + y, None
    k = project(h, p["wk"], "btd,dhk->bthk", "kv")
    v = project(h, p["wv"], "btd,dhk->bthk", "kv")
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    q, k = _rope_qk(cfg, q, k, positions)
    qh = q.transpose(1, 2)                      # [B, H, T, hd]
    kh = k.transpose(1, 2)                      # [B, KH, Tk, hd]
    vh = v.transpose(1, 2)
    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]          # [B, KH, Tmax, hd]
        T, Tmax = kh.shape[2], ck.shape[2]
        new_cache = cache
        if cfg.window is not None and Tmax == cfg.window:
            o = _window_ring_decode(cfg, qh, kh, vh, ck, cv, int(pos))
        else:
            start = min(max(int(pos), 0), Tmax - T)  # dynamic_update_slice
            ck[:, :, start:start + T] = kh.to(ck.dtype)
            cv[:, :, start:start + T] = vh.to(cv.dtype)
            o = attend(attention_ref, qh, ck.to(qh.dtype), cv.to(qh.dtype),
                       causal=True, window=cfg.window, q_offset=int(pos))
    else:
        # the kernel takes contiguous head-major tensors
        o = attend(flash_attention, qh.contiguous(), kh.contiguous(),
                   vh.contiguous(), causal=causal, window=cfg.window,
                   impl=attn_impl, block_k=cfg.attn_block_k,
                   p_bf16=cfg.attn_p_bf16)
    o = o.transpose(1, 2)                        # [B, T, H, hd]
    y = einsum("bthk,hkd->btd", o, p["wo"])
    return x + y, new_cache


def attend(fn, qh, kh, vh, *, kv_axis: str = "kv", **kw):
    """``fn`` (``flash_attention`` or ``attention_ref``) of head-major q
    [B, H, Tq, D] and k/v [B, KH, Tk, *]. Under a mesh, through
    ``local_call``: the batch on its "batch" axes and the heads on
    "heads" (k/v on ``kv_axis``) where they divide, each rank's kernel on
    its shard (a sequence-sharded k/v, a decode cache on "kv_seq", is
    gathered first). Where q's heads are sharded and k/v's are not (GQA
    with fewer kv heads than the "model" axis), each rank takes the kv
    heads of its own q heads by their global index, and k/v's gradient is
    summed over the axis."""
    if not is_sharded(qh):
        return fn(qh, kh, vh, **kw)

    def run(q, k, v):
        # the kernel takes contiguous tensors
        return fn(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    qp = local_placements(("batch", "heads", None, None), qh.shape)
    kvp = local_placements(("batch", kv_axis, None, None), kh.shape)
    h_axes, kv_axes = sharded_axes(qp, 1), sharded_axes(kvp, 1)
    if h_axes == kv_axes:
        return local_call(run, (qh, kh, vh), (qp, kvp, kvp), qp)
    # q's heads on one mesh axis, k/v's whole on every rank
    (axis,) = h_axes
    H, KH = qh.shape[1], kh.shape[1]
    group, r = H // KH, coordinate(axis)

    def run_group(q, k, v):
        # the kv head of each local q head (there are fewer kv heads than
        # ranks on the axis, so no rank holds a whole group of q heads)
        hl = q.shape[1]
        idx = torch.arange(r * hl, (r + 1) * hl, device=q.device) // group
        return run(q, k.index_select(1, idx), v.index_select(1, idx))
    kvg = partial_on(kvp, h_axes)
    return local_call(run_group, (qh, kh, vh), (qp, kvp, kvp), qp,
                      (qp, kvg, kvg))


def _window_ring_decode(cfg: ArchConfig, qh, kh, vh, ck, cv, pos: int):
    """O(window) decode (T = 1) over a ring-buffer cache of ``window`` slots:
    slot i holds absolute position pos - ((pos - i) mod W). The new k/v go
    into slot pos mod W in place. Scores, softmax and the weighted sum run
    in fp32 with GQA as a grouped einsum, as in the reference."""
    W = cfg.window
    slot = pos % W
    ck[:, :, slot] = kh[:, :, 0].to(ck.dtype)
    cv[:, :, slot] = vh[:, :, 0].to(cv.dtype)
    B, H, Tq, D = qh.shape
    KH = ck.shape[1]
    qg = qh.reshape(B, KH, H // KH, Tq, D).float()
    s = einsum("bkgqd,bktd->bkgqt", qg, ck.float()) * D ** -0.5
    idx = torch.arange(W, device=qh.device)
    valid = pos - torch.remainder(pos - idx, W) >= 0
    s = s.masked_fill(~valid, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = einsum("bkgqt,bktd->bkgqd", p, cv.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return o.reshape(B, H, Tq, D).to(qh.dtype)


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.kv_heads, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill_kv(p, x, *, cfg: ArchConfig, positions):
    """This layer's k/v for a prompt (to seed the decode cache), head-major
    [B, KH, T, hd]."""
    h = apply_norm(cfg, p.get("norm"), x)
    k = project(h, p["wk"], "btd,dhk->bthk", "kv")
    v = project(h, p["wv"], "btd,dhk->bthk", "kv")
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    k = _rope(cfg, k, positions)
    return k.transpose(1, 2), v.transpose(1, 2)


def pack_prefill_cache(cfg: ArchConfig, kv, max_len: int, dtype):
    """Arrange prompt k/v [B, KH, T, hd] into a decode cache.

    Sliding-window archs get a ring buffer of ``window`` slots when the
    prompt is at least that long (slot i holds absolute position
    T-1-((T-1-i) mod W)); otherwise a dense cache of min(max_len, window or
    inf) slots, zero-padded or cut."""
    k, v = kv
    T = k.shape[2]
    W = cfg.window
    cache_len = min(max_len, W) if W else max_len
    if W and cache_len == W and T >= W:
        idx = torch.arange(W, device=k.device)
        abs_idx = (T - 1) - torch.remainder((T - 1) - idx, W)
        return {"k": k[:, :, abs_idx].to(dtype),
                "v": v[:, :, abs_idx].to(dtype)}
    pad = cache_len - T
    if pad > 0:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    elif pad < 0:
        k, v = k[:, :, :cache_len], v[:, :, :cache_len]
    return {"k": k.to(dtype), "v": v.to(dtype)}


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2): low-rank compressed KV
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = (), dtype=None) -> Dict:
    """The reference's params and layouts: wq [d, H, nope + rope] (with
    ``q_lora``: the query's down projection w_dq [d, q_lora], its norm
    q_norm [q_lora] and up projection w_uq [q_lora, H, nope + rope]
    instead), the latent's down projection w_dkv [d, kv_lora] and its norm
    kv_norm [kv_lora], the shared rope key's w_kr [d, rope], the up
    projections w_uk [kv_lora, H, nope] and w_uv [kv_lora, H, v], wo [H,
    v, d] and the block norm."""
    d, H = cfg.d_model, cfg.n_heads
    nope, rope_d, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                              cfg.v_head_dim, cfg.kv_lora)
    wt = dtype or torch.float32
    if cfg.q_lora:
        q = {"w_dq": dense_init(gen, d, cfg.q_lora, lead=lead, dtype=wt),
             "w_uq": dense_init(gen, cfg.q_lora, (H, nope + rope_d),
                                lead=lead, dtype=wt)}
    else:
        q = {"wq": dense_init(gen, d, (H, nope + rope_d), lead=lead,
                              dtype=wt)}
    p = dict(q, **{
        "w_dkv": dense_init(gen, d, lora, lead=lead, dtype=wt),
        "w_kr": dense_init(gen, d, rope_d, lead=lead, dtype=wt),
        "w_uk": dense_init(gen, lora, (H, nope), lead=lead, dtype=wt),
        "w_uv": dense_init(gen, lora, (H, vd), lead=lead, dtype=wt),
        "wo": _normal(gen, (*lead, H, vd, d), 1.0 / math.sqrt(H * vd), wt),
        "norm": _norm_init(cfg, d, gen, lead, dtype),
        "kv_norm": _ones(gen, (*lead, lora), dtype),
    })
    if cfg.q_lora:
        p["q_norm"] = _ones(gen, (*lead, cfg.q_lora), dtype)
    return p


def mla_axes(cfg: ArchConfig) -> Dict:
    q = ({"w_dq": ("embed", "lora"), "w_uq": ("lora", "heads", None)}
         if cfg.q_lora else {"wq": ("embed", "heads", None)})
    a = dict(q, **{"w_dkv": ("embed", "lora"),
                   "w_kr": ("embed", None), "w_uk": ("lora", "heads", None),
                   "w_uv": ("lora", "heads", None),
                   "wo": ("heads", None, "embed"),
                   "norm": _norm_axes(cfg), "kv_norm": (None,)})
    if cfg.q_lora:
        a["q_norm"] = (None,)
    return a


def mla_rope(cfg: ArchConfig, x, positions):
    """RoPE of MLA's rope part x [B, T, *, rope]: plain (bit for bit as
    ``apply_rope``) at ``cfg.yarn_factor`` <= 1, else YaRN's frequencies
    and its factor mscale(factor, mscale) / mscale(factor, mscale_all_dim)
    on cos and sin."""
    f = cfg.yarn_factor
    if f <= 1:
        return apply_rope(x, positions, cfg.rope_theta)
    freqs = yarn_freqs(x.shape[-1], cfg.rope_theta, f, cfg.yarn_original,
                       cfg.yarn_beta_fast, cfg.yarn_beta_slow, x.device)
    m = (yarn_mscale(f, cfg.yarn_mscale)
         / yarn_mscale(f, cfg.yarn_mscale_all_dim))
    return apply_rope(x, positions, freqs=freqs, mscale=m)


def mla_scale(cfg: ArchConfig) -> Optional[float]:
    """MLA's softmax scale: (nope + rope)^-0.5, times YaRN's
    mscale(factor, mscale_all_dim)^2 where ``cfg.yarn_factor`` > 1 and
    ``yarn_mscale_all_dim`` is set; None (the attention's own default,
    the same value) where plain."""
    f, m = cfg.yarn_factor, cfg.yarn_mscale_all_dim
    if f <= 1 or not m:
        return None
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 * yarn_mscale(f, m) ** 2


def _mla_query(p, h, cfg: ArchConfig):
    """Queries [B, T, H, nope + rope]: h wq, or with ``q_lora``
    rms_norm(h w_dq) w_uq (the norm rounded back to h's dtype)."""
    if not cfg.q_lora:
        return einsum("btd,dhk->bthk", h, p["wq"])
    c_q = rms_norm(einsum("btd,dl->btl", h, p["w_dq"]), p["q_norm"])
    return einsum("btl,lhk->bthk", c_q, p["w_uq"])


def _mla_latent(p, h, cfg: ArchConfig, positions):
    """The latent c_kv = rms_norm(h w_dkv) [B, T, kv_lora] (rounded back to
    h's dtype) and the rope key shared by all heads [B, T, 1, rope]."""
    c_kv = rms_norm(einsum("btd,dl->btl", h, p["w_dkv"]), p["kv_norm"])
    k_rope = mla_rope(cfg, einsum("btd,dr->btr", h, p["w_kr"])[:, :, None],
                      positions)
    return c_kv, k_rope


def _mla_expand(p, c_kv, k_rope, H: int):
    """Per-head keys [B, T, H, nope + rope] (the rope key broadcast to every
    head) and values [B, T, H, v] from the latent."""
    B, T, _, rope_d = k_rope.shape
    k_nope = einsum("btl,lhn->bthn", c_kv, p["w_uk"])
    v = einsum("btl,lhv->bthv", c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(B, T, H, rope_d)], dim=-1)
    return k, v


def mla_apply(p, x, *, cfg: ArchConfig, positions,
              cache: Optional[Dict] = None, pos: Optional[int] = None,
              attn_impl: str = "kernel", absorbed: bool = False):
    """MLA. Full mode when ``cache`` is None: the per-head K/V expanded from
    the latent go through ``flash_attention`` (q and k of nope + rope, v of
    v_head_dim). Decode writes into ``cache`` in place (the reference
    returns an updated copy) and returns the same dict: the expanded
    per-head cache {"k", "v"} by default, attended by ``attention_ref``; with
    ``absorbed`` the compressed {"c_kv", "k_rope"} cache, W_uk folded into
    q, fp32 scores over the latent masked to ``pos + t``, W_uv applied after.
    The scale is (nope + rope)^-0.5 on both paths, as the reference's,
    times YaRN's mscale^2 where the config scales RoPE (``mla_scale``);
    ``q_lora`` takes the query through its low-rank path. Full mode
    trains (flash's ``_FlashAttention`` at D = nope + rope, Dv =
    v_head_dim); the decode modes are serving only."""
    B, T, d = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    x = constrain_seq(x)  # seq-parallel residual stream (fsdp_tp_sp only)
    h = apply_norm(cfg, p.get("norm"), x)
    q = _mla_query(p, h, cfg)                           # [B, T, H, nope+rope]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = mla_rope(cfg, q_rope, positions)
    c_kv, k_rope = _mla_latent(p, h, cfg, positions)
    scale = mla_scale(cfg)

    if absorbed and cache is not None:
        cc, ckr = cache["c_kv"], cache["k_rope"]        # [B, Tmax, l], [B, Tmax, r]
        Tmax = cc.shape[1]
        start = min(max(int(pos), 0), Tmax - T)         # dynamic_update_slice
        cc[:, start:start + T] = c_kv.to(cc.dtype)
        ckr[:, start:start + T] = k_rope[:, :, 0].to(ckr.dtype)
        q_lat = einsum("bthn,lhn->bthl", q_nope, p["w_uk"])
        s = (einsum("bthl,bsl->bhts", q_lat.float(), cc.float())
             + einsum("bthr,bsr->bhts", q_rope.float(), ckr.float()))
        s = s * (scale or (nope + rope_d) ** -0.5)
        live = torch.arange(Tmax, device=x.device)[None, None, None, :] <= (
            int(pos) + torch.arange(T, device=x.device)[None, None, :, None])
        s = torch.where(live, s, torch.full_like(s, -1e30))
        o_lat = einsum("bhts,bsl->bthl", _softmax(s), cc.float())
        o = einsum("bthl,lhv->bthv", o_lat, p["w_uv"].float())
        y = einsum("bthv,hvd->btd", o.to(x.dtype), p["wo"])
        return x + y, cache

    k, v = _mla_expand(p, c_kv, k_rope, H)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qh, kh, vh = (t.transpose(1, 2) for t in (qq, k, v))
    new_cache = None
    if cache is not None:                                # expanded decode
        ck, cv = cache["k"], cache["v"]                  # [B, H, Tmax, *]
        Tmax = ck.shape[2]
        start = min(max(int(pos), 0), Tmax - T)
        ck[:, :, start:start + T] = kh.to(ck.dtype)
        cv[:, :, start:start + T] = vh.to(cv.dtype)
        new_cache = cache
        o = attend(attention_ref, qh, ck.to(qh.dtype), cv.to(qh.dtype),
                   kv_axis="heads", causal=True, q_offset=int(pos),
                   scale=scale)
    else:
        # contiguous head-major tensors; Dv != D; the expanded k/v have
        # every head
        o = attend(flash_attention, qh.contiguous(), kh.contiguous(),
                   vh.contiguous(), kv_axis="heads", causal=True,
                   impl=attn_impl, block_k=cfg.attn_block_k, scale=scale)
    o = o.transpose(1, 2)                                # [B, T, H, v]
    y = einsum("bthv,hvd->btd", o[..., :vd], p["wo"])
    return x + y, new_cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                   absorbed: bool = False) -> Dict[str, torch.Tensor]:
    """The decode cache of one layer: expanded per-head {"k": [B, H, max_len,
    nope + rope], "v": [B, H, max_len, v]}, or with ``absorbed`` the latent
    {"c_kv": [B, max_len, kv_lora], "k_rope": [B, max_len, rope]}."""
    if absorbed:
        shapes = {"c_kv": (batch, max_len, cfg.kv_lora),
                  "k_rope": (batch, max_len, cfg.qk_rope_dim)}
    else:
        hd = cfg.qk_nope_dim + cfg.qk_rope_dim
        shapes = {"k": (batch, cfg.n_heads, max_len, hd),
                  "v": (batch, cfg.n_heads, max_len, cfg.v_head_dim)}
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in shapes.items()}


def mla_prefill_cache(p, x, *, cfg: ArchConfig, positions, max_len: int,
                      dtype, absorbed: bool = False) -> Dict[str, torch.Tensor]:
    """The MLA decode cache of one layer from a prompt ``x`` (the layer's
    input), in the form ``mla_cache_init`` gives: the latent recomputed from
    ``x``, then (expanded form) the per-head K/V; zero-padded or cut to
    ``max_len`` slots."""
    B, T, _ = x.shape
    h = apply_norm(cfg, p.get("norm"), x)
    c_kv, k_rope = _mla_latent(p, h, cfg, positions)
    pad = max_len - T
    if absorbed:
        cc = F.pad(c_kv, (0, 0, 0, max(pad, 0)))[:, :max_len]
        kr = F.pad(k_rope[:, :, 0], (0, 0, 0, max(pad, 0)))[:, :max_len]
        return {"c_kv": cc.to(dtype), "k_rope": kr.to(dtype)}
    k, v = _mla_expand(p, c_kv, k_rope, cfg.n_heads)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if pad > 0:
        kh = F.pad(kh, (0, 0, 0, pad))
        vh = F.pad(vh, (0, 0, 0, pad))
    return {"k": kh[:, :, :max_len].to(dtype),
            "v": vh[:, :, :max_len].to(dtype)}


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def ffn_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, lead: Tuple[int, ...] = (),
             dtype=None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    wt = dtype or torch.float32
    return {
        "w1": dense_init(gen, d, f, lead=lead, dtype=wt),
        "w3": dense_init(gen, d, f, lead=lead, dtype=wt),
        "w2": dense_init(gen, f, d, lead=lead, dtype=wt),
        "norm": _norm_init(cfg, d, gen, lead, dtype),
    }


def ffn_axes(cfg: ArchConfig) -> Dict:
    return {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
            "w2": ("mlp", "embed"), "norm": _norm_axes(cfg)}


def ffn_apply(p, x, *, cfg: ArchConfig, act: str = "silu"):
    x = constrain_seq(x)  # seq-parallel residual stream (fsdp_tp_sp only)
    h = apply_norm(cfg, p.get("norm"), x)
    # serve_2d: the activations gathered over "data" here, so that the 2-D
    # sharded weights stay put; the identity under the other presets
    h = constrain(h, ("ffn_batch", None, None))
    g = einsum("btd,df->btf", h, p["w1"])
    u = einsum("btd,df->btf", h, p["w3"])
    g = silu(g) if act == "silu" else gelu(g)
    y = einsum("btf,fd->btd", g * u, p["w2"])
    y = constrain(y, ("batch", None, None))
    return x + y


# ---------------------------------------------------------------------------
# MoE (grok: expert-TP; deepseek: expert-parallel + shared experts)
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = (), dtype=None) -> Dict:
    """The reference's params and layouts: router [d, E], experts' w1/w3
    [E, d, f] and w2 [E, f, d], the block norm, and (deepseek) the shared
    experts as one SwiGLU FFN of n_shared_experts * f without its own norm.
    With an expert share (``cfg.experts_held``) the router keeps its E
    outputs and the experts' leaves hold the ``cfg.held`` experts here."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    wt = dtype or torch.float32
    p = {
        "w_router": dense_init(gen, d, E, lead=lead, dtype=wt),
        "w1": _normal(gen, (*lead, cfg.held, d, f), 1.0 / math.sqrt(d), wt),
        "w3": _normal(gen, (*lead, cfg.held, d, f), 1.0 / math.sqrt(d), wt),
        "w2": _normal(gen, (*lead, cfg.held, f, d), 1.0 / math.sqrt(f), wt),
        "norm": _norm_init(cfg, d, gen, lead, dtype),
    }
    if cfg.n_shared_experts:
        shared = ffn_init(gen, cfg, d_ff=cfg.n_shared_experts * f, lead=lead,
                          dtype=dtype)
        shared.pop("norm")                   # the block norm is shared
        p["shared"] = shared
    return p


def moe_axes(cfg: ArchConfig) -> Dict:
    """expert_parallel: the experts dim on "model", each expert's FFN local;
    otherwise (expert_tp) the experts replicated, each one's FFN on "mlp"."""
    ep, fp = (("experts", None) if cfg.moe_strategy == "expert_parallel"
              else (None, "mlp"))
    a = {"w_router": ("embed", None), "w1": (ep, "embed", fp),
         "w3": (ep, "embed", fp), "w2": (ep, fp, "embed"),
         "norm": _norm_axes(cfg)}
    if cfg.n_shared_experts:
        sa = ffn_axes(cfg)
        sa.pop("norm")
        a["shared"] = sa
    return a


def _capacity(cfg: ArchConfig, T: int) -> int:
    c = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(4, -(-c // 4) * 4)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim as ``jax.nn.softmax`` spells it."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def moe_route(w_router, h, top_k: int):
    """Top-k routing on fp32 probabilities. Returns (probs [B, T, E], gates
    [B, T, K] renormalised to sum 1, expert ids [B, T, K] int64)."""
    logits = einsum("btd,de->bte", h, w_router).float()
    probs = _softmax(logits)
    gates, eid = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eid


def _experts(p, disp):
    """The experts' SwiGLU on their buffers [..., E, C, d]."""
    g1 = einsum("becd,edf->becf", disp, p["w1"])
    u1 = einsum("becd,edf->becf", disp, p["w3"])
    return einsum("becf,efd->becd", silu(g1) * u1, p["w2"])


def shared_experts(sp, h):
    g = einsum("btd,df->btf", h, sp["w1"])
    u = einsum("btd,df->btf", h, sp["w3"])
    return einsum("btf,fd->btd", silu(g) * u, sp["w2"])


def _moe_einsum(p, h, eid, gates, E: int, C: int):
    """The reference's dense dispatch mask [B, T, E, C]: slots from a cumsum
    over each row's (t, k) pairs, pairs past C dropped. Returns (y, the
    kept pairs per (row, expert) in h's dtype)."""
    B, T, K = eid.shape
    dt = h.dtype
    onehot = F.one_hot(eid, E)                            # [B, T, K, E]
    flat = onehot.reshape(B, T * K, E)
    pos = torch.cumsum(flat, dim=1) - flat                # exclusive
    slot = (pos * flat).sum(-1).reshape(B, T, K)
    keep = slot < C
    slot_oh = F.one_hot(torch.where(keep, slot, C), C + 1).to(dt)[..., :C]
    oh = onehot.to(dt)
    mask = einsum("btke,btkc->btec", oh, slot_oh)
    gmask = torch.einsum("btke,btkc,btk->btec", oh, slot_oh, gates.to(dt))
    disp = einsum("btec,btd->becd", mask, h)
    disp = constrain(disp, ("ffn_batch", "experts", None, None))
    eo = constrain(_experts(p, disp), ("ffn_batch", "experts", None, None))
    y = einsum("btec,becd->btd", gmask, eo)
    return y, mask.sum(dim=(1, 3))


def _moe_shuffle(p, h, eid, gates, E: int, C: int):
    """The same function through the shuffle kernels: slots counted per
    row, then the B rows flattened to N = B*T tokens with row b's expert
    ids offset by b*E, so that B*E buffers hold each row's experts.
    Returns (y, the kept pairs per (row, expert) in h's dtype). Under grad
    dispatch and combine take their autograd Functions (each one's
    backward a launch of the other's kernel); the slots and the kept
    counts stay integer, outside autograd, as the reference's mask, and the
    gates reach combine in h's dtype, as its gated mask has them, so their
    gradient flows back through the cast to the fp32 router."""
    gates = gates.to(h.dtype)
    if not is_sharded(h):
        disp, slot, kept = _rows_dispatch(h, eid, E, C)
        return _rows_combine(_experts(p, disp), eid, slot, gates), kept
    # under a mesh: each rank dispatches and combines the rows of its
    # "ffn_batch" shard over all E experts; the experts' products run
    # between on the "experts" sharding, so combine gathers eo over it
    rows = local_placements(("ffn_batch", None, None), h.shape)
    bufs = local_placements(("ffn_batch", None, None, None),
                            (h.shape[0], E, C, h.shape[-1]))
    kept_p = local_placements(("ffn_batch", None), (h.shape[0], E))
    disp, slot, kept = local_call(
        lambda hh, ee: _rows_dispatch(hh, ee, E, C), (h, eid), (rows, rows),
        (bufs, rows, kept_p))
    disp = constrain(disp, ("ffn_batch", "experts", None, None))
    eo = constrain(_experts(p, disp), ("ffn_batch", "experts", None, None))
    y = local_call(_rows_combine, (eo, eid, slot, gates),
                   (bufs, rows, rows, rows), rows)
    return y, kept


def _rows_dispatch(h, eid, E: int, C: int, slot=None):
    """Slots counted per row (or ``slot`` as given), then the B rows
    flattened to N = B*T tokens with row b's expert ids offset by b*E, so
    that B*E buffers hold each row's experts. Returns (buffers [B, E, C,
    d], slots [B, T, K], the kept pairs per (row, expert) in h's dtype)."""
    B, T, K = eid.shape
    d = h.shape[-1]
    N = B * T
    if slot is None:
        slot = compute_slots(eid, E, C)
    flat_slot = slot.reshape(N, K)
    disp = dispatch(h.reshape(N, d), _flat_ids(eid, E), flat_slot, B * E, C,
                    impl="kernel")
    kept = (flat_slot < C).reshape(B, T * K).long()
    counts = torch.zeros((B, E), dtype=torch.long, device=eid.device)
    counts.scatter_add_(1, eid.reshape(B, T * K), kept)
    return disp.reshape(B, E, C, d), slot, counts.to(h.dtype)


def _flat_ids(eid, E: int):
    """[B, T, K] ids -> [B*T, K], row b's offset by b*E."""
    B, T, K = eid.shape
    offset = E * torch.arange(B, device=eid.device)[:, None, None]
    return (eid + offset).reshape(B * T, K)


def _rows_combine(eo, eid, slot, gates):
    """``combine`` of the experts' rows [B, E, C, d] back to [B, T, d]."""
    B, T, K = eid.shape
    E, C, d = eo.shape[1:]
    y = combine(eo.reshape(B * E, C, d), _flat_ids(eid, E),
                slot.reshape(B * T, K), gates.reshape(B * T, K), B * T,
                impl="kernel")
    return y.reshape(B, T, d)


def moe_route_grouped(w_router, h, cfg: ArchConfig, bias):
    """DeepSeek-V3's router on fp32 scores s = sigmoid(h w_router) [B, T,
    E]. Selection reads s + ``bias`` [E]: the ``topk_group`` of the
    ``n_group`` groups whose two best biased scores sum highest, then the
    top_k experts inside them (every other expert at -inf). The gates are
    the chosen experts' unbiased s over their sum, times
    ``routed_scaling``. Returns (s, gates [B, T, K], expert ids [B, T, K]
    int64)."""
    scores = torch.sigmoid(einsum("btd,de->bte", h, w_router).float())
    B, T, E = scores.shape
    G = cfg.n_group
    biased = scores.detach() + bias
    group = biased.view(B, T, G, E // G).topk(2, dim=-1).values.sum(-1)
    picked = group.topk(cfg.topk_group, dim=-1).indices   # [B, T, groups]
    live = torch.zeros_like(group, dtype=torch.bool).scatter_(-1, picked, True)
    live = live[..., None].expand(B, T, G, E // G).reshape(B, T, E)
    eid = biased.masked_fill(~live, float("-inf")).topk(
        cfg.top_k, dim=-1).indices
    w = scores.gather(-1, eid)
    return scores, w / w.sum(-1, keepdim=True) * cfg.routed_scaling, eid


def balance_loss(scores, eid, E: int):
    """The sequence-wise balance loss of each row, averaged over rows:
    sum_i f_i P_i with f_i = E / (K T) #{t: i chosen} (a constant) and P_i
    = mean_t s_i / sum_j s_j, over all E routed-over experts, before
    capacity (its alpha is the caller's)."""
    B, T, K = eid.shape
    chosen = torch.zeros((B, E), dtype=torch.float32, device=eid.device)
    chosen.scatter_add_(1, eid.reshape(B, T * K),
                        torch.ones((), device=eid.device).expand(B, T * K))
    f = chosen * (E / (K * T))
    P = (scores / scores.sum(-1, keepdim=True)).mean(1)
    return (f * P).sum(-1).mean()


def held_slots(eid, cfg: ArchConfig, C: int):
    """The expert share's pairs: each pair's held expert id [B, T, K] (its
    id less ``cfg.first_held``; 0 for a pair whose expert is not held
    here) and its slot, counted per row over the held experts' pairs
    (which is their count over all E, pair for pair), C for a pair
    routed elsewhere, so that dispatch and combine drop it. Also whether
    each pair's expert is held."""
    local = eid - cfg.first_held
    mine = (local >= 0) & (local < cfg.held)
    slot = compute_slots(torch.where(mine, local, -1), cfg.held, C)
    slot = torch.where(mine, slot, torch.full_like(slot, C))
    return torch.where(mine, local, 0), slot, mine


def count_share(mine, slot, lid, held: int, C: int) -> None:
    """The counters of one expert layer's forward (``trace.count``):
    moe.pairs_held, the pairs routed to held experts; moe.pairs_kept,
    those under capacity; moe.load_ratio_sum and moe.load_ratio_n, the
    most-loaded held expert's pairs over the mean held expert's, where the
    held experts got any."""
    loads = torch.zeros(held, dtype=torch.float32, device=lid.device)
    loads.scatter_add_(0, lid.reshape(-1), mine.reshape(-1).float())
    total = loads.sum()
    some = total > 0
    trace.count("moe.pairs_held", total)
    trace.count("moe.pairs_kept", (slot < C).sum())   # C: routed elsewhere
    trace.count("moe.load_ratio_sum", torch.where(
        some, loads.max() / loads.mean().clamp_min(1e-9), 0.0))
    trace.count("moe.load_ratio_n", some.float())


def moe_apply_grouped(p, x, *, cfg: ArchConfig, bias, loads=None,
                      count: bool = False, layer: Optional[int] = None):
    """DeepSeek-V3's expert layer over a share of its experts: routed over
    all E = ``cfg.n_experts`` (``moe_route_grouped`` with the selection
    ``bias``), the pairs to the ``cfg.held`` experts from
    ``cfg.first_held`` on dispatched to their buffers [B, held, C, d]
    (C = ``_capacity``, counted over E) and combined back through the
    shuffle kernels; pairs to other experts are dropped, as the absent
    chips' part of the result. The shared expert runs whole. ``loads`` [E]
    (or None): each expert's selections of this forward are added to it in
    place, for the bias's update; ``count``: the share's counters
    (``count_share``). Spans ``pangea.moe.route`` (attr ``layer``) and
    ``pangea.moe.experts``. Returns (x + y, the balance loss)."""
    B, T, d = x.shape
    E = cfg.n_experts
    C = _capacity(cfg, T)
    h = apply_norm(cfg, p.get("norm"), x)
    if is_sharded(h):
        raise NotImplementedError("the expert share runs on one chip")
    with trace.span("pangea.moe.route", layer=layer):
        scores, gates, eid = moe_route_grouped(p["w_router"], h, cfg, bias)
        aux = balance_loss(scores, eid, E)
        lid, slot, mine = held_slots(eid, cfg, C)
        if loads is not None:
            # index_add_, not bincount: bincount sizes its output on the host
            ids = eid.reshape(-1)
            loads.index_add_(0, ids, torch.ones_like(ids, dtype=loads.dtype))
        if count:
            count_share(mine, slot, lid, cfg.held, C)
    with trace.span("pangea.moe.experts"):
        disp, slot, _ = _rows_dispatch(h, lid, cfg.held, C, slot)
        y = _rows_combine(_experts(p, disp), lid, slot, gates.to(h.dtype))
    if cfg.n_shared_experts:
        y = y + shared_experts(p["shared"], h)
    return x + y, aux


def moe_apply(p, x, *, cfg: ArchConfig, impl: str = "xla"):
    """MoE block: the device-side shuffle service. Per-batch-row capacity
    C = ``_capacity(cfg, T)``. Returns (x + y, switch aux loss).

    impl: "xla" mirrors the reference's dense dispatch mask; "kernel"
    dispatches and combines through the shuffle kernels (their plain
    versions on CPU tensors), with the gates in h's dtype as the
    reference's gated mask has them. The experts' SwiGLU is an einsum over
    [B, E, C, d] either way. Both impls train; the aux loss is
    differentiated through the router's mean probabilities only (the kept
    counts are integers), as the reference's."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, T)
    x = constrain_seq(x)  # seq-parallel residual stream (fsdp_tp_sp only)
    h = apply_norm(cfg, p.get("norm"), x)
    h = constrain(h, ("ffn_batch", None, None))  # serve_2d: gather over data
    probs, gates, eid = moe_route(p["w_router"], h, K)
    if impl == "kernel":
        y, kept = _moe_shuffle(p, h, eid, gates, E, C)
    elif impl == "xla":
        y, kept = _moe_einsum(p, h, eid, gates, E, C)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if cfg.n_shared_experts:
        y = y + shared_experts(p["shared"], h)
    # switch-style load-balance aux loss
    density = kept / _const(T, kept.dtype)                # [B, E] tokens frac
    router_prob = probs.mean(dim=1)                       # [B, E]
    aux = (density * router_prob).sum(-1).mean() * E
    y = constrain(y, ("batch", None, None))
    return x + y, aux


# ---------------------------------------------------------------------------
# RWKV6 (Finch): time mix (wkv) + channel mix
# ---------------------------------------------------------------------------
def _uniform(gen: torch.Generator, shape, dtype=None) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=param_dtype(shape, dtype),
                      device=gen_device(gen))


def rwkv_init(gen: torch.Generator, cfg: ArchConfig,
              lead: Tuple[int, ...] = (), dtype=None) -> Dict:
    """The reference's params and layouts. Its init draws all five ``mu_*``
    from one key (and ``cmu_k``/``cmu_r`` from another); here each is drawn
    anew. Parity tests bridge the reference's own params."""
    d, ff, lora = cfg.d_model, cfg.d_ff, 64
    wt = dtype or torch.float32
    vec = (*lead, d)
    p = {nm: _uniform(gen, vec, dtype)
         for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")}
    p["w0"] = _normal(gen, vec, 0.1, dtype).add_(-2.0)
    p["wA"] = dense_init(gen, d, lora, lead=lead, dtype=wt)
    p["wB"] = dense_init(gen, lora, d, lead=lead, dtype=wt)
    for nm in ("w_r", "w_k", "w_v", "w_g"):
        p[nm] = dense_init(gen, d, d, lead=lead, dtype=wt)
    p["u"] = _normal(gen, vec, 0.1, dtype)
    p["ln_x"] = _ones(gen, vec, dtype)
    p["w_o"] = dense_init(gen, d, d, lead=lead, dtype=wt)
    p["norm1"] = _norm_init(cfg, d, gen, lead, dtype)
    p["cmu_k"] = _uniform(gen, vec, dtype)
    p["cmu_r"] = _uniform(gen, vec, dtype)
    p["cw_k"] = dense_init(gen, d, ff, lead=lead, dtype=wt)
    p["cw_v"] = dense_init(gen, ff, d, lead=lead, dtype=wt)
    p["cw_r"] = dense_init(gen, d, d, lead=lead, dtype=wt)
    p["norm2"] = _norm_init(cfg, d, gen, lead, dtype)
    return p


def rwkv_axes(cfg: ArchConfig) -> Dict:
    a = {nm: (None,) for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                "w0", "u", "ln_x", "cmu_k", "cmu_r")}
    a.update({"wA": ("embed", None), "wB": (None, "embed"),
              "w_o": ("heads_embed", "embed"), "norm1": _norm_axes(cfg),
              "cw_k": ("embed", "mlp"), "cw_v": ("mlp", "embed"),
              "cw_r": ("embed", "embed_out"), "norm2": _norm_axes(cfg)})
    for nm in ("w_r", "w_k", "w_v", "w_g"):
        a[nm] = ("embed", "heads_embed")
    return a


def _token_shift(x, prev):
    """[B, T, d] -> the previous token's activations; ``prev`` ([B, d]) is
    the one before t = 0 (zeros without it)."""
    if x.shape[1] == 1:
        return prev[:, None] if prev.dim() == 2 else prev
    shifted = torch.cat([x[:, :1] * 0, x[:, :-1]], dim=1)
    if prev is not None:
        shifted[:, 0] = prev if prev.dim() == 2 else prev[:, 0]
    return shifted


# the wkv's chunk: the reference's fixed 64, and 16 under grad. The chunked
# factorisation scales by e^{a chunk's summed |log decays|}, which passes
# fp32's range beyond 88: training full-width rwkv6-3b at 64 overflows
# (its loss is NaN from step 2, tools/rwkv_gla_chunk.py); a chunk of 16
# sums a quarter as many decays. Both chunks compute the same scan.
GLA_CHUNK = 64
TRAIN_GLA_CHUNK = 16


def rwkv_apply(p, x, *, cfg: ArchConfig, state: Optional[Dict] = None,
               scan_impl: str = "kernel"):
    """Returns (y, new_state). state: {"tm_x", "cm_x": [B, d], "S":
    [B, H, dk, dv]}. With T > 1 the wkv runs from a zero state (any incoming
    ``S`` is ignored, as in the reference); with ``state`` and T == 1 it is
    one decode step. dtypes follow the reference's promotions: with bf16
    weights the time mix runs in bf16, the decode state in fp32. The wkv
    is chunked at the reference's ``GLA_CHUNK``, and at
    ``TRAIN_GLA_CHUNK`` under grad."""
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    decode = state is not None and T == 1

    # ---- time mix ----
    h = apply_norm(cfg, p.get("norm1"), x)
    prev = state["tm_x"] if state is not None else None
    hs = _token_shift(h, prev)

    def mix(mu):
        return h + (hs - h) * mu
    xr, xk, xv, xw, xg = (mix(p[m]) for m in
                          ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    w_log = -torch.exp(p["w0"] + torch.tanh(
        einsum("btd,dl->btl", xw, p["wA"])) @ p["wB"])   # [B,T,d] <= 0
    r = einsum("btd,de->bte", xr, p["w_r"])
    k = einsum("btd,de->bte", xk, p["w_k"])
    v = einsum("btd,de->bte", xv, p["w_v"])
    g = einsum("btd,de->bte", xg, p["w_g"])

    S0 = state["S"] if decode else None
    if is_sharded(r):
        o, new_S = _wkv_sharded(r, k, v, w_log, p["u"], S0, hd, scan_impl)
    else:
        o, new_S = _wkv(r, k, v, w_log, p["u"], S0, hd, scan_impl)
    # per-head group norm: an rms norm (eps 1e-6) scaled by ln_x
    og = o.reshape(B, T, H, hd)
    og = rms_norm(og, None) * p["ln_x"].reshape(H, hd)
    o = og.reshape(B, T, d).to(x.dtype)
    o = o * silu(g)
    x = x + einsum("btd,de->bte", o, p["w_o"])

    # ---- channel mix ----
    h2 = apply_norm(cfg, p.get("norm2"), x)
    prev2 = state["cm_x"] if state is not None else None
    hs2 = _token_shift(h2, prev2)
    ck = h2 + (hs2 - h2) * p["cmu_k"]
    cr = h2 + (hs2 - h2) * p["cmu_r"]
    kk = einsum("btd,df->btf", ck, p["cw_k"])
    kk = torch.clamp_min(kk, 0.0) ** 2
    out = sigmoid(einsum("btd,de->bte", cr, p["cw_r"])) * \
        einsum("btf,fd->btd", kk, p["cw_v"])
    x = x + out

    new_state = None
    if state is not None:
        new_state = {"tm_x": h[:, -1], "cm_x": h2[:, -1], "S": new_S}
    return x, new_state


def _wkv(r, k, v, w_log, u, S0, hd: int, scan_impl: str):
    """The wkv of r, k, v and the log decays [B, T, d] over heads of ``hd``
    channels, with the bonus ``u`` [d]: one decode step from the state
    ``S0`` [B, H, hd, hd] where it is given, else the scan from a zero
    state (``gla_scan``). Returns (o [B, T, d], the new state)."""
    B, T, d = r.shape
    H = d // hd

    def heads(t):  # [B, T, d] -> [B*H, T, hd]
        return (t.reshape(B, T, H, hd).transpose(1, 2)
                .reshape(B * H, T, hd))
    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w_log)
    u = u.reshape(H, hd)[None].expand(B, H, hd).reshape(B * H, hd)
    if S0 is not None:
        S = S0.reshape(B * H, hd, hd)
        kv = kh[:, 0, :, None] * vh[:, 0, None, :]
        Su = S + u[:, :, None] * kv                    # fp32, as jax promotes
        o = torch.einsum("bk,bkv->bv", rh[:, 0].to(Su.dtype), Su)[:, None]
        S = torch.exp(wh[:, 0])[:, :, None] * S + kv
        new_S = S.reshape(B, H, hd, hd)
    else:
        train = torch.is_grad_enabled() and any(
            t.requires_grad for t in (rh, kh, vh, wh, u))
        o, Sf = gla_scan(rh, kh, vh, wh, u, impl=scan_impl,
                         chunk=TRAIN_GLA_CHUNK if train else GLA_CHUNK)
        new_S = Sf.reshape(B, H, hd, hd)
    return o.reshape(B, H, T, hd).transpose(1, 2).reshape(B, T, d), new_S


def _wkv_sharded(r, k, v, w_log, u, S0, hd: int, scan_impl: str):
    """``_wkv`` through ``local_call``: the batch on its "batch" axes and
    the channels on "heads_embed" where whole heads divide it, each rank's
    scan (the GLA kernel) on its heads. The bonus ``u`` is whole on the
    batch axes, so its gradient is a partial sum over them: each rank's
    covers its own rows."""
    B, T, d = r.shape
    H = d // hd
    xp = local_placements(("batch", None, "heads_embed"), (B, T, H))
    vec = local_placements(("heads_embed",), (H,))
    sp = local_placements(("batch", "heads_embed", None, None), (B, H))
    args = (r, k, v, w_log, u) + ((S0,) if S0 is not None else ())
    in_p = (xp,) * 4 + (vec,) + ((sp,) if S0 is not None else ())
    grad_p = in_p[:4] + (partial_on(vec, sharded_axes(xp, 0)),) + in_p[5:]

    def run(*a):
        return _wkv(*a[:5], a[5] if len(a) > 5 else None, hd, scan_impl)
    return local_call(run, args, in_p, (xp, sp), grad_p)


def rwkv_state_init(cfg: ArchConfig, batch: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    return {"tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma)
# ---------------------------------------------------------------------------
CONV_W = 4
LRU_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...] = (), dtype=None) -> Dict:
    """The reference's params and layouts (lru width = d_model)."""
    d = w = cfg.d_model
    wt = dtype or torch.float32
    vec = (*lead, w)
    return {
        "w_gate": dense_init(gen, d, w, lead=lead, dtype=wt),
        "w_x": dense_init(gen, d, w, lead=lead, dtype=wt),
        "conv_w": _normal(gen, (*lead, CONV_W, w), 0.1, dtype),
        "conv_b": _zeros(gen, vec, dtype),
        "w_a": dense_init(gen, w, w, lead=lead, dtype=wt),
        "b_a": _zeros(gen, vec, dtype),
        "w_i": dense_init(gen, w, w, lead=lead, dtype=wt),
        "b_i": _zeros(gen, vec, dtype),
        "lam": _uniform(gen, vec, dtype).mul_(1.5).add_(0.5),
        "w_out": dense_init(gen, w, d, lead=lead, dtype=wt),
        "norm": _norm_init(cfg, d, gen, lead, dtype),
    }


def rglru_axes(cfg: ArchConfig) -> Dict:
    """FSDP on the input dims, TP on the outputs: the recurrence state h
    stays sharded on "model" end to end."""
    return {"w_gate": ("embed", "mlp"), "w_x": ("embed", "mlp"),
            "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "w_a": ("embed", "mlp_out"), "b_a": ("mlp_out",),
            "w_i": ("embed", "mlp_out"), "b_i": ("mlp_out",),
            "lam": ("mlp_out",), "w_out": ("mlp_out", "embed"),
            "norm": _norm_axes(cfg)}


def rglru_apply(p, x, *, cfg: ArchConfig, state: Optional[Dict] = None,
                scan_impl: str = "kernel"):
    """Returns (y, new_state); state: {"conv": [B, CONV_W-1, w], "h": [B, w]}.
    The diagonal scan goes to ``diag_scan`` (``scan_impl`` "kernel": the
    CUDA kernel; any other value: the sequential oracle).

    dtypes follow the reference's promotions: with a layer's vectors in
    fp32 (the unstacked ``rem`` layers, which the compute cast leaves) the
    conv bias makes the gates, the scan and the residual fp32."""
    B, T, d = x.shape
    h0 = apply_norm(cfg, p.get("norm"), x)
    gate = gelu(einsum("btd,dw->btw", h0, p["w_gate"]))
    xx = einsum("btd,dw->btw", h0, p["w_x"])
    # causal depthwise conv, window CONV_W, summed from 0 in the reference's
    # order
    prev_conv = (state["conv"] if state is not None
                 else torch.zeros((B, CONV_W - 1, xx.shape[-1]),
                                  dtype=xx.dtype, device=xx.device))
    xcat = torch.cat([prev_conv, xx], dim=1)     # promotes as jnp does
    conv = 0
    for k in range(CONV_W):
        conv = conv + xcat[:, k:k + T] * p["conv_w"][k]
    conv = conv + p["conv_b"]
    r = sigmoid(einsum("btw,wv->btv", conv, p["w_a"]) + p["b_a"])
    i = sigmoid(einsum("btw,wv->btv", conv, p["w_i"]) + p["b_i"])
    log_a = -LRU_C * softplus(p["lam"]) * r
    aa = torch.exp(log_a)
    bb = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * conv)
    hprev = state["h"] if state is not None else None
    impl = "kernel" if scan_impl == "kernel" else "xla"
    if is_sharded(aa):
        # each rank scans its batch rows and "mlp_out" channels
        xp = local_placements(("batch", None, "mlp_out"), aa.shape)
        hp = local_placements(("batch", "mlp_out"), (B, aa.shape[-1]))
        hs, hT = local_call(
            lambda a_, b_, h_: diag_scan(a_, b_, h_, impl=impl),
            (aa, bb, hprev), (xp, xp, hp if hprev is not None else None),
            (xp, hp))
    else:
        hs, hT = diag_scan(aa, bb, hprev, impl=impl)
    y = einsum("btw,wd->btd", hs * gate, p["w_out"])
    new_state = None
    if state is not None:
        # a copy: a view would keep the whole [B, T + 3, w] xcat alive
        new_state = {"conv": xcat[:, -(CONV_W - 1):].clone(), "h": hT}
    return x + y, new_state


def rglru_state_init(cfg: ArchConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    w = cfg.d_model
    return {"conv": torch.zeros((batch, CONV_W - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=dtype, device=device)}
