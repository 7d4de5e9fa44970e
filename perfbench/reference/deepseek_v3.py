"""Plain PyTorch reference of the DeepSeek-V3 decoder cut to one chip's
share, with the semantics that ``perfbench/configs/deepseek-v3-671b-*.json``
states.

Layers: the first ``first_k_dense_replace`` are MLA and a SwiGLU FFN of
``intermediate_size``, the rest MLA and an expert layer, each behind an
RMSNorm and a residual; a final RMSNorm and an untied unembedding over the
vocabulary slice (``vocab_size``). MLA: the query through its low-rank
path (``q_lora_rank``: a down projection, an RMSNorm, an up projection to
``nope + rope`` dims a head), keys and values expanded from a normed
latent of ``kv_lora_rank``, one rope key shared by all heads, causal
softmax. RoPE rotates the two halves of each rope vector under YaRN
(``rope_scaling``): inverse frequencies blended over the ramp between
floor(d ln(L0 / (2 pi beta_fast)) / (2 ln theta)) and the ceil of
beta_slow's, the interpolated ones divided by ``factor``; cos and sin times
mscale(factor, mscale) / mscale(factor, mscale_all_dim), the softmax scale
(nope + rope)^-0.5 times mscale(factor, mscale_all_dim)^2, where mscale(f,
m) = 0.1 m ln f + 1.

The router scores all ``router_outputs`` experts with a sigmoid in fp32
and selects with the scores plus a bias: the ``topk_group`` of ``n_group``
groups whose two best biased scores sum highest, then the top
``num_experts_per_tok`` experts inside them. The gates are the chosen
experts' unbiased scores over their sum, times ``routed_scaling_factor``.
This chip holds ``n_routed_experts`` experts from ``first_held_expert``
on; an expert takes at most ``capacity`` pairs of a row in (token, rank)
order, counted over all routed-over experts; the pairs to the experts held
here are computed, the others left out (the absent chips' part). One
shared expert (``n_shared_experts`` times ``moe_intermediate_size``) runs
whole. Training adds ``balance_loss_alpha`` times every expert layer's
sequence-wise balance loss (per row, before capacity, over all
routed-over experts: sum_i f_i P_i, f_i = E / (K T) #{t: i chosen}, P_i =
mean_t s_i / sum_j s_j; averaged over rows).

The bias is state beside the parameters: zeros at first, kept in the
parameter dict under ``router_bias`` from one ``loss`` call to the next,
and after each call's forward moved by ``bias_update_speed`` times
sign(mean load - load), the loads being that call's selections (its remat
recompute counts nothing). ``Numerics``, ``no_tf32``, the attention and
the SwiGLU are the V2 reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.deepseek_v2 import (Numerics, causal_attention,
                                             no_tf32, rms_norm, swiglu)

__all__ = ["Numerics", "attn_pair_flops", "capacity", "leaves", "loss",
           "matmul_params", "no_tf32", "sizes"]


# ---------------------------------------------------------------- layout --
def sizes(cfg: Dict) -> Dict[str, int]:
    return dict(
        d=cfg["hidden_size"], L=cfg["num_hidden_layers"],
        Ld=cfg["first_k_dense_replace"], H=cfg["num_attention_heads"],
        V=cfg["vocab_size"], nope=cfg["qk_nope_head_dim"],
        rope=cfg["qk_rope_head_dim"], vd=cfg["v_head_dim"],
        lora=cfg["kv_lora_rank"], qlora=cfg["q_lora_rank"],
        E=cfg["router_outputs"], held=cfg["n_routed_experts"],
        first=cfg["first_held_expert"], K=cfg["num_experts_per_tok"],
        f=cfg["moe_intermediate_size"], F=cfg["intermediate_size"],
        S=cfg["n_shared_experts"])


def _attn_leaves(pre, n, s, out):
    d, H, lora, ql = s["d"], s["H"], s["lora"], s["qlora"]
    nope, rope, vd = s["nope"], s["rope"], s["vd"]
    a = pre + ("attn",)
    return [
        (a + ("w_dq",), (n, d, ql), d ** -0.5),
        (a + ("w_uq",), (n, ql, H, nope + rope), ql ** -0.5),
        (a + ("w_dkv",), (n, d, lora), d ** -0.5),
        (a + ("w_kr",), (n, d, rope), d ** -0.5),
        (a + ("w_uk",), (n, lora, H, nope), lora ** -0.5),
        (a + ("w_uv",), (n, lora, H, vd), lora ** -0.5),
        (a + ("wo",), (n, H, vd, d), (H * vd) ** -0.5 * out),
        (a + ("norm",), (n, d), None),
        (a + ("kv_norm",), (n, lora), None),
        (a + ("q_norm",), (n, ql), None),
    ]


def leaves(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                    Optional[float]]]:
    """(path, shape, scale) of every parameter leaf in the port's layout:
    the leading dense layers stacked under ``dense_layers``, the expert
    layers under ``layers``. ``scale`` is the standard deviation of a
    weight's normal draw; ``None`` marks a norm's weight, drawn as 1 + 0.1
    N(0, 1).

    The draw: 1/sqrt(fan-in), but the embedding at 1 and each branch's
    output projection into the residual stream (``wo``, the FFNs' ``w2``)
    at 1/sqrt(fan-in) over sqrt(2 ``init_depth``), GPT-2's scaled
    initialisation over the published depth. The stream then carries its
    token, as a trained model's does, so that a row's tokens route as
    they would at first: at an embedding of 0.02, attention's running mean
    over the row outweighs the token, a row's tokens pick the same experts
    and the capacity drops most of their pairs. (Trained from here at the
    configuration's learning rate, with no warm-up, the router loses its
    balance within ~10 steps all the same.)"""
    s = sizes(cfg)
    d, V, Ld, Lm = s["d"], s["V"], s["Ld"], s["L"] - s["Ld"]
    F, f, sf, E, held = s["F"], s["f"], s["S"] * s["f"], s["E"], s["held"]
    o = (2 * cfg["init_depth"]) ** -0.5
    out = [(("embed",), (V, d), 1.0),
           (("unembed",), (d, V), d ** -0.5),
           (("final_norm",), (d,), None)]
    if Ld:
        dn = ("dense_layers", "ffn")
        out += _attn_leaves(("dense_layers",), Ld, s, o) + [
            (dn + ("w1",), (Ld, d, F), d ** -0.5),
            (dn + ("w3",), (Ld, d, F), d ** -0.5),
            (dn + ("w2",), (Ld, F, d), F ** -0.5 * o),
            (dn + ("norm",), (Ld, d), None)]
    m = ("layers", "moe")
    out += _attn_leaves(("layers",), Lm, s, o) + [
        (m + ("w_router",), (Lm, d, E), d ** -0.5),
        (m + ("w1",), (Lm, held, d, f), d ** -0.5),
        (m + ("w3",), (Lm, held, d, f), d ** -0.5),
        (m + ("w2",), (Lm, held, f, d), f ** -0.5 * o),
        (m + ("norm",), (Lm, d), None)]
    if s["S"]:
        out += [(m + ("shared", "w1"), (Lm, d, sf), d ** -0.5),
                (m + ("shared", "w3"), (Lm, d, sf), d ** -0.5),
                (m + ("shared", "w2"), (Lm, sf, d), sf ** -0.5 * o)]
    return out


# ------------------------------------------------------------ the work --
def matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies by in one forward pass on this chip:
    every layer's attention projections (the query's and the latent's
    low-rank pairs included), the dense layers' FFN, each expert layer's
    router, shared expert and its ``K`` routed experts' share held here
    (K times held / router_outputs experts' weights), and the unembedding
    over the slice. The embedding is a lookup and counts nothing."""
    s = sizes(cfg)
    d, H, lora, ql = s["d"], s["H"], s["lora"], s["qlora"]
    attn = (d * ql + ql * H * (s["nope"] + s["rope"]) + d * lora
            + d * s["rope"] + lora * H * (s["nope"] + s["vd"])
            + H * s["vd"] * d)
    dense = 3 * d * s["F"]
    moe = (d * s["E"] + 3 * d * s["f"] * s["S"]
           + 3 * d * s["f"] * s["K"] * s["held"] // s["E"])
    return (s["L"] * attn + s["Ld"] * dense + (s["L"] - s["Ld"]) * moe
            + d * s["V"])


def attn_pair_flops(cfg: Dict) -> int:
    """FLOPs of one (query, key) pair over all layers: scores over ``nope
    + rope`` dims and the weighted sum over ``v`` dims, for every head."""
    s = sizes(cfg)
    return s["L"] * 2 * s["H"] * (s["nope"] + s["rope"] + s["vd"])


def capacity(cfg: Dict, T: int) -> int:
    """Pairs an expert takes in one row of a forward call of T tokens,
    counted over the routed-over experts."""
    c = int(math.ceil(T * cfg["num_experts_per_tok"] * cfg["capacity_factor"]
                      / cfg["router_outputs"]))
    return max(4, -(-c // 4) * 4)


# ------------------------------------------------------------------ YaRN --
def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(cfg: Dict, dim: int, device) -> Tuple[torch.Tensor, float, float]:
    """(inverse frequencies [dim/2], the factor on cos and sin, the factor
    on the softmax scale) of the file's ``rope_scaling``; plain RoPE's
    frequencies and 1, 1 where it is absent or its factor is at most 1."""
    theta = cfg["rope_theta"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    rs = cfg.get("rope_scaling")
    if rs is None or rs["factor"] <= 1:
        return extra, 1.0, 1.0
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs!r} is not YaRN")
    fac, L0 = rs["factor"], rs["original_max_position_embeddings"]
    corr = lambda rot: (dim * math.log(L0 / (rot * 2 * math.pi))
                        / (2 * math.log(theta)))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inter = 1.0 / (fac * theta ** exps)
    inv = inter * ramp + extra * (1.0 - ramp)
    m_all = rs.get("mscale_all_dim") or 0
    cos_sin = _mscale(fac, rs["mscale"]) / _mscale(fac, m_all)
    return inv, cos_sin, (_mscale(fac, m_all) ** 2 if m_all else 1.0)


def rotate(x, pos, inv: torch.Tensor, m: float):
    """Rotary embedding of x [B, T, *, D] at positions [T]: the two halves
    of the last dim turn by position * inv, cos and sin times m."""
    ang = pos.float()[:, None] * inv                        # [T, D/2]
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (x.shape[-1] // 2,)
    cos = (torch.cos(ang) * m).reshape(shape)
    sin = (torch.sin(ang) * m).reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------- blocks --
def attention(p, x, pos, cfg: Dict, num: Numerics):
    s = sizes(cfg)
    eps = cfg["rms_norm_eps"]
    nope, rope = s["nope"], s["rope"]
    inv, m, sm = yarn(cfg, rope, x.device)
    h = rms_norm(x, p["norm"], eps)
    cq = rms_norm(num.mm("btd,dl->btl", h, p["w_dq"]), p["q_norm"], eps)
    q = num.mm("btl,lhk->bthk", cq, p["w_uq"])
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], pos, inv, m)], -1)
    c = rms_norm(num.mm("btd,dl->btl", h, p["w_dkv"]), p["kv_norm"], eps)
    kr = rotate(num.mm("btd,dr->btr", h, p["w_kr"])[:, :, None], pos, inv, m)
    kn = num.mm("btl,lhn->bthn", c, p["w_uk"])
    v = num.mm("btl,lhv->bthv", c, p["w_uv"])
    k = torch.cat([kn, kr.expand(*kn.shape[:3], rope)], -1)
    o = causal_attention(q, k, v, (nope + rope) ** -0.5 * sm, num)
    return x + num.mm("bthv,hvd->btd", o, p["wo"])


def route(p, h, cfg: Dict, num: Numerics, bias):
    """Sigmoid scores [B, T, E], the gates and expert ids [B, T, K] of the
    grouped selection over scores + ``bias``."""
    s = torch.sigmoid(num.mm("btd,de->bte", h, p["w_router"]))
    B, T, E = s.shape
    G, K = cfg["n_group"], cfg["num_experts_per_tok"]
    biased = s.detach() + bias
    group = biased.reshape(B, T, G, E // G).topk(2, dim=-1).values.sum(-1)
    gid = group.topk(cfg["topk_group"], dim=-1).indices
    live = torch.zeros((B, T, G), dtype=torch.bool, device=h.device)
    live.scatter_(-1, gid, True)
    live = live[..., None].expand(B, T, G, E // G).reshape(B, T, E)
    ids = biased.masked_fill(~live, float("-inf")).topk(K, dim=-1).indices
    w = s.gather(-1, ids)
    return s, w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"], ids


def kept(ids, cfg: Dict):
    """Which (token, rank) pairs their expert takes: an expert takes the
    first ``capacity(T)`` pairs of a row in (token, rank) order."""
    B, T, K = ids.shape
    oh = torch.nn.functional.one_hot(ids.reshape(B, -1), cfg["router_outputs"])
    slot = ((torch.cumsum(oh, 1) - oh) * oh).sum(-1)
    return (slot < capacity(cfg, T)).reshape(B, T, K)


def balance(s, ids, E: int):
    """The sequence-wise balance loss, averaged over rows."""
    B, T, K = ids.shape
    f = torch.zeros((B, E), device=s.device)
    f.scatter_add_(1, ids.reshape(B, -1), torch.ones((B, T * K),
                                                     device=s.device))
    P = (s / s.sum(-1, keepdim=True)).mean(1)
    return ((f * E / (K * T)) * P).sum(-1).mean()


def moe(p, x, cfg: Dict, num: Numerics, bias):
    """The expert layer's share; returns (x + y, the balance loss, each
    routed-over expert's selections)."""
    B, T, d = x.shape
    s_ = sizes(cfg)
    E, first, held = s_["E"], s_["first"], s_["held"]
    h = rms_norm(x, p["norm"], cfg["rms_norm_eps"])
    s, gates, ids = route(p, h, cfg, num, bias)
    keep = kept(ids, cfg)
    hf = h.reshape(B * T, d)
    y = torch.zeros_like(hf)
    tok = torch.arange(B * T, device=x.device)[:, None].expand(
        B * T, ids.shape[-1])
    flat_ids, flat_keep = ids.reshape(B * T, -1), keep.reshape(B * T, -1)
    g = gates.reshape(B * T, -1)
    for j in range(held):
        sel = flat_keep & (flat_ids == first + j)
        if sel.any():
            t = tok[sel]
            out = swiglu(hf[t], p["w1"][j], p["w3"][j], p["w2"][j], num)
            y = y.index_add(0, t, out * g[sel][:, None])
    if s_["S"]:
        sp = p["shared"]
        y = y + swiglu(hf, sp["w1"], sp["w3"], sp["w2"], num)
    loads = torch.bincount(ids.reshape(-1), minlength=E)
    return x + y.reshape(B, T, d), balance(s, ids, E), loads


def dense_ffn(p, x, cfg: Dict, num: Numerics):
    h = rms_norm(x, p["norm"], cfg["rms_norm_eps"]).reshape(-1, x.shape[-1])
    return x + swiglu(h, p["w1"], p["w3"], p["w2"], num).reshape(x.shape)


def _pick(tree, i: int):
    """Layer ``i``'s view of stacked leaves, in float32."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i].float()


def router_bias(params, cfg: Dict) -> torch.Tensor:
    """The expert layers' selection biases [L - Ld, E] that ``params``
    carries (zeros before its first ``loss`` call)."""
    if "router_bias" not in params:
        s = sizes(cfg)
        params["router_bias"] = torch.zeros(
            (s["L"] - s["Ld"], s["E"]), device=params["embed"].device)
    return params["router_bias"]


# ----------------------------------------------------------------- train --
def loss(params, cfg: Dict, tokens, num: Numerics, remat: bool = True):
    """Mean next-token cross entropy over ``tokens`` [B, T] (the last
    position has no label) plus ``balance_loss_alpha`` times the expert
    layers' summed balance losses; each layer recomputed in the backward
    when ``remat``. Moves the biases ``params`` carries once, after the
    forward, by this call's selections."""
    B, T = tokens.shape
    Ld = cfg["first_k_dense_replace"]
    bias = router_bias(params, cfg)
    x = params["embed"][tokens].float()
    pos = torch.arange(T, device=tokens.device)
    aux = x.new_zeros(())
    loads = []
    for i in range(cfg["num_hidden_layers"]):
        dense = i < Ld
        p = _pick(params["dense_layers" if dense else "layers"],
                  i if dense else i - Ld)
        b = None if dense else bias[i - Ld]

        def fn(x, p, b=b, dense=dense):
            x = attention(p["attn"], x, pos, cfg, num)
            if dense:
                return dense_ffn(p["ffn"], x, cfg, num), x.new_zeros(()), None
            return moe(p["moe"], x, cfg, num, b)
        x, a, n = (checkpoint(fn, x, p, use_reentrant=False) if remat
                   else fn(x, p))
        aux = aux + a
        if n is not None:
            loads.append(n)
    with torch.no_grad():
        n = torch.stack(loads).float()
        params["router_bias"] = bias + cfg["bias_update_speed"] * torch.sign(
            n.mean(-1, keepdim=True) - n)
    h = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = num.mm("btd,dv->btv", h[:, :-1], params["unembed"])
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return ce + cfg["balance_loss_alpha"] * aux
