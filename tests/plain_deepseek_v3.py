"""A plain float32 DeepSeek-V3, for the tests to hold the port to.

Plain ``torch`` only: no kernel, cache or batching of the port, and
nothing of JAX or of either package. It reads a configuration in the
public config's keys (``config_of`` makes one from the port's config) and
parameters in the port's layout (the leading dense layers stacked under
``dense_layers``, the expert layers under ``layers``), every product in
float32 with TF32 off (``fp32``).

- MLA with the query through its low-rank path: q = RMSNorm(x W_dq) W_uq;
  keys and values expanded from the normed latent; one rope key a token.
- YaRN: inverse frequencies blended over the ramp [low, high] between the
  plain ones and the plain ones over ``factor``; cos and sin times
  mscale(factor, mscale) / mscale(factor, mscale_all_dim), the softmax
  scale times mscale(factor, mscale_all_dim)^2.
- The router: sigmoid scores, selection over scores + bias in the top
  ``topk_group`` of ``n_group`` groups (a group's score: its two best
  biased scores summed), gates the chosen scores over their sum times
  ``routed_scaling_factor``; the sequence-wise balance loss.
- The share: the experts ``first .. first + held - 1`` of the
  ``router_outputs`` routed over, each taking the first ``capacity`` of a
  row's pairs in (token, rank) order, counted over all of them; the pairs
  to other experts left out. With ``held`` covering every expert this is
  the uncut model.
- The bias rule: b += gamma sign(mean load - load) after each step.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def config_of(cfg) -> dict:
    """The public config's keys for the port's ``PortArchConfig``."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.first_dense,
        "num_attention_heads": cfg.n_heads, "vocab_size": cfg.vocab,
        "q_lora_rank": cfg.q_lora, "kv_lora_rank": cfg.kv_lora,
        "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "intermediate_size": cfg.d_ff, "moe_intermediate_size": cfg.d_expert,
        "n_shared_experts": cfg.n_shared_experts,
        "num_experts_per_tok": cfg.top_k, "router_outputs": cfg.n_experts,
        "n_routed_experts": cfg.held, "first_held_expert": cfg.first_held,
        "n_group": cfg.n_group, "topk_group": cfg.topk_group,
        "routed_scaling_factor": cfg.routed_scaling,
        "scoring_func": cfg.scoring, "capacity_factor": cfg.capacity_factor,
        "balance_loss_alpha": cfg.balance_alpha,
        "bias_update_speed": cfg.bias_speed, "rms_norm_eps": 1e-6,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": {
            "type": "yarn", "factor": cfg.yarn_factor,
            "original_max_position_embeddings": cfg.yarn_original,
            "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
            "mscale": cfg.yarn_mscale,
            "mscale_all_dim": cfg.yarn_mscale_all_dim}}


def rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def mscale(factor, m):
    if factor <= 1:
        return 1.0
    return 0.1 * m * math.log(factor) + 1.0


def ramp(c) -> tuple:
    """YaRN's (low, high) for the rope dims of ``c``."""
    rs, d, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]
    L0 = rs["original_max_position_embeddings"]

    def dim_of(rot):
        return d * math.log(L0 / (rot * 2 * math.pi)) / (2 * math.log(base))
    return (max(math.floor(dim_of(rs["beta_fast"])), 0),
            min(math.ceil(dim_of(rs["beta_slow"])), d - 1))


def inv_freq(c):
    d, base = c["qk_rope_head_dim"], c["rope_theta"]
    plain = [base ** (-2 * i / d) for i in range(d // 2)]
    rs = c.get("rope_scaling")
    if not rs or rs["factor"] <= 1:
        return torch.tensor(plain)
    low, high = ramp(c)
    if low == high:
        high += 0.001
    out = []
    for i, p in enumerate(plain):
        r = min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(p * (1 - r) + p / rs["factor"] * r)
    return torch.tensor(out)


def rope_factors(c):
    """(factor on cos and sin, factor on the softmax scale)."""
    rs = c.get("rope_scaling")
    if not rs or rs["factor"] <= 1:
        return 1.0, 1.0
    f, m_all = rs["factor"], rs.get("mscale_all_dim") or 0
    att = mscale(f, m_all) ** 2 if m_all else 1.0
    return mscale(f, rs["mscale"]) / mscale(f, m_all), att


def rope(x, c):
    """x [B, T, *, D]: halves rotated at positions 0..T-1."""
    T, D = x.shape[1], x.shape[-1]
    ang = torch.arange(T, dtype=torch.float32)[:, None] * inv_freq(c)[None]
    m, _ = rope_factors(c)
    shape = (1, T) + (1,) * (x.dim() - 3) + (D // 2,)
    cos = (torch.cos(ang) * m).view(shape)
    sin = (torch.sin(ang) * m).view(shape)
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def attention(p, x, c):
    B, T, _ = x.shape
    nope, rd = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    h = rms(x, p["norm"])
    q = torch.einsum("btl,lhk->bthk", rms(h @ p["w_dq"], p["q_norm"]),
                     p["w_uq"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c)], -1)
    lat = rms(h @ p["w_dkv"], p["kv_norm"])
    kr = rope((h @ p["w_kr"])[:, :, None], c)
    kn = torch.einsum("btl,lhn->bthn", lat, p["w_uk"])
    v = torch.einsum("btl,lhv->bthv", lat, p["w_uv"])
    k = torch.cat([kn, kr.expand(-1, -1, kn.shape[2], -1)], -1)
    scale = (nope + rd) ** -0.5 * rope_factors(c)[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhv->bqhv", a, v)
    return x + torch.einsum("bthv,hvd->btd", o, p["wo"])


def swiglu(h, w1, w3, w2):
    return (F.silu(h @ w1) * (h @ w3)) @ w2


def route(p, h, c, bias, group_limit=True, scoring="sigmoid"):
    """Scores [B, T, E], gates and ids [B, T, K]. ``group_limit`` False
    and ``scoring`` "softmax" are the tests' wrong routers."""
    logits = h @ p["w_router"]
    s = torch.sigmoid(logits) if scoring == "sigmoid" else \
        torch.softmax(logits, -1)
    B, T, E = s.shape
    G, K = c["n_group"], c["num_experts_per_tok"]
    sel = s + bias
    if group_limit:
        gs = sel.view(B, T, G, E // G).topk(2, -1).values.sum(-1)
        keep = torch.zeros(B, T, G, dtype=torch.bool)
        keep.scatter_(-1, gs.topk(c["topk_group"], -1).indices, True)
        keep = keep.repeat_interleave(E // G, -1)
        sel = sel.masked_fill(~keep, float("-inf"))
    ids = sel.topk(K, -1).indices
    w = s.gather(-1, ids)
    return s, w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"], ids


def capacity(c, T):
    n = math.ceil(T * c["num_experts_per_tok"] * c["capacity_factor"]
                  / c["router_outputs"])
    return max(4, -(-n // 4) * 4)


def expert_share(p, h, c, s, gates, ids, first, held):
    """The routed output [B, T, d] of experts first..first+held-1, each
    taking its first ``capacity`` pairs of a row (counted over all)."""
    B, T, K = ids.shape
    C = capacity(c, T)
    y = torch.zeros_like(h)
    for b in range(B):
        seen = {}
        for t in range(T):
            for k in range(K):
                e = int(ids[b, t, k])
                n = seen.get(e, 0)
                seen[e] = n + 1
                if n < C and first <= e < first + held:
                    j = e - first
                    y[b, t] += gates[b, t, k] * swiglu(
                        h[b, t], p["w1"][j], p["w3"][j], p["w2"][j])
    return y


def balance(s, ids, E):
    B, T, K = ids.shape
    out = 0.0
    for b in range(B):
        f = torch.zeros(E)
        for e in ids[b].reshape(-1).tolist():
            f[e] += 1
        f = f * E / (K * T)
        P = (s[b] / s[b].sum(-1, keepdim=True)).mean(0)
        out = out + (f * P).sum()
    return out / B


def moe(p, x, c, bias, first=None, held=None, **route_kw):
    """(x + y, balance loss, each expert's selections [E])."""
    first = c["first_held_expert"] if first is None else first
    held = c["n_routed_experts"] if held is None else held
    h = rms(x, p["norm"])
    s, gates, ids = route(p, h, c, bias, **route_kw)
    y = expert_share(p, h, c, s, gates, ids, first, held)
    if c["n_shared_experts"]:
        sp = p["shared"]
        y = y + swiglu(h, sp["w1"], sp["w3"], sp["w2"])
    E = c["router_outputs"]
    loads = torch.bincount(ids.reshape(-1), minlength=E)
    return x + y, balance(s, ids, E), loads


def layer(tree, i):
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def forward(params, c, tokens, bias, **moe_kw):
    """(logits [B, T, V], summed balance loss, loads [expert layers, E])."""
    Ld = c["first_k_dense_replace"]
    x = params["embed"].float()[tokens]
    aux, loads = 0.0, []
    for i in range(c["num_hidden_layers"]):
        if i < Ld:
            p = layer(params["dense_layers"], i)
            x = attention(p["attn"], x, c)
            f = p["ffn"]
            x = x + swiglu(rms(x, f["norm"]), f["w1"], f["w3"], f["w2"])
        else:
            p = layer(params["layers"], i - Ld)
            x = attention(p["attn"], x, c)
            x, a, n = moe(p["moe"], x, c, bias[i - Ld], **moe_kw)
            aux, loads = aux + a, loads + [n]
    x = rms(x, params["final_norm"])
    return x @ params["unembed"].float(), aux, torch.stack(loads)


def loss(params, c, tokens, labels, bias, **moe_kw):
    """(mean CE over labels != -100 + alpha * balance, loads)."""
    logits, aux, loads = forward(params, c, tokens, bias, **moe_kw)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1), ignore_index=-100)
    return ce + c["balance_loss_alpha"] * aux, loads


def bias_step(bias, loads, gamma):
    n = loads.float()
    return bias + gamma * torch.sign(n.mean(-1, keepdim=True) - n)
