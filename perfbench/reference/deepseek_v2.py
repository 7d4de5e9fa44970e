"""Plain PyTorch reference of the DeepSeek-V2 decoder, with the semantics
that the configuration files under ``perfbench/configs`` state.

Each layer is multi-head latent attention (MLA: queries of ``nope + rope``
dims a head, keys and values expanded from a normed latent of
``kv_lora_rank``, one rope key shared by all heads, causal softmax at
scale ``(nope + rope) ** -0.5``) and a mixture of experts (a softmax router
in fp32, the top ``num_experts_per_tok`` experts a token with their gates
renormalised to sum 1, at most ``capacity`` pairs an expert in each row of
each forward call, counted in (token, rank) order, the rest dropped; SwiGLU
experts and ``n_shared_experts`` shared experts as one SwiGLU of that many
times the width), each behind an RMSNorm and a residual; a final RMSNorm
and an untied unembedding. Rotary embeddings rotate the two halves of each
rope vector; a ``rope_scaling`` group is taken only as YaRN's identity
(``factor`` 1: the same frequencies, mscale 1), any other is refused.
Training adds the mean next-token cross entropy and ``aux_loss_coef``
times the switch-style load-balance loss of every layer.

It reads the parameters in the port's layout (``leaves``), which the
harness draws from the seed and hands to both sides, and imports nothing of
the port. ``Numerics("fp32")`` computes every product in float32 with TF32
off; ``Numerics("fp8")`` rounds both operands of every product to float8
(e4m3, one scale a tensor) first: the control that has to fail the check;
``Numerics("bf16")`` rounds operands and products to bfloat16, a witness of
what rounding at the served precision does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


# ---------------------------------------------------------------- layout --
def sizes(cfg: Dict) -> Dict[str, int]:
    return dict(
        d=cfg["hidden_size"], L=cfg["num_hidden_layers"],
        H=cfg["num_attention_heads"], V=cfg["vocab_size"],
        nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
        vd=cfg["v_head_dim"], lora=cfg["kv_lora_rank"],
        E=cfg["n_routed_experts"], K=cfg["num_experts_per_tok"],
        f=cfg["moe_intermediate_size"], S=cfg["n_shared_experts"])


def leaves(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                    Optional[float]]]:
    """(path, shape, scale) of every parameter leaf, layers stacked first,
    in the port's layout. ``scale`` is the standard deviation of a weight's
    normal draw; ``None`` marks a norm's weight, drawn as 1 + 0.1 N(0, 1)."""
    s = sizes(cfg)
    d, L, H, V = s["d"], s["L"], s["H"], s["V"]
    nope, rope, vd, lora = s["nope"], s["rope"], s["vd"], s["lora"]
    E, f, sf = s["E"], s["f"], s["S"] * s["f"]
    a, m = ("layers", "attn"), ("layers", "moe")
    out = [
        (("embed",), (V, d), 0.02),
        (("unembed",), (d, V), d ** -0.5),
        (("final_norm",), (d,), None),
        (a + ("wq",), (L, d, H, nope + rope), d ** -0.5),
        (a + ("w_dkv",), (L, d, lora), d ** -0.5),
        (a + ("w_kr",), (L, d, rope), d ** -0.5),
        (a + ("w_uk",), (L, lora, H, nope), lora ** -0.5),
        (a + ("w_uv",), (L, lora, H, vd), lora ** -0.5),
        (a + ("wo",), (L, H, vd, d), (H * vd) ** -0.5),
        (a + ("norm",), (L, d), None),
        (a + ("kv_norm",), (L, lora), None),
        (m + ("w_router",), (L, d, E), d ** -0.5),
        (m + ("w1",), (L, E, d, f), d ** -0.5),
        (m + ("w3",), (L, E, d, f), d ** -0.5),
        (m + ("w2",), (L, E, f, d), f ** -0.5),
        (m + ("norm",), (L, d), None),
    ]
    if s["S"]:
        out += [(m + ("shared", "w1"), (L, d, sf), d ** -0.5),
                (m + ("shared", "w3"), (L, d, sf), d ** -0.5),
                (m + ("shared", "w2"), (L, sf, d), sf ** -0.5)]
    return out


# ------------------------------------------------------------ the work --
def matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies by in one forward pass: every layer's
    attention projections (the latent's up projections included), router,
    shared experts and ``K`` routed experts, and the unembedding. The
    embedding is a lookup and counts nothing."""
    s = sizes(cfg)
    d, H, lora = s["d"], s["H"], s["lora"]
    attn = (d * H * (s["nope"] + s["rope"]) + d * lora + d * s["rope"]
            + lora * H * (s["nope"] + s["vd"]) + H * s["vd"] * d)
    moe = d * s["E"] + 3 * d * s["f"] * (s["K"] + s["S"])
    return s["L"] * (attn + moe) + d * s["V"]


def attn_pair_flops(cfg: Dict) -> int:
    """FLOPs of one (query, key) pair of one layer: scores over ``nope +
    rope`` dims and the weighted sum over ``v`` dims, for every head."""
    s = sizes(cfg)
    return s["L"] * 2 * s["H"] * (s["nope"] + s["rope"] + s["vd"])


def capacity(cfg: Dict, T: int) -> int:
    """Pairs an expert takes in one row of a forward call of T tokens."""
    c = int(math.ceil(T * cfg["num_experts_per_tok"] * cfg["capacity_factor"]
                      / cfg["n_routed_experts"]))
    return max(4, -(-c // 4) * 4)


# -------------------------------------------------------------- numerics --
class Numerics:
    """Every product's operands in float32 ("fp32", TF32 off); rounded to
    float8 e4m3 with one scale a tensor first ("fp8", the control); or
    operands and products rounded to bfloat16 ("bf16", a witness of what
    rounding alone does). Rounding is straight-through under autograd."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.precision == "fp32":
            return t
        if self.precision == "bf16":
            r = t.detach().to(torch.bfloat16).float()
        else:
            s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
            r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t.detach())

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = torch.einsum(eq, self.q(a), self.q(b))
        return self.q(out) if self.precision == "bf16" else out


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- blocks --
def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope_theta(cfg: Dict) -> float:
    """The rotary base, once the file's ``rope_scaling`` is known to
    leave the rotation plain: absent, or YaRN at ``factor`` 1 or less,
    where its interpolated and extrapolated frequencies are the same and
    its mscale is 1 on cos, sin and the softmax scale."""
    rs = cfg.get("rope_scaling")
    if rs is not None and (rs.get("type") != "yarn" or rs["factor"] > 1):
        raise ValueError(f"{cfg.get('name')}: rope_scaling {rs!r} is not "
                         "plain RoPE, which is all this reference rotates")
    return cfg["rope_theta"]


def rotate(x, pos, theta: float):
    """Rotary embedding of x [B, T, *, D] at positions [T]: the two halves
    of the last dim turn by position * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = pos.float()[:, None] * inv                        # [T, D/2]
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (D // 2,)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, num: Numerics,
                     chunk: int = 1024):
    """softmax(q k^T scale, causal) v for q, k [B, T, H, D], v [B, T, H,
    Dv], a row and a block of queries at a time."""
    B, T = q.shape[:2]
    rows = []
    for b in range(B):
        parts = []
        for i in range(0, T, chunk):
            j = min(i + chunk, T)
            s = num.mm("qhd,thd->hqt", q[b, i:j], k[b, :j]) * scale
            live = (torch.arange(j, device=q.device)[None, :]
                    <= torch.arange(i, j, device=q.device)[:, None])
            s = s.masked_fill(~live, float("-inf"))
            p = torch.softmax(s, dim=-1)
            parts.append(num.mm("hqt,thv->qhv", p, v[b, :j]))
        rows.append(torch.cat(parts, 0))
    return torch.stack(rows)


def attention(p, x, pos, cfg: Dict, num: Numerics):
    s = sizes(cfg)
    eps, theta = cfg["rms_norm_eps"], rope_theta(cfg)
    nope, rope = s["nope"], s["rope"]
    h = rms_norm(x, p["norm"], eps)
    q = num.mm("btd,dhk->bthk", h, p["wq"])
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], pos, theta)], -1)
    c = rms_norm(num.mm("btd,dl->btl", h, p["w_dkv"]), p["kv_norm"], eps)
    kr = rotate(num.mm("btd,dr->btr", h, p["w_kr"])[:, :, None], pos, theta)
    kn = num.mm("btl,lhn->bthn", c, p["w_uk"])
    v = num.mm("btl,lhv->bthv", c, p["w_uv"])
    k = torch.cat([kn, kr.expand(*kn.shape[:3], rope)], -1)
    o = causal_attention(q, k, v, (nope + rope) ** -0.5, num)
    return x + num.mm("bthv,hvd->btd", o, p["wo"])


def route(p, h, cfg: Dict, num: Numerics):
    """Router probabilities [B, T, E] and the top-K gates (renormalised)
    and expert ids [B, T, K], largest probability first."""
    probs = torch.softmax(num.mm("btd,de->bte", h, p["w_router"]), dim=-1)
    top, ids = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    return probs, top / top.sum(-1, keepdim=True), ids


def kept(ids, cfg: Dict, segments: Sequence[Tuple[int, int]]):
    """Which (token, rank) pairs their expert takes: in each row and each
    forward call (a segment of positions), an expert takes the first
    ``capacity(len)`` pairs in (token, rank) order."""
    B, T, K = ids.shape
    E = cfg["n_routed_experts"]
    keep = torch.zeros_like(ids, dtype=torch.bool)
    for a, z in segments:
        flat = ids[:, a:z].reshape(B, -1)
        oh = torch.nn.functional.one_hot(flat, E)
        slot = ((torch.cumsum(oh, 1) - oh) * oh).sum(-1)
        keep[:, a:z] = (slot < capacity(cfg, z - a)).reshape(B, z - a, K)
    return keep


def swiglu(x, w1, w3, w2, num: Numerics):
    g = num.mm("td,df->tf", x, w1)
    return num.mm("tf,fd->td", torch.nn.functional.silu(g)
                  * num.mm("td,df->tf", x, w3), w2)


def moe(p, x, cfg: Dict, num: Numerics, segments):
    """The expert layer; returns (x + y, the switch-style balance loss of
    its rows: E * sum_e (kept pairs of e / T) * (mean probability of e),
    averaged over rows, the counts taken as constants)."""
    B, T, d = x.shape
    E = cfg["n_routed_experts"]
    h = rms_norm(x, p["norm"], cfg["rms_norm_eps"])
    probs, gates, ids = route(p, h, cfg, num)
    keep = kept(ids, cfg, segments)
    tok = torch.arange(B * T, device=x.device)[:, None].expand(B * T, ids.shape[-1])
    sel = keep.reshape(-1).nonzero()[:, 0]
    e_sel = ids.reshape(-1)[sel]
    order = torch.argsort(e_sel, stable=True)
    sel, e_sel = sel[order], e_sel[order]
    counts = torch.bincount(e_sel, minlength=E).tolist()
    tok_sel, g_sel = tok.reshape(-1)[sel], gates.reshape(-1)[sel]
    hf = h.reshape(B * T, d)
    y = torch.zeros_like(hf)
    start = 0
    for e, n in enumerate(counts):
        if n:
            t = tok_sel[start:start + n]
            out = swiglu(hf[t], p["w1"][e], p["w3"][e], p["w2"][e], num)
            y = y.index_add(0, t, out * g_sel[start:start + n, None])
        start += n
    if cfg["n_shared_experts"]:
        sp = p["shared"]
        y = y + swiglu(hf, sp["w1"], sp["w3"], sp["w2"], num)
    density = torch.zeros((B, E), device=x.device)
    density.index_put_((torch.arange(B, device=x.device)[:, None, None]
                        .expand_as(ids)[keep], ids[keep]),
                       torch.ones((), device=x.device), accumulate=True)
    aux = ((density / T) * probs.mean(1)).sum(-1).mean() * E
    return x + y.reshape(B, T, d), aux


def layer_params(params, i: int):
    """Layer ``i``'s view of the stacked leaves, in float32."""
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[i].float()
    return pick(params["layers"])


def layer(p, x, pos, cfg, num, segments):
    x = attention(p["attn"], x, pos, cfg, num)
    return moe(p["moe"], x, cfg, num, segments)


# ----------------------------------------------------------------- serve --
@torch.no_grad()
def served_logits(params, cfg: Dict, groups, num: Numerics) -> List:
    """Logits [n, P, V] (fp32) at chosen positions of each group of rows.

    ``groups``: a list of (tokens [n, T] int64, prefill_len, positions);
    each row is served as a request is: one forward call over its first
    ``prefill_len`` tokens (its prompt), then one call a token. The layers run
    one at a time over every group, so that one layer's weights are held in
    float32 at once."""
    eps = cfg["rms_norm_eps"]
    xs, poss, segs = [], [], []
    for toks, plen, _ in groups:
        T = toks.shape[1]
        xs.append(params["embed"][toks].float())
        poss.append(torch.arange(T, device=toks.device))
        segs.append([(0, plen)] + [(t, t + 1) for t in range(plen, T)])
    with no_tf32():
        for i in range(cfg["num_hidden_layers"]):
            p = layer_params(params, i)
            xs = [layer(p, x, pos, cfg, num, sg)[0]
                  for x, pos, sg in zip(xs, poss, segs)]
            del p
        out = []
        for x, (_, _, at) in zip(xs, groups):
            h = rms_norm(x[:, at], params["final_norm"], eps)
            out.append(num.mm("bpd,dv->bpv", h, params["unembed"]))
    return out


# ----------------------------------------------------------------- train --
def loss(params, cfg: Dict, tokens, num: Numerics, remat: bool = True):
    """Mean next-token cross entropy over ``tokens`` [B, T] (the last
    position has no label) plus ``aux_loss_coef`` times the layers' summed
    balance losses; each layer recomputed in the backward when ``remat``."""
    B, T = tokens.shape
    x = params["embed"][tokens].float()
    pos = torch.arange(T, device=tokens.device)
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params, i)
        fn = lambda x, p: layer(p, x, pos, cfg, num, [(0, T)])
        x, a = (checkpoint(fn, x, p, use_reentrant=False) if remat
                else fn(x, p))
        aux = aux + a
    h = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = num.mm("btd,dv->btv", h[:, :-1], params["unembed"])
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return ce + cfg["aux_loss_coef"] * aux
