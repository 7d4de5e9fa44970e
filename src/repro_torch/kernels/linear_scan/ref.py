"""Plain PyTorch oracles for the linear-scan kernels:

* ``diag_scan_ref``: h_t = a_t * h_{t-1} + b_t, a vector state per channel
  (RG-LRU);
* ``gla_scan_ref``: the GLA scan (the RWKV6 wkv core),

    S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T,
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

  with w the LOG decays (w <= 0).

Both carry the state in fp32 (fp64 for fp64 inputs, the exact answer that
fp32 paths are measured against).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def diag_scan_ref(a: torch.Tensor, b: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, T, D]; h0: [B, D] in any float type (zeros without it).
    Walks T with the carry in fp32 and returns (h [B, T, D], h_T [B, D]),
    both in a's dtype."""
    B, T, D = a.shape
    acc = _acc_dtype(a)
    h = (torch.zeros((B, D), dtype=acc, device=a.device) if h0 is None
         else h0.to(acc))
    af, bf = a.to(acc), b.to(acc)
    hs = []
    for t in range(T):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else af[:, :0]
    return out.to(a.dtype), h.to(a.dtype)


def diag_scan_bwd_ref(a: torch.Tensor, h_prev: torch.Tensor, g: torch.Tensor,
                      gT: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``diag_scan_ref``: a diagonal scan run backwards in
    time. a, g: [B, T, D] (g the cotangent of h); h_prev: [B, T, D], h_{t-1}
    (the forward's h shifted by one, h0 or zeros in front); gT: [B, D], the
    cotangent of h_T, or None. With the carry mu in fp32 (mu = gT or 0 before
    the last step), walking t = T-1 down to 0:

        lam_t = g_t + mu,  db_t = lam_t,  da_t = lam_t * h_{t-1},
        mu = a_t * lam_t,

    each multiply and add rounded apart. Returns (da, db) in a's dtype and
    dh0 = a_0 lam_0 [B, D] in the carry's dtype."""
    B, T, D = a.shape
    acc = _acc_dtype(a)
    mu = (torch.zeros((B, D), dtype=acc, device=a.device) if gT is None
          else gT.to(acc))
    af, hf, gf = a.to(acc), h_prev.to(acc), g.to(acc)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(T - 1, -1, -1):
        lam = gf[:, t] + mu
        db[:, t] = lam.to(a.dtype)
        da[:, t] = (lam * hf[:, t]).to(a.dtype)
        mu = af[:, t] * lam
    return da, db, mu


def gla_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv, one token at a time.

    r, k, w: [B, T, Dk]; v: [B, T, Dv]; u: [B, Dk] (per-row bonus);
    s0: [B, Dk, Dv]. Returns (o [B, T, Dv] in v's dtype, s_final [B, Dk, Dv]
    in fp32, or fp64 when r is fp64).
    """
    B, T, Dk = r.shape
    Dv = v.shape[-1]
    acc = _acc_dtype(r)
    S = (torch.zeros((B, Dk, Dv), dtype=acc, device=r.device)
         if s0 is None else s0.to(acc))
    rf, kf, vf, wf, uf = (x.to(acc) for x in (r, k, v, w, u))
    os = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]            # [B, Dk, Dv]
        os.append(torch.einsum("bk,bkv->bv", rf[:, t],
                               S + uf[:, :, None] * kv))
        S = torch.exp(wf[:, t])[:, :, None] * S + kv
    o = torch.stack(os, dim=1) if os else vf[:, :0]
    return o.to(v.dtype), S
