"""Decoder-only LM: the dense family, MoE over GQA attention or MLA
("moe": grok-1-314b, deepseek-v2-lite-16b), the attention-free RWKV6
("ssm"), recurrentgemma's RG-LRU + local attention ("hybrid") and
qwen2-vl-72b ("vlm": M-RoPE over 3-D positions, precomputed embeddings in
place of tokens where the batch gives them).

Params keep the JAX reference's layout: a nested dict with the stacked
``layers`` dim first (for the hybrid family: superblocks of
``block_pattern``, plus a list ``rem`` of the layers left over), so the
bridge to the reference is a map over names and checkpoints stay
cross-loadable. The reference scans layers with ``lax.scan``; PyTorch runs
eagerly, so here it is a Python loop over the stacked dim.

Training (``loss``, gradients through ``forward``) is ported for every
family: dense, the recurrent ones (ssm: RWKV6; hybrid: RG-LRU and local
attention), MoE (its dispatch and combine through the shuffle kernels'
autograd Functions, whose backwards launch each other's kernels; MLA's
full mode through ``_FlashAttention`` at Dv != D) and the VLM (from
``embeds`` at [B, 3, T] M-RoPE positions; ``embed`` then takes no part in
the loss). ``forward`` takes the layers with one ``unbind`` of each cast
stacked leaf (under autograd its backward is one ``stack``; slicing layer
i would write a zero tensor of the whole stack for each layer's
gradient), and when grad is enabled, a param requires it and
``cfg.remat == "layer"``, it rematerialises each layer, or each hybrid
superblock (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` of the scanned body; the hybrid's ``rem`` layers, which
the reference applies outside its scan, are not rematerialised. With no
grad, ``unbind`` gives the same views as slicing, so serving computes what
it did.

Sharding (``sharding.use_rules`` over a mesh, params and batch DTensors
with ``launch/mesh``'s placements): ``param_axes`` gives the reference's
logical axes leaf for leaf; each layer gathers its FSDP ("embed") dims
first (``_fsdp``), the reference's ``constrain`` points redistribute the
activations, and every kernel runs on each rank's shard through
``local_map``; a rematerialised layer carries the rules into its
recompute (``sharding.carry_rules``), which runs on autograd's device
thread. Outside ``use_rules`` none of this runs.

DeepSeek-V3 (``cfg.first_dense`` leading dense layers, ``cfg.bias_layers``
expert layers with a selection bias): the leading layers (MLA and a SwiGLU
FFN of ``d_ff``) are stacked in ``dense_layers``, in front of the stacked
expert layers in ``layers``, and applied and rematerialised as they are.
Each expert layer's router selects with a bias [E] that no gradient
touches. The biases are model state (``init_state``: ``router_bias``
[expert layers, E], zeros at first, and ``router_loads``, the selections
counted since the last update), which the train state carries beside the
params and a checkpoint saves with them (``repro_torch.model_state``). A
training forward adds its selections to the loads (its remat recompute,
which is given the same bias, counts nothing) and names
``update_router_bias`` as the step's update after the optimizer's: each
bias moves by ``bias_speed`` times sign(mean load - load) and the loads
are cleared. The loss adds ``balance_alpha`` times the layers'
sequence-wise balance losses in place of the switch loss. The port trains
it; serving it is not ported.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import model_state, trace
from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..sharding import (carry_rules, constrain, gather_fsdp, get_mesh,
                        layer_axes)
from . import blocks
from .common import check_gen, cross_entropy_loss, normal, param_dtype
from .moe_shardmap import (moe_shardmap_apply, moe_shardmap_axes,
                           moe_shardmap_init)

Pytree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_COEF = 0.01


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list (None kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def compute_cast(params, compute_dtype: str):
    """Weights of rank >= 2 in fp32 go to ``compute_dtype`` (the stacked
    layer norms included, as in the reference; unstacked vectors stay
    fp32). Idempotent: params that were cast already come back as they
    are."""
    dt = torch_dtype(compute_dtype)

    def cast(w):
        if w.dtype == torch.float32 and w.dim() >= 2:
            return w.to(dt)
        return w
    return tree_map(cast, params)


def stack_axes(axes):
    """A layer's logical axes -> the stacked leaves' (a leading "layers"
    dim on every leaf; a None leaf stays None)."""
    if isinstance(axes, dict):
        return {k: stack_axes(v) for k, v in axes.items()}
    return None if axes is None else ("layers", *axes)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params/cache tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int):
    """A stacked tree -> n per-layer trees, with one ``unbind`` a leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return [None] * n if tree is None else list(tree.unbind(0))


def _requires_grad(tree) -> bool:
    found = []
    tree_map(lambda t: found.append(t.requires_grad), tree)
    return torch.is_grad_enabled() and any(found)


def _stack(states):
    """Per-layer state dicts -> one dict of [L, ...] tensors."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


class LM:
    """Config-driven language model (dense, MoE, RWKV6, RG-LRU hybrid or
    VLM; MLA attention where ``cfg.kv_lora``). All state is explicit:
    params and caches are passed in and returned. ``attn_impl`` picks the attention of
    prefill, ``scan_impl`` the scan of RWKV6 (the wkv) and of RG-LRU (the
    diagonal scan: "kernel", or the sequential oracle for any other value),
    ``moe_impl`` the MoE block's dispatch and combine ("kernel": the
    shuffle kernels; "xla": the reference's dense dispatch mask); all
    default to the CUDA kernels (their plain versions on CPU tensors).
    ``mla_absorbed``: MLA decodes over the compressed latent cache with the
    up projections absorbed, instead of the expanded per-head cache (the
    default, as the reference's)."""

    def __init__(self, cfg: ArchConfig, attn_impl: str = "kernel",
                 scan_impl: str = "kernel", moe_impl: str = "kernel",
                 mla_absorbed: bool = False, device: DeviceLike = "cuda"):
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm") \
                or (cfg.family == "moe") != bool(cfg.n_experts):
            raise NotImplementedError(
                f"{cfg.name}: the LM runs the dense, moe, ssm (RWKV6), "
                f"hybrid (RG-LRU) and vlm families (family={cfg.family!r}, "
                f"n_experts={cfg.n_experts}); encdec is EncDecLM's")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.scan_impl = scan_impl
        self.moe_impl = moe_impl
        self.mla_absorbed = mla_absorbed
        self.device = resolve_device(device)
        # "train" or "eval" while ``forward`` runs (not in a recompute)
        self._pass: Optional[str] = None

    # ------------------------------------------------------------------ init
    def init_state(self) -> Dict[str, torch.Tensor]:
        """The model state that no gradient touches, as it starts: with
        selection biases, ``router_bias`` [cfg.bias_layers, E] fp32 zeros
        and ``router_loads`` [cfg.bias_layers, E] int64 zeros; else
        empty."""
        shape = (self.cfg.bias_layers, self.cfg.n_experts)
        if not shape[0]:
            return {}
        return {"router_bias": torch.zeros(shape, dtype=torch.float32,
                                           device=self.device),
                "router_loads": torch.zeros(shape, dtype=torch.int64,
                                            device=self.device)}

    def init(self, gen: Optional[torch.Generator],
             dtype: Optional[torch.dtype] = None) -> Pytree:
        """Random params drawn from ``gen``, which must live on the model's
        device. Same names and shapes as the reference's ``LM.init``. A
        model on ``meta`` (``models.model``'s specs) takes ``gen=None``.

        ``dtype`` (e.g. ``torch.bfloat16``): draw every leaf of rank >= 2
        directly in that type, so that each leaf is born in the type the
        compute cast would give it and no fp32 copy of a large leaf ever
        exists (grok-1-314b's expert weights are 25.8 GB a tensor in fp32
        at 4 layers). The default draws every leaf in fp32."""
        check_gen(gen, self.device)
        cfg = self.cfg
        L = cfg.n_layers
        emb, unemb = (cfg.vocab, cfg.d_model), (cfg.d_model, cfg.vocab)
        params = {
            "embed": normal(gen, emb, param_dtype(emb, dtype)).mul_(0.02),
            "unembed": normal(gen, unemb, param_dtype(unemb, dtype)).mul_(
                1.0 / math.sqrt(cfg.d_model)),
            "final_norm": blocks._norm_init(cfg, cfg.d_model, gen,
                                            dtype=dtype),
        }
        if cfg.family == "hybrid":
            n_super, n_rem = self._hybrid_split()
            layers = {}
            for i, kind in enumerate(cfg.block_pattern):
                t_init = blocks.rglru_init if kind == "rec" else \
                    blocks.attn_init
                layers[f"t{i}"] = t_init(gen, cfg, lead=(n_super,),
                                         dtype=dtype)
                layers[f"mlp{i}"] = blocks.ffn_init(gen, cfg, lead=(n_super,),
                                                    dtype=dtype)
            params["layers"] = layers
            params["rem"] = [{"t": blocks.rglru_init(gen, cfg, dtype=dtype),
                              "mlp": blocks.ffn_init(gen, cfg, dtype=dtype)}
                             for _ in range(n_rem)]
        elif cfg.family == "ssm":
            params["layers"] = {"rwkv": blocks.rwkv_init(gen, cfg, lead=(L,),
                                                         dtype=dtype)}
        else:
            attn_init = blocks.mla_init if cfg.kv_lora else blocks.attn_init
            if cfg.first_dense:
                Ld = cfg.first_dense
                params["dense_layers"] = {
                    "attn": attn_init(gen, cfg, lead=(Ld,), dtype=dtype),
                    "ffn": blocks.ffn_init(gen, cfg, lead=(Ld,),
                                           dtype=dtype)}
                L -= Ld
            params["layers"] = {"attn": attn_init(gen, cfg, lead=(L,),
                                                  dtype=dtype)}
            if cfg.n_experts:
                moe_init = (moe_shardmap_init if self._shardmap()
                            else blocks.moe_init)
                params["layers"]["moe"] = moe_init(gen, cfg, lead=(L,),
                                                   dtype=dtype)
            else:
                params["layers"]["ffn"] = blocks.ffn_init(gen, cfg, lead=(L,),
                                                          dtype=dtype)
        return params

    def param_axes(self) -> Pytree:
        """The logical axes of ``init``'s params, leaf for leaf as the
        reference's ``param_axes``: a tuple of names per leaf (None for an
        absent norm), the stacked leaves led by "layers"."""
        cfg = self.cfg
        axes = {"embed": ("vocab", None), "unembed": ("embed", "vocab"),
                "final_norm": blocks._norm_axes(cfg)}
        if cfg.family == "hybrid":
            _, n_rem = self._hybrid_split()
            layers = {}
            for i, kind in enumerate(cfg.block_pattern):
                layers[f"t{i}"] = (blocks.rglru_axes(cfg) if kind == "rec"
                                   else blocks.attn_axes(cfg))
                layers[f"mlp{i}"] = blocks.ffn_axes(cfg)
            axes["layers"] = stack_axes(layers)
            axes["rem"] = [{"t": blocks.rglru_axes(cfg),
                            "mlp": blocks.ffn_axes(cfg)}
                           for _ in range(n_rem)]
        elif cfg.family == "ssm":
            axes["layers"] = stack_axes({"rwkv": blocks.rwkv_axes(cfg)})
        else:
            layer = {"attn": (blocks.mla_axes(cfg) if cfg.kv_lora
                              else blocks.attn_axes(cfg))}
            if cfg.first_dense:
                axes["dense_layers"] = stack_axes(
                    {"attn": layer["attn"], "ffn": blocks.ffn_axes(cfg)})
            if cfg.n_experts:
                layer["moe"] = (moe_shardmap_axes(cfg) if self._shardmap()
                                else blocks.moe_axes(cfg))
            else:
                layer["ffn"] = blocks.ffn_axes(cfg)
            axes["layers"] = stack_axes(layer)
        return axes

    def init_with_axes(self, gen: Optional[torch.Generator],
                       dtype: Optional[torch.dtype] = None
                       ) -> Tuple[Pytree, Pytree]:
        return self.init(gen, dtype), self.param_axes()

    def _fsdp(self, p, key: str, i: Optional[int] = None):
        """Under a mesh, the params ``p`` of ``key`` ("layers": one layer or
        superblock; "rem": leftover layer ``i``; "top": the final norm and
        unembedding) with their FSDP dims gathered
        (``sharding.gather_fsdp``); ``p`` itself otherwise."""
        if get_mesh() is None:
            return p
        axes = self._axes
        if key == "layers":
            ax = self._layer_axes
        elif key == "rem":
            ax = axes["rem"][i]
        else:
            ax = {k: axes[k] for k in p}
        return gather_fsdp(p, ax)

    @functools.cached_property
    def _axes(self) -> Pytree:
        """``param_axes()``, reckoned once for ``_fsdp``."""
        return self.param_axes()

    @functools.cached_property
    def _layer_axes(self) -> Pytree:
        return layer_axes(self._axes["layers"])

    def _shardmap(self) -> bool:
        return self.cfg.moe_strategy == "expert_parallel_shardmap"

    def _hybrid_split(self) -> Tuple[int, int]:
        """(superblocks, layers left over): 38 layers of (rec, rec, attn)
        are 12 superblocks and 2 RG-LRU layers."""
        return divmod(self.cfg.n_layers, len(self.cfg.block_pattern))

    # ------------------------------------------------------------- forward
    def _compute_cast(self, params):
        """``compute_cast`` to the config's ``compute_dtype`` (the vectors
        of the hybrid's unstacked ``rem`` layers stay fp32)."""
        return compute_cast(params, self.cfg.compute_dtype)

    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=self.device).long()

    def _embed(self, params, batch):
        """``batch["embeds"]`` [B, T, d] where the config takes embedding
        inputs and the batch has them (a stubbed frontend's output), else
        the embedding of ``batch["tokens"]``; in ``compute_dtype``."""
        dt = torch_dtype(self.cfg.compute_dtype)
        if self.cfg.embed_inputs and "embeds" in batch:
            x = torch.as_tensor(batch["embeds"], device=self.device).to(dt)
        else:
            x = blocks.embed(params["embed"], self._tokens(batch)).to(dt)
        return constrain(x, ("batch", "seq", None))

    def _positions(self, batch, T: int, offset: int = 0) -> torch.Tensor:
        """[T] positions from ``offset``; with M-RoPE [B, 3, T]: the batch's
        ``positions`` (t, h, w) where it has them, else the same arange on
        all three."""
        pos = torch.arange(T, device=self.device) + offset
        if self.cfg.rope != "mrope":
            return pos
        if "positions" in batch:
            return torch.as_tensor(batch["positions"], device=self.device)
        B = batch["tokens" if "tokens" in batch else "embeds"].shape[0]
        return pos.expand(B, 3, T)

    def _layer_apply(self, p, x, positions, cache=None, pos=None,
                     prefill: bool = False, layer: Optional[int] = None,
                     dense: bool = False, bias=None, loads=None):
        """One layer (``layer``: its index, the ``pangea.layer`` span's
        attr; ``dense``: one of ``dense_layers``; ``bias`` and ``loads``:
        an expert layer's selection bias and its loads, which only a
        forward that is not a recompute adds to). Returns (x, cache or
        RWKV6 state, aux): aux is the MoE block's load-balance loss, 0.0
        for the other families. As in the reference, ``prefill`` takes
        ``blocks.moe_apply`` even under ``expert_parallel_shardmap``, which
        ``forward`` and decode honour."""
        with trace.span("pangea.layer", layer=layer):
            cfg = self.cfg
            p = self._fsdp(p, "layers")
            if cfg.family == "ssm":
                x, st = blocks.rwkv_apply(p["rwkv"], x, cfg=cfg, state=cache,
                                          scan_impl=self.scan_impl)
                return x, st, 0.0
            if cfg.kv_lora:
                x, c = blocks.mla_apply(p["attn"], x, cfg=cfg,
                                        positions=positions, cache=cache,
                                        pos=pos, attn_impl=self.attn_impl,
                                        absorbed=self.mla_absorbed)
            else:
                x, c = blocks.attn_apply(p["attn"], x, cfg=cfg,
                                         positions=positions, cache=cache,
                                         pos=pos, attn_impl=self.attn_impl)
            if dense or not cfg.n_experts:
                return blocks.ffn_apply(p["ffn"], x, cfg=cfg), c, 0.0
            if cfg.bias_layers:
                x, aux = blocks.moe_apply_grouped(
                    p["moe"], x, cfg=cfg, bias=bias,
                    loads=loads if self._pass == "train" else None,
                    count=self._pass is not None, layer=layer)
                return x, c, aux
            if self._shardmap() and not prefill:
                x, aux = moe_shardmap_apply(p["moe"], x, cfg=cfg)
            else:
                x, aux = blocks.moe_apply(p["moe"], x, cfg=cfg,
                                          impl=self.moe_impl)
            return x, c, aux

    def _rwkv_layers(self, params, x, states, seq: Optional[str] = "seq"):
        """RWKV6 layers over ``x``, layer i from ``states[i]``. Returns
        (logits, the new per-layer states stacked on a leading layer dim)."""
        new = []
        for i, st in enumerate(states):
            x, st, _ = self._layer_apply(_layer(params["layers"], i), x,
                                         None, cache=st, layer=i)
            new.append(st)
        return self._logits(params, x, seq), _stack(new)

    def _superblock_apply(self, p, x, positions, cache=None, pos=None,
                          max_len: Optional[int] = None,
                          layer: Optional[int] = None):
        """One hybrid superblock (``layer``: its index, the
        ``pangea.layer`` span's attr): each temporal block of ``block_pattern``
        (RG-LRU or local attention), each followed by a GeGLU FFN. With
        ``cache`` (decode), attention caches are updated in place and the
        RG-LRU states come back new. With ``max_len`` (prefill), the RG-LRU
        blocks start from the zero state and the decode caches, attention's
        sized by ``max_len``, come back."""
        with trace.span("pangea.layer", layer=layer):
            cfg = self.cfg
            dt = torch_dtype(cfg.kv_cache_dtype)
            p = self._fsdp(p, "layers")
            new_cache = {}
            for i, kind in enumerate(cfg.block_pattern):
                c = cache[f"t{i}"] if cache is not None else None
                if kind == "rec":
                    if max_len is not None:
                        c = blocks.rglru_state_init(cfg, x.shape[0], dt,
                                                    self.device)
                    x, c = blocks.rglru_apply(p[f"t{i}"], x, cfg=cfg, state=c,
                                              scan_impl=self.scan_impl)
                else:
                    if max_len is not None:
                        kv = blocks.attn_prefill_kv(p[f"t{i}"], x, cfg=cfg,
                                                    positions=positions)
                    x, c = blocks.attn_apply(p[f"t{i}"], x, cfg=cfg,
                                             positions=positions, cache=c,
                                             pos=pos, attn_impl=self.attn_impl)
                    if max_len is not None:
                        c = blocks.pack_prefill_cache(cfg, kv, max_len, dt)
                new_cache[f"t{i}"] = c
                x = blocks.ffn_apply(p[f"mlp{i}"], x, cfg=cfg, act="gelu")
            keep = cache is not None or max_len is not None
            return x, (new_cache if keep else None)

    def _rem_apply(self, params, x, states):
        """The RG-LRU layers left over after the superblocks, layer i from
        ``states[i]`` (None: no state). Returns (x, the new states)."""
        new = []
        for i, (rp, st) in enumerate(zip(params["rem"], states)):
            rp = self._fsdp(rp, "rem", i)
            x, st = blocks.rglru_apply(rp["t"], x, cfg=self.cfg, state=st,
                                       scan_impl=self.scan_impl)
            x = blocks.ffn_apply(rp["mlp"], x, cfg=self.cfg, act="gelu")
            new.append(st)
        return x, new

    def _logits(self, params, x, seq: Optional[str] = "seq"):
        """The final norm and the unembedding: logits constrained to
        ("batch", ``seq``, "vocab") (decode: ``seq=None``)."""
        params = self._fsdp({k: params.get(k) for k in
                             ("final_norm", "unembed")}, "top")
        x = blocks.apply_norm(self.cfg, params.get("final_norm"), x)
        logits = blocks.project(x, params["unembed"], "btd,dv->btv", "vocab")
        return constrain(logits, ("batch", seq, "vocab"))

    def _model_state(self, state):
        """The model state a forward reads: ``state``, else the open train
        step's (``model_state.current()``, whose update after the
        optimizer's this forward names), completed from ``init_state``;
        None for a model without state."""
        if not self.cfg.bias_layers:
            return None
        step = model_state.current()
        if state is None:
            if step is None:
                raise ValueError(
                    f"{self.cfg.name}: the routers' selection biases are "
                    "model state: pass the forward its state (init_state) "
                    "or run it in a train step")
            state = step.tree
        if "router_bias" not in state:
            state.update(self.init_state())
        if step is not None and step.tree is state:
            step.after_update("router_bias", self.update_router_bias)
        return state

    def forward(self, params, batch, state=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits, aux_loss). ``state``:
        the model state (``init_state``) of a model that has one, where no
        train step gives it (a training forward adds its selections to the
        loads)."""
        train = _requires_grad(params)
        state = self._model_state(state)
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1])
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        remat = train and self.cfg.remat == "layer"
        if self.cfg.family == "hybrid":
            n_super, _ = self._hybrid_split()
            for i, lp in enumerate(_unstack(params["layers"], n_super)):
                if remat:
                    x, _ = checkpoint(carry_rules(self._superblock_apply),
                                      lp, x, positions, layer=i,
                                      use_reentrant=False)
                else:
                    x, _ = self._superblock_apply(lp, x, positions, layer=i)
            x, _ = self._rem_apply(params, x, [None] * len(params["rem"]))
        else:
            Ld = self.cfg.first_dense
            stacks = [(params["dense_layers"], Ld, True)] if Ld else []
            stacks.append((params["layers"], self.cfg.n_layers - Ld, False))
            layers = [(lp, dense) for tree, n, dense in stacks
                      for lp in _unstack(tree, n)]
            self._pass = "train" if train else "eval"
            try:
                for i, (lp, dense) in enumerate(layers):
                    kw = dict(layer=i, dense=dense)
                    if state is not None and not dense:
                        j = i - Ld
                        kw.update(bias=state["router_bias"][j],
                                  loads=state["router_loads"][j])
                    if remat:
                        x, _, a = checkpoint(
                            carry_rules(self._layer_apply), lp, x, positions,
                            use_reentrant=False, **kw)
                    else:
                        x, _, a = self._layer_apply(lp, x, positions, **kw)
                    aux = aux + a
            finally:
                # a remat recompute, in the backward, counts nothing
                self._pass = None
        return self._logits(params, x), aux

    def loss(self, params, batch, state=None) -> torch.Tensor:
        """Mean next-token CE over ``batch["labels"] != -100`` plus
        ``AUX_COEF`` times the forward's aux loss, as the reference's
        (with selection biases: ``balance_alpha`` times the layers'
        balance losses). ``state``: as ``forward``'s."""
        logits, aux = self.forward(params, batch, state)
        # under a mesh the vocab is gathered first: the labels' gather
        # along a sharded dim has no DTensor strategy
        logits = constrain(logits, ("batch", "seq", None))
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        coef = (self.cfg.balance_alpha if self.cfg.bias_layers
                else AUX_COEF)
        return cross_entropy_loss(logits, labels) + coef * aux

    @torch.no_grad()
    def update_router_bias(self, state: Dict[str, torch.Tensor]) -> None:
        """Move each expert layer's selection bias in ``state`` by
        ``bias_speed`` times sign(mean load - load), from the selections
        counted since the last update, and clear them; in place, on the
        device, with no host sync."""
        loads = state["router_loads"].float()
        state["router_bias"].add_(torch.sign(loads.mean(-1, keepdim=True)
                                             - loads),
                                  alpha=self.cfg.bias_speed)
        state["router_loads"].zero_()

    # ------------------------------------------------------------- serving
    def _serves(self) -> None:
        if self.cfg.first_dense:
            raise NotImplementedError(
                f"{self.cfg.name}: serving leading dense layers is not "
                "ported; the port trains this architecture")

    def decode_cache_init(self, batch: int, max_len: int) -> Pytree:
        self._serves()
        cfg = self.cfg
        if cfg.family == "hybrid":
            dt = torch_dtype(cfg.kv_cache_dtype)
            n_super, n_rem = self._hybrid_split()
            sb = []
            for kind in cfg.block_pattern:
                if kind == "rec":
                    sb.append(blocks.rglru_state_init(cfg, batch, dt,
                                                      self.device))
                else:
                    sb.append(blocks.attn_cache_init(
                        cfg, batch, min(max_len, cfg.window or max_len), dt,
                        self.device))
            return {"super": {f"t{i}": _stack([c] * n_super)
                              for i, c in enumerate(sb)},
                    "rem": [blocks.rglru_state_init(cfg, batch, dt,
                                                    self.device)
                            for _ in range(n_rem)]}
        if cfg.family == "ssm":
            st = blocks.rwkv_state_init(cfg, batch,
                                        torch_dtype(cfg.kv_cache_dtype),
                                        self.device)
            return _stack([st] * cfg.n_layers)
        dt = torch_dtype(cfg.kv_cache_dtype)
        if cfg.kv_lora:
            c = blocks.mla_cache_init(cfg, batch, max_len, dt, self.device,
                                      absorbed=self.mla_absorbed)
        else:
            c = blocks.attn_cache_init(cfg, batch, max_len, dt, self.device)
        return {k: v.unsqueeze(0).repeat(cfg.n_layers, *([1] * v.dim()))
                for k, v in c.items()}

    def decode_step(self, params, batch, cache, pos: int):
        """One-token decode. batch: {"tokens": [B, 1]} (or "embeds"; with
        M-RoPE the [B, 3, 1] "positions" if given, else pos on all three).
        Returns (logits [B, 1, V], cache). An attention cache is updated in
        place; RWKV6 and RG-LRU states come back new, as the reference's
        scan returns them."""
        self._serves()
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        positions = self._positions(batch, 1, offset=int(pos))
        if self.cfg.family == "hybrid":
            n_super, _ = self._hybrid_split()
            new = []
            for j in range(n_super):
                x, c = self._superblock_apply(
                    _layer(params["layers"], j), x, positions,
                    cache=_layer(cache["super"], j), pos=pos, layer=j)
                new.append(c)
            x, rem = self._rem_apply(params, x, cache["rem"])
            # attention caches were written in place; RG-LRU states restack
            sup = {f"t{i}": (_stack([c[f"t{i}"] for c in new])
                             if kind == "rec" else cache["super"][f"t{i}"])
                   for i, kind in enumerate(self.cfg.block_pattern)}
            return self._logits(params, x, None), {"super": sup, "rem": rem}
        if self.cfg.family == "ssm":
            return self._rwkv_layers(
                params, x, [_layer(cache, i) for i in range(self.cfg.n_layers)],
                seq=None)
        for i in range(self.cfg.n_layers):
            x, _, _ = self._layer_apply(_layer(params["layers"], i), x,
                                        positions, cache=_layer(cache, i),
                                        pos=pos, layer=i)
        return self._logits(params, x, None), cache

    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Prompt processing; returns (logits, decode-ready cache).
        ``max_len`` sizes the kv cache (default: prompt length; local
        attention keeps at most ``window`` slots); RWKV6 returns the stacked
        per-layer states instead (``max_len`` unused), the hybrid family
        {"super": stacked superblock caches, "rem": [RG-LRU states]}. MLA's
        cache is recomputed from each layer's input after the layer ran
        (``blocks.mla_prefill_cache``), in ``decode_cache_init``'s form, as
        the reference does."""
        self._serves()
        cfg = self.cfg
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        T = x.shape[1]
        positions = self._positions(batch, T)
        if cfg.family == "hybrid":
            n_super, n_rem = self._hybrid_split()
            caches = []
            for j in range(n_super):
                x, c = self._superblock_apply(_layer(params["layers"], j), x,
                                              positions, max_len=max_len or T,
                                              layer=j)
                caches.append(c)
            st0 = blocks.rglru_state_init(cfg, x.shape[0],
                                          torch_dtype(cfg.kv_cache_dtype),
                                          self.device)
            x, rem = self._rem_apply(params, x, [st0] * n_rem)
            sup = {key: _stack([c[key] for c in caches]) for key in caches[0]}
            return self._logits(params, x), {"super": sup, "rem": rem}
        if cfg.family == "ssm":
            st0 = blocks.rwkv_state_init(cfg, x.shape[0],
                                         torch_dtype(cfg.kv_cache_dtype),
                                         self.device)
            return self._rwkv_layers(params, x, [st0] * cfg.n_layers)
        max_len = max_len or T
        dt = torch_dtype(cfg.kv_cache_dtype)
        caches = []
        for i in range(cfg.n_layers):
            lp = self._fsdp(_layer(params["layers"], i), "layers")
            if cfg.kv_lora:
                x_in = x
                x, _, _ = self._layer_apply(lp, x, positions, prefill=True,
                                            layer=i)
                caches.append(blocks.mla_prefill_cache(
                    lp["attn"], x_in, cfg=cfg, positions=positions,
                    max_len=max_len, dtype=dt, absorbed=self.mla_absorbed))
                continue
            kv = blocks.attn_prefill_kv(lp["attn"], x, cfg=cfg,
                                        positions=positions)
            caches.append(blocks.pack_prefill_cache(cfg, kv, max_len, dt))
            x, _, _ = self._layer_apply(lp, x, positions, prefill=True,
                                        layer=i)
        return self._logits(params, x), _stack(caches)
