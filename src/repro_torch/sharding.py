"""Logical-axis sharding rules on DTensor.

The port of the JAX package's ``sharding.py``. Models name the dims of
their weights and activations with *logical* axes; a rules table maps each
logical name to mesh axes. Inside ``use_rules(...)`` (set up by the
launcher), ``constrain(x, axes)`` redistributes a DTensor to the placements
those rules give, as the reference's ``with_sharding_constraint`` does;
outside, or on a plain tensor, it returns ``x`` itself, so models run
untouched on one device.

A spec is the per-dim tuple a ``PartitionSpec`` holds: ``None``
(replicated), a mesh axis name, or a tuple of names (the dim sharded over
several mesh axes, the first one outermost). ``placements_for`` turns it
into DTensor placements over a ``DeviceMesh`` built with
``mesh_dim_names``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

_state = threading.local()

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# default logical -> mesh-axis rules (single-pod); the launcher may override.
# None = replicated. A tuple means the dim is sharded over several mesh axes.
DEFAULT_RULES: Dict[str, Union[None, str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",        # FSDP/ZeRO shard axis for weights
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "expert_batch": None,
    "state": None,
    "conv": None,
    "lora": None,
    "pages": None,
    "kv_seq": None,
}


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names (any object with ``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names or ())


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: size}."""
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def spec_for(axes: Sequence[Optional[str]], rules: Optional[Dict] = None,
             mesh=None) -> Spec:
    """Logical axes -> spec under the active rules and mesh: a mesh axis
    appears at most once (the first dim wins), axes the mesh lacks are
    dropped, trailing Nones are trimmed."""
    rules = rules if rules is not None else get_rules()
    mesh = mesh if mesh is not None else get_mesh()
    names = set(mesh_axis_names(mesh)) if mesh is not None else set()
    out = []
    used = set()
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        if isinstance(m, str):
            m = (m,)
        m = tuple(a for a in m if a in names and a not in used)
        used.update(m)
        out.append(m if len(m) > 1 else (m[0] if m else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_for(spec: Spec, mesh) -> Tuple:
    """A spec -> one placement per mesh dim: ``Shard(d)`` on each mesh axis
    that tensor dim d is sharded over, ``Replicate()`` on the others."""
    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def even_spec(spec: Spec, shape, mesh) -> Spec:
    """``spec`` without the mesh axes of a dim they do not divide evenly
    (a kernel's shard must be whole: ``local_map`` rebuilds each output's
    global shape from its local one)."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = 1
        for a in names:
            n *= sizes[a]
        out.append(entry if shape[d] % n == 0 else None)
    return tuple(out)


def local_placements(axes: Sequence[Optional[str]], shape) -> Tuple:
    """The placements of a tensor of ``shape`` with logical ``axes`` under
    the active rules, every sharded dim split evenly."""
    mesh = get_mesh()
    return placements_for(even_spec(spec_for(axes), shape, mesh), mesh)


def sharded_axes(placements, dim: int) -> Tuple[str, ...]:
    """The mesh axes that shard tensor dim ``dim``."""
    names = mesh_axis_names(get_mesh())
    return tuple(n for n, p in zip(names, placements)
                 if isinstance(p, Shard) and p.dim == dim)


def partial_on(placements, axes: Sequence[str]) -> Tuple:
    """``placements`` with ``Partial()`` (a sum) on the mesh axes ``axes``:
    the gradient of a replicated input each of whose ranks used only a
    part of it."""
    names = mesh_axis_names(get_mesh())
    return tuple(Partial() if n in axes else p
                 for n, p in zip(names, placements))


def replicated_like(t, x):
    """``t`` as a replicated DTensor on ``x``'s mesh where ``x`` is a
    DTensor and ``t`` a plain tensor, else ``t``: for a constant (RoPE's
    positions) that meets a DTensor in an op whose backward keeps it. The
    backward runs without ``use_rules``' implicit replication on CUDA (the
    engine's own thread)."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    return distribute_tensor(t, x.device_mesh,
                             [Replicate()] * x.device_mesh.ndim,
                             src_data_rank=None)


def coordinate(axis: str) -> int:
    """This rank's index along mesh axis ``axis``."""
    return get_mesh().get_local_rank(axis)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor under active rules: a kernel call then
    goes through ``local_call``."""
    return isinstance(x, DTensor) and get_mesh() is not None


def _placed(a, placements, mesh):
    """An argument of ``local_call`` on its placements: a DTensor
    redistributed, a plain tensor (one every rank holds whole, as a zero
    state) cut to this rank's shard, anything else as it is."""
    if isinstance(a, DTensor):
        return a.redistribute(mesh, placements)
    if isinstance(a, torch.Tensor) and placements is not None:
        return distribute_tensor(a, mesh, placements, src_data_rank=None)
    return a


def local_call(fn, args, in_placements, out_placements,
               in_grad_placements=None):
    """``fn`` on each rank's shards, through ``local_map``: every DTensor
    argument is first redistributed to its placements (``in_placements``,
    None for an argument that is no DTensor), ``fn`` gets the local
    tensors, and its outputs come back as DTensors with
    ``out_placements``. Gradients flow through (``in_grad_placements``: an
    input's gradient placements, if not its own)."""
    mesh = get_mesh()
    args = [_placed(a, p, mesh) for a, p in zip(args, in_placements)]
    if isinstance(out_placements[0], Placement):   # one output
        out_placements = (out_placements,)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(in_grad_placements)),
                     device_mesh=mesh)(*args)


def _even(shape, placements, sizes, names) -> bool:
    for d in range(len(shape)):
        n = 1
        for a, pl in zip(names, placements):
            if isinstance(pl, Shard) and pl.dim == d:
                n *= sizes[a]
        if shape[d] % n:
            return False
    return True


def sharded_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two tensors (DTensors, or plain ones
    that count as replicated) on each rank's shards, through
    ``local_map``, with the layout read off the operands as GSPMD would:
    on each mesh axis, a letter sharded in one operand is sharded in the
    other too where that one has it (a free slice of a replicated
    operand), the output is sharded on it where the output has it and a
    partial sum where the letter is contracted; where the two operands are
    sharded on different letters, the second is gathered first. An
    operand's gradient is a partial sum on each axis where the other is
    sharded on a letter it lacks. Falls back to DTensor's own einsum where
    a shard would be uneven.

    DTensor's own einsum would do for each product alone, but in a whole
    step its strategies run the FFN's products (``btd,df->btf``,
    ``btf,fd->btd``) with the "mlp" dim whole on every "model" rank: under
    fsdp_tp, smoke qwen3-0.6b's train step takes 1.40x the per-device dot
    FLOPs on a (2, 4) mesh (``test_fsdp_tp_flops_per_device_as_reckoned``
    fails) and qwen3-0.6b's train_4k 1.28x at 16x16 (the dry-run)."""
    mesh = get_mesh()
    names, sizes = mesh_axis_names(mesh), mesh_sizes(mesh)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")

    def start(t):
        if not isinstance(t, DTensor):
            t = distribute_tensor(t, mesh, [Replicate()] * len(names),
                                  src_data_rank=None)
        return t, [Replicate() if isinstance(pl, Partial) else pl
                   for pl in t.placements]
    a, pa = start(a)
    b, pb = start(b)
    po, ga, gb = [], list(pa), list(pb)
    for i in range(len(names)):
        ca = la[pa[i].dim] if isinstance(pa[i], Shard) else None
        cb = lb[pb[i].dim] if isinstance(pb[i], Shard) else None
        if ca and cb and ca != cb:                  # conflict: gather b
            pb[i], cb = Replicate(), None
        if ca and not cb and ca in lb:
            pb[i], cb = Shard(lb.index(ca)), ca
        elif cb and not ca and cb in la:
            pa[i], ca = Shard(la.index(cb)), cb
        letter = ca or cb
        if letter is None:
            po.append(Replicate())
        elif letter in out:
            po.append(Shard(out.index(letter)))
        else:
            po.append(Partial())
        ga[i] = Partial() if cb and cb not in la else pa[i]
        gb[i] = Partial() if ca and ca not in lb else pb[i]
    oshape = [dict(zip(la, a.shape), **dict(zip(lb, b.shape)))[c]
              for c in out]
    if not (_even(a.shape, pa, sizes, names) and _even(b.shape, pb, sizes,
                                                         names)
            and _even(oshape, po, sizes, names)):
        return torch.einsum(eq, a, b)
    return local_call(lambda x, y: torch.einsum(eq, x, y), (a, b),
                      (tuple(pa), tuple(pb)), tuple(po),
                      (tuple(ga), tuple(gb)))


@contextlib.contextmanager
def use_rules(rules: Dict, mesh=None):
    """Activate ``rules`` over ``mesh``. With a mesh, a plain tensor that
    meets a DTensor counts as replicated (positions, masks, constants),
    as an unsharded value is in the reference's jit."""
    prev = (getattr(_state, "rules", None), getattr(_state, "mesh", None))
    _state.rules = rules
    _state.mesh = mesh
    try:
        if mesh is None:
            yield
        else:
            with _replicating():
                yield
    finally:
        _state.rules, _state.mesh = prev


@contextlib.contextmanager
def _replicating():
    """``implicit_replication()`` that restores the flag it found (the
    library's sets it off on exit, which would end an enclosing one: a
    recompute under ``carry_rules`` runs inside the backward of a step
    under ``use_rules``). The flag is per thread."""
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def carry_rules(fn):
    """``fn`` with the rules and mesh active now entered around each call:
    for a function that autograd calls again on its own thread. A
    rematerialised layer's recompute runs inside the backward, which on
    CUDA runs on the engine's device thread, where this thread's rules are
    not set. Outside ``use_rules``, ``fn`` itself."""
    rules, mesh = get_rules(), get_mesh()
    if rules is None and mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)
    return run


def get_rules() -> Optional[Dict]:
    return getattr(_state, "rules", None)


def get_mesh():
    return getattr(_state, "mesh", None)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the logical axes' placements when rules
    and a mesh are active; ``x`` itself otherwise. A dim that its mesh
    axes do not divide evenly stays whole (a batch of 1 on 16 "data"
    ranks): GSPMD pads such a shard, and DTensor's ops refuse to reshape
    an uneven one."""
    rules = get_rules()
    mesh = get_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    spec = even_spec(spec_for(axes, rules, mesh), x.shape, mesh)
    return x.redistribute(mesh, placements_for(spec, mesh))


def gather_fsdp(params, axes, logical: Sequence[str] = ("embed",)):
    """A layer's params with their FSDP dims whole: each DTensor leaf
    redistributed to the placements of its logical ``axes`` under the
    active rules with ``logical`` ("embed") unsharded, so that the layer's
    products run on whole weights beside the batch shard (the per-layer
    all-gather of FSDP; autograd reduce-scatters the gradients back).
    Outside ``use_rules``, or on plain tensors, ``params`` as they are."""
    rules, mesh = get_rules(), get_mesh()
    if rules is None or mesh is None:
        return params
    whole = dict(rules, **{a: None for a in logical})

    def one(t, ax):
        if isinstance(t, dict):
            return {k: one(v, ax[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [one(v, a) for v, a in zip(t, ax)]
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements_for(spec_for(ax, whole, mesh),
                                                   mesh))
    return one(params, axes)


def layer_axes(axes):
    """Stacked leaves' axes -> one layer's (the leading "layers" dropped)."""
    if isinstance(axes, dict):
        return {k: layer_axes(v) for k, v in axes.items()}
    return None if axes is None else tuple(axes[1:])


def constrain_seq(x):
    """Sequence-parallel residual-stream constraint: only emitted when the
    active rules shard "seq" (the fsdp_tp_sp preset), so the other presets
    run exactly as without it."""
    rules = get_rules()
    if rules is None or rules.get("seq") is None:
        return x
    return constrain(x, ("batch", "seq", None))
