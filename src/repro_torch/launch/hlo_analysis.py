"""Per-device cost counts for the roofline (``launch/dryrun``).

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
reads the post-partitioning HLO text. There is no HLO here: this module
reads the aten ops that run under a ``TorchDispatchMode``. Where an op
takes DTensors the mode steps aside (it returns ``NotImplemented``, as
``CommDebugMode`` does), DTensor turns the op into collectives and local
ops, and the mode counts those (not the fake-tensor runs at global shapes
by which DTensor finds each output's shape). So every count is PER
DEVICE, taken on local shapes:

* dot FLOPs      — ``mm``/``addmm`` (2·M·N·K) and ``bmm``/``baddbmm``
                   (2·B·M·N·K); an ``einsum`` or ``matmul`` reaches these;
* HBM bytes      — each op's result plus its tensor operands (views and
                   other ops that move no data count nothing), a traffic
                   model with no fusion;
* collective bytes and counts — the result size of each functional
  collective (all-gather, all-reduce, reduce-scatter, all-to-all), by type.

Python loops run, so a loop's body is counted once a trip: the analog of
the reference's trip-count scaling of ``while`` bodies. Run on ``meta``
tensors under a fake process group, nothing is computed or sent; the
counts are the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter",
               "all_to_all": "all-to-all"}

# ops that alias their input or only read metadata: no bytes move
_NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "select", "slice", "as_strided", "alias",
    "detach", "unbind", "split", "split_with_sizes", "chunk", "narrow",
    "diagonal", "view_as_real", "view_as_complex", "lift_fresh", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "unflatten", "flatten", "movedim", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "wait_tensor",
    "set_", "resize_", "_local_scalar_dense",
}


@dataclass
class HloStats:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def dot_flops(name: str, args) -> float:
    """2 x the multiply-adds of a matrix product op, from its operands'
    shapes (0 for any other op)."""
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0.0


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it into ``self.stats`` (an ``HloStats``)."""

    def __init__(self):
        super().__init__()
        self.stats = HloStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor split it first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shapes: no device runs it
            return out
        name = func._overloadpacket.__name__
        st = self.stats
        for key, kind in COLLECTIVES.items():
            if key in name:
                b = sum(_nbytes(t) for t in _tensors(out))
                st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) + b
                st.collective_count[kind] = st.collective_count.get(kind, 0) + 1
                return out
        st.dot_flops += dot_flops(name, args)
        if name not in _NO_TRAFFIC:
            st.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
            st.hbm_bytes += sum(_nbytes(t) for t in _tensors(args))
        return out


def count_costs(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its ``HloStats``)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
