"""Parameters drawn from the run's seed, on the device, one draw a leaf.

The leaves (path, shape, scale) come from the configuration's reference
module, in the layout the port reads. Leaf ``i`` is drawn from a generator
of its own, seeded from (seed, i), so that the check can draw any leaf
again without holding a copy. Leaves of rank >= 2 are drawn in the type
they are served or trained in; vectors in float32.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of a run seeded with ``seed`` (any
    integer: it is taken modulo 2**64 first)."""
    words = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(2)
    return (int(words[0]) << 32 | int(words[1])) & (2 ** 63 - 1)


def draw(leaf, seed: int, index: int, dtype: torch.dtype,
         device) -> torch.Tensor:
    _, shape, scale = leaf
    dt = dtype if len(shape) >= 2 else torch.float32
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=gen, dtype=dt, device=device)
    return t.mul_(0.1).add_(1.0) if scale is None else t.mul_(scale)


def make(leaves: List, seed: int, dtype: torch.dtype, device) -> Dict:
    """The nested parameter dict of ``leaves``, drawn from ``seed``."""
    params: Dict = {}
    for i, leaf in enumerate(leaves):
        *outer, name = leaf[0]
        node = params
        for key in outer:
            node = node.setdefault(key, {})
        node[name] = draw(leaf, seed, i, dtype, device)
    return params


def get(params: Dict, path) -> torch.Tensor:
    for key in path:
        params = params[key]
    return params
