"""Params between the JAX reference and the port, as numpy.

``params_from_numpy`` takes the reference's params after ``np.asarray`` on
each leaf (nested dicts/lists of numpy arrays, ``None`` kept) and returns the
same tree of tensors on ``device``; ``params_to_numpy`` is its inverse. Leaf
names and shapes are the reference's, so the checkpoint manager's flattened
keys stay the same for both packages.

numpy has no bfloat16 of its own: a bf16 leaf given as an ``ml_dtypes``
bfloat16 array, or as numpy's two-byte void (how an npz entry of a bf16 array
loads), is read through its bytes, and ``params_to_numpy`` returns bf16
tensors as the same bytes viewed as ``np.uint16``. A leaf that is already a
tensor (``CheckpointManager.restore`` with a torch template gives CPU
tensors) is moved as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.lm import tree_map


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)                # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def params_to_numpy(tree):
    return tree_map(_to_numpy, tree)
