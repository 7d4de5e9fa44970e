"""Model registry: ``build_model(cfg)`` for every family of the repo."""
from __future__ import annotations

from typing import Union

from ..configs.base import ArchConfig
from .encdec import EncDecLM
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> Union[LM, EncDecLM]:
    """``EncDecLM`` for the encdec family (``scan_impl``, ``moe_impl`` and
    ``mla_absorbed`` dropped from ``kw``, as the reference drops what it
    does not take), else the ``LM`` (dense, moe over GQA or MLA, ssm,
    hybrid, vlm). ``kw`` goes to the model (the impls, ``mla_absorbed``,
    ``device``)."""
    if cfg.family == "encdec":
        for key in ("scan_impl", "moe_impl", "mla_absorbed"):
            kw.pop(key, None)
        return EncDecLM(cfg, **kw)
    return LM(cfg, **kw)
