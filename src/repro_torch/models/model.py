"""Model registry: ``build_model(cfg)`` for the families the port runs."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> LM:
    """The LM of the dense, moe (over GQA attention or MLA), ssm (RWKV6)
    and hybrid (RG-LRU) families; the others raise
    ``NotImplementedError``. ``kw`` goes to ``LM`` (the impls,
    ``mla_absorbed``, ``device``)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return LM(cfg, **kw)
