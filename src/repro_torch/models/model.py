"""Model registry: ``build_model(cfg)`` for the families the port runs."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> LM:
    """The dense LM; other families raise ``NotImplementedError``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return LM(cfg, **kw)
