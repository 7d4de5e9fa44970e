"""The port's decoder LMs (dense, RWKV6): blocks, LM and the model registry."""
from .lm import LM
from .model import build_model

__all__ = ["LM", "build_model"]
