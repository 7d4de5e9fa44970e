"""Dense decoder LM of the port: blocks, LM and the model registry."""
from .lm import LM
from .model import build_model

__all__ = ["LM", "build_model"]
