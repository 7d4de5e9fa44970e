"""The port's models: blocks, the decoder LM, the encoder-decoder and the
model registry."""
from .encdec import EncDecLM
from .lm import LM
from .model import build_model

__all__ = ["EncDecLM", "LM", "build_model"]
