"""The optimizer and the train step (the JAX package's ``optim``, by hand)."""
from .adamw import AdamWState, adamw_apply, adamw_init, adamw_update
from .compression import compress_int8, compressed_allreduce, decompress_int8
from .train_state import TrainState, make_train_state, make_train_step

__all__ = ["AdamWState", "TrainState", "adamw_apply", "adamw_init",
           "adamw_update",
           "compress_int8", "compressed_allreduce", "decompress_int8",
           "make_train_state", "make_train_step"]
