"""Hand-written CUDA kernels of the port (sources in ``csrc/``) with their
plain PyTorch versions and wrappers."""
from torch.distributed.tensor import DTensor


def local_only(*tensors) -> None:
    """Raise on a DTensor: a kernel (or its plain version) takes one
    rank's tensors, so a sharded model calls it through
    ``sharding.local_call``; a DTensor has no data of its own to launch
    on."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("a kernel wrapper got a DTensor: call it on each "
                        "rank's shard through sharding.local_call")
