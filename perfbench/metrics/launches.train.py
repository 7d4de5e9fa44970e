"""Launch calls a step inside ``pangea.step``, on any thread: kernel
launches (``cudaLaunchKernel``, ``cuLaunchKernel``), async memcpys and
memsets."""
from perfbench import readers, spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return s.launches / len(readers.traced(run))
