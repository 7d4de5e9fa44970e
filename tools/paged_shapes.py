#!/usr/bin/env python3
"""Time the port's paged decode-attention kernel alone, at ``chip_smoke.py``'s
paged shapes (``paged_cases``), on one CUDA card, and print the card's name
and power limit, then one JSON line.

    python3 tools/paged_shapes.py [--src DIR] [--cp-async]

``--src DIR``: the ``src`` directory of the checkout whose ``repro_torch``
is timed (by default this checkout's). To compare two commits on one card,
unpack the other with ``git archive`` into a directory that ``.gitignore``
lists, pass its ``src``, and run the two in turn (A, B, B, A). A shape that
checkout's kernel refuses (``ValueError``) is recorded as refused.

``--cp-async``: also build this checkout's ``csrc/paged_attention.cu`` with
``-DPAGED_NO_TMA``, so that every geometry fills its ring by 16-byte
``cp.async`` copies instead of TMA boxes, and time that library on the same
inputs, between two timings of the default one (``cp_async_ms``,
``cp_async_max_abs_err``, ``kernel_ms_after``).

Each shape's entry is ``chip_smoke.paged_shape``'s: errors against the plain
version (failing past the tolerances), ``kernel_ms``, ``call_ms``,
``plain_ms``, the bound and the dense-SDPA yardstick. The slice shapes have
chip_smoke's lengths, drawn here from their own seed.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--src", default=os.path.join(ROOT, "src"))
ap.add_argument("--cp-async", action="store_true")
args = ap.parse_args()
SRC = os.path.abspath(args.src)
if args.cp_async and SRC != os.path.join(ROOT, "src"):
    sys.exit("paged_shapes: --cp-async builds this checkout's kernel only")

# the timed checkout's package first: chip_smoke's own ``src`` goes on the
# path after it, and its imports find the package already loaded
sys.path.insert(0, SRC)
import repro_torch  # noqa: E402,F401
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402


def no_tma_library():
    """This checkout's kernel built with -DPAGED_NO_TMA, loaded as
    ``_build.load`` loads the default one."""
    out = _build._lib_path("paged_attention").with_suffix(".no-tma.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DPAGED_NO_TMA", "-o",
           str(out), str(_build.CSRC / "paged_attention.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"paged_shapes: nvcc -DPAGED_NO_TMA failed:\n{done.stdout}"
                 f"{done.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in paged_kernel._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.cuda_error_string = lib.paged_attention_error_string
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def cp_async_entry(lib, q, kv, bt, ln):
    """The kernel from ``lib`` at one shape: its error against the plain
    version and its device ms; then the default library's again."""
    bt_d, ln_d = torch.as_tensor(bt, device=cs.DEV), torch.as_tensor(
        ln, device=cs.DEV)

    def run():
        return paged_attention(q, kv, bt_d, ln_d, impl="kernel")

    default = paged_kernel._lib
    paged_kernel._lib = lambda: lib
    try:
        got = run()
        torch.cuda.synchronize()
        ref = paged_attention(q, kv, bt_d, ln_d, impl="xla")
        err = cs.close_or_fail(got, ref, cs.TOL[q.dtype], "paged cp.async")
        ms = cs.time_ms(run)
    finally:
        paged_kernel._lib = default
    return dict(cp_async_max_abs_err=err, cp_async_ms=ms,
                kernel_ms_after=cs.time_ms(run))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _build.build(["paged_attention"])
    variant = no_tma_library() if args.cp_async else None
    rng = np.random.default_rng(42)
    B, H, KH, D, P, page = 4, 16, 8, 128, 40, 64
    slice_inputs = {dtype: cs.paged_inputs(rng, B, H, KH, D, P, page,
                                           [552, 471, 300, 65], dtype)
                    for dtype in (torch.bfloat16, torch.float32)}
    shapes = {}
    for name, inputs in cs.paged_cases(slice_inputs).items():
        try:
            shapes[name] = cs.paged_shape(*inputs)
        except ValueError as e:                 # past that kernel's limits
            shapes[name] = dict(refused=f"{type(e).__name__}: {e}")
            continue
        if variant is not None:
            shapes[name].update(cp_async_entry(variant, *inputs))
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps({"paged_shapes": shapes, "src": SRC, "device": smi}),
          flush=True)


if __name__ == "__main__":
    main()
