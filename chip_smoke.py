#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its serving path on a GPU.

Run from the root of a checkout on a machine with one NVIDIA H100 (Hopper,
``nvcc`` under ``/usr/local/cuda``): ``python3 chip_smoke.py``.

Phases, each raising on failure (nothing is caught, so a failed phase is a
non-zero exit):

1. the card's name and power limit from ``nvidia-smi``;
2. build the five CUDA sources from ``src/repro_torch/csrc`` with ``nvcc``,
   one process per source, all started together; ``ptxas``' registers and
   spills and, from ``cuobjdump -sass``, the tensor-core instruction counts
   (``HGMMA``, ``HMMA``), the highest register and the local stores of each
   flash kernel (``flash_build`` line) and of each linear-scan kernel
   (``scan_build``: the diagonal scan's ring and step kernels, the GLA
   scan's FMA and tensor-core kernels; fails without HMMA in the latter),
   and of the shuffle kernels (``shuffle_build``: dispatch's walk and
   direct kernels and combine, with their static and dynamic shared
   memory), and of the paged kernels (``paged_build``: a bf16 kernel for
   each head-dim bound and an fp32 kernel for each group bound, with the
   dynamic shared memory a block asks for at the served geometries; fails
   without HMMA in a bf16 kernel);
   the disassembly runs in the background during phase 3 and both lines
   are logged after it;
3. each kernel against its plain PyTorch version on the card: the reference
   test cases in fp32 and bf16, and the serving paths' own shapes, with
   CUDA-event timings of the kernel, its plain version and (flash) SDPA as a
   yardstick that the port never calls; paged attention at qwen3-0.6b's
   decode read over an fp32 and a bf16 pool, a long bf16 batch (32
   sequences of 2048-4096 keys), glm4-9b's group (32 query heads over 2
   kv heads) and recurrentgemma-9b's (16 over 1 of 256), each also held to
   a per-sequence relative error that one dropped chunk of keys fails, with
   dense SDPA over the gathered K/V as a yardstick that is not the same
   function; flash on both routes (fp32 and
   D % 8 != 0 scalar, bf16 wgmma) over the reference's cases and the edges
   of its tiles and masks, and timed at the prefills of qwen3-0.6b,
   recurrentgemma-9b (D = 256, one kv head, window 2048) and grok-1-314b
   (48 heads over 8), each with its route and tiles; the GLA scan on its
   two routes (fp32 FMA, bf16 tensor cores), also at unit scale against the
   exact (fp64) scan with the tolerance its witness gives, in fp32 and bf16,
   and timed at rwkv6-3b's prefill; the diagonal scan on its two routes (the ring for T > 1, the step
   for T = 1) with h0 in fp32 and bf16, failing unless its bits equal the
   plain version's, timed at recurrentgemma-9b's prefill in bf16 and fp32
   and at its decode; the MoE shuffle kernels (dispatch and combine) on the
   reference's cases with capacity drops, dropped ids and slots, repeated
   slots that sum, the round trip, rows that collect more pairs than
   dispatch's hit list holds (bits equal to the sum in token order), and
   grok-1-314b's served prefill and decode shapes (dispatch bit for bit the
   gather of the kept tokens, on its walk and its direct route); then
   full-width layers of each model, kernel path against
   plain path (recurrentgemma-9b: one superblock and one RG-LRU layer over
   2100 tokens, and a decode step; grok-1-314b: one layer in fp32, prefill
   and a decode step);
4. serve: full-width qwen3-0.6b ``ServeLoop`` answers 8 requests of 512
   prompt tokens and 32 new tokens with a page pool too small to hold them,
   prefill through the flash kernel;
5. KV pool: the served prompts' K/V written into a ``PagedKVCache`` at
   qwen3's geometry, evicted and restored, and read in place by the paged
   kernel, against its plain version and dense attention: exactly 84
   launches (3 attended batches of 28 layers);
6. profile: host wall time, device busy time and idle share of one warm
   prefill and one warm decode step of qwen3-0.6b (torch.profiler);
7. serve: full-width rwkv6-3b ``ServeLoop`` (32 layers, bf16) answers 8
   requests of 512 prompt tokens and 32 new tokens with the default pool,
   prefill through the GLA-scan kernel;
8. profile: as phase 6, for rwkv6-3b;
9. serve: full-width recurrentgemma-9b ``ServeLoop`` (38 layers, bf16,
   params handed over already cast) answers 8 requests of 2100 prompt
   tokens (past the 2048-token window, so local attention keeps a ring) and
   32 new tokens, prefill through the diag-scan kernel (26 RG-LRU layers)
   and the flash kernel (12 attention layers), decode through the diag-scan
   kernel;
10. profile: as phase 6, for recurrentgemma-9b;
11. serve: grok-1-314b at full width and 4 of its 64 layers (21.3 B
    params, drawn in bf16 and handed over cast) answers 8 requests of 512
    prompt tokens and 32 new tokens with the default pool, every MoE layer's
    dispatch and combine through the shuffle kernels in prefill and in
    every decode step, prefill attention through the flash kernel;
12. profile: as phase 6, for grok-1-314b;
13. serving tier: the port's ``ServingTier`` at qwen3-0.6b's KV geometry
    (28 layers, page 64, 8 kv heads of 128, fp32: 14.68 MB a page slab)
    over a four-node inproc cluster, 32 pool pages a node on the card:
    16 sessions of 448-960 prompt tokens admitted and decoded 16 steps,
    so that Eq.-1 evictions, level-2 host slabs and level-3 spills to
    another node all happen; ``attend(impl="kernel")`` at every layer over
    per-shard batches whose pages fit the pool, held to ``attend(impl=
    "xla")`` and to dense fp64 attention over the oracle's K/V at 2e-5;
    every session verified byte for byte; one session's primary killed,
    4 more decode steps (failover), attend and verify again; then a
    four-node proc cluster forked after CUDA is up, a SIGKILL mid-decode,
    failover, verify and attend, failing unless ``close()`` leaves no child
    and no shared-memory segment and no rpc value was refused; one attend
    launch timed beside its bound.

Launch counts are zeroed just before phase 4 and read just after phase 5
(flash and paged attention: the qwen3 path), zeroed again just before phase
7 and read just after it (the GLA scan: the rwkv6-3b path), again just
before phase 9 and read just after it (the diagonal scan and flash: the
recurrentgemma-9b path), and again just before phase 11 and read just after
it (dispatch, combine and flash: the grok-1-314b path), and again just
before phase 13 and read just after it (paged attention: the
``ServingTier`` path, exactly one launch a shard of each ``attend`` call,
counted from the tier's sessions at the call). Each serve phase
fails unless every kernel of its path made exactly the launches its layers
and batches call for, every flash launch of a serve phase on the wgmma
route, every GLA launch on the tensor-core route, and the diagonal scan's
launches on the ring (prefill) and the step (decode) route as its layers
call for, and dispatch's on the walk (prefill) and the direct (decode)
route. The script's own seconds are logged on an
``elapsed`` line; the second-to-last line is ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device":
{...}}``. Without CUDA, or without
the rest of the repo beside it, the script exits non-zero and prints no
result.

``tools/paged_shapes.py`` times the paged kernel alone at this script's
paged shapes (``paged_cases``, ``paged_shape``), with another checkout's
``repro_torch`` or with the ring filled by ``cp.async`` only.
"""
import atexit
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch


def _fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


if not torch.cuda.is_available():
    _fail("torch.cuda.is_available() is False; this runs on an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PagedKVCache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    kernel_route, wgmma_tiles)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.linear_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.linear_scan.ops import diag_scan, gla_scan  # noqa: E402
from repro_torch.kernels.linear_scan.ref import gla_scan_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.kernels.shuffle_dispatch import kernel as shuffle_kernel  # noqa: E402
from repro_torch.kernels.shuffle_dispatch.ops import (  # noqa: E402
    combine, compute_slots, dispatch)
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.cluster import Cluster  # noqa: E402
from repro_torch.runtime.rpc import pickle_fallbacks  # noqa: E402
from repro_torch.runtime.serving import ServingTier, token_value  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# the paged kernel's timed shapes, besides TOL: each sequence's relative
# (Frobenius) error over its heads, which one dropped chunk of keys exceeds
PAGED_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
POOL_TOL = 2e-5
GLA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # the reference's
SHUFFLE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # the reference's

# the JAX package's kernel test cases (tests/test_kernels.py)
FLASH_CASES = [  # B, H, KH, Tq, Tk, D, causal, window
    (1, 4, 2, 64, 64, 32, True, None),
    (2, 4, 4, 40, 72, 16, True, None),
    (1, 2, 1, 64, 64, 32, False, None),
    (1, 2, 2, 96, 96, 32, True, 32),
    (1, 8, 4, 128, 128, 64, True, None),
]
# edges of the flash kernels' tiles and masks (tests/test_torch_cuda.py
# FLASH_EDGE_CASES): a continued prefill, T and D off the tiles, windows off
# and under the key tile, groups of 1, 6 and 16, peaked scores, D % 8 != 0
FLASH_EDGE_CASES = [  # B, H, KH, Tq, Tk, D, causal, window, q_offset, q scale
    (1, 4, 2, 100, 260, 64, True, None, 160, 1.0),
    (2, 6, 1, 200, 200, 96, True, None, 0, 1.0),
    (1, 4, 4, 300, 300, 128, True, 200, 0, 1.0),
    (1, 2, 1, 257, 257, 256, True, 40, 0, 1.0),
    (1, 16, 1, 130, 130, 128, True, None, 0, 1.0),
    (1, 4, 2, 192, 192, 64, True, None, 0, 8.0),
    (1, 2, 2, 70, 300, 128, False, None, 0, 1.0),
    (1, 4, 1, 64, 300, 256, True, 100, 236, 1.0),
    (1, 2, 1, 90, 90, 36, True, None, 0, 1.0),
]
PAGED_CASES = [  # B, H, KH, D, P, page, max_pages
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 16, 8, 16, 3),
    (3, 4, 1, 64, 32, 8, 6),
]
# test_gla_scan_sweep's cases, a T that is not a chunk multiple, the served
# head (80) with a chunk longer than T and a padded two-chunk T, odd widths
# and the widest head the kernel takes. Log decays are -exp(w0 + N(0,
# 0.5^2)): w0 = 0 as the reference's tests draw them, w0 = -2 as rwkv_init's
# w0 makes them (at chunk 64 and w0 = 0 the reference's factorisation
# overflows fp32: e^{c_{i-1} - c_L} passes e^{88})
GLA_CASES = [  # B, T, Dk, Dv, chunk, w0
    (2, 32, 16, 16, 16, 0.0),
    (1, 64, 32, 16, 16, 0.0),
    (2, 48, 8, 24, 16, 0.0),
    (2, 50, 8, 24, 16, 0.0),
    (1, 37, 80, 80, 64, -2.0),
    (1, 100, 80, 80, 64, -2.0),
    (3, 45, 10, 6, 16, 0.0),        # widths that are not whole 16-byte rows
    (2, 130, 128, 128, 64, -2.0),   # the kernel's widest head
]
# test_diag_scan_sweep's cases, a width that is not whole channel pairs, and
# recurrentgemma-9b's decode (T = 1); its prefill is timed in check_diag
DIAG_CASES = [  # B, T, D, chunk
    (2, 64, 16, 16),
    (1, 100, 8, 32),
    (3, 32, 32, 32),
    (2, 77, 33, 16),
    (4, 1, 4096, 256),
]
# test_shuffle_dispatch_sweep's cases and a width that is not whole 16-byte
# rows; grok-1-314b's served shapes are drawn in check_shuffle
SHUFFLE_CASES = [  # T, D, E, K, C
    (64, 32, 4, 2, 32),
    (128, 16, 8, 1, 24),
    (96, 64, 16, 6, 16),
    (50, 37, 5, 3, 12),
]
# more pairs on a walk block's rows than its hit list holds (1024): all
# pairs on one row, and pairs drawn at random over a few rows
OVERFLOW_CASES = [  # kind, T, D, E, K, C
    ("one row", 4096, 64, 4, 2, 8),
    ("spread", 3001, 40, 3, 3, 8),
]


def log(*a):
    print(*a, flush=True)


def close_or_fail(out, ref, tol, what):
    """allclose with rtol = atol = tol; returns the max abs error."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        _fail(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        _fail(f"{what}: non-finite output")
    err = (out - ref).abs()
    excess = float((err - tol * (1 + ref.abs())).max())
    if excess > 0:
        _fail(f"{what}: max abs err {float(err.max())} over tol {tol}")
    return float(err.max())


_FLUSH = None


def time_ms(fn, reps=20, spin=True):
    """Median device ms of one call, timed with CUDA events. The 50 MB L2 is
    flushed before each call, so inputs come from device memory, and the GPU
    then spins for ~1 ms so that the host has enqueued the whole call before
    the start event fires: the host's launch overhead is not counted. With
    ``spin=False`` it is, as far as the device waits for it."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape)).to(DEV, dtype)


# -- phase 2: what the compiler made of the kernels --------------------------------
def start_disassembly(sources):
    """``cuobjdump -sass`` of each built library into ``<library>.sass``
    beside it, started together in the background (seconds of host work
    each, overlapped with phase 3)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    procs = {}
    for src in sources:
        lib = _build._lib_path(src)
        with open(lib.with_suffix(".sass"), "w") as out:
            procs[src] = subprocess.Popen([cuobjdump, "-sass", str(lib)],
                                          stdout=out)
    # a failed phase exits early: stop whatever is still running
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


_DISASSEMBLY = {}


def sass_of(source):
    """The disassembly of ``csrc/<source>.cu``'s library."""
    if _DISASSEMBLY[source].wait():
        _fail(f"cuobjdump of {source} failed")
    return _build._lib_path(source).with_suffix(".sass").read_text()


def build_facts(source, short):
    """Per kernel of ``csrc/<source>.cu``: ``ptxas``' registers, spill
    bytes and static shared memory (-Xptxas -v), and from ``cuobjdump
    -sass`` the tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync), the highest register
    index and the local-memory stores. ``short`` names a kernel from its
    mangled name."""
    facts = {}
    fn = None
    for line in _build.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = short(m.group(1))
            facts[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            facts[fn].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            facts[fn]["ptxas_registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and fn:
            facts[fn]["static_smem"] = int(m.group(1))
    for body in re.split(r"\n\s+Function : ", sass_of(source))[1:]:
        fn = short(body.split("\n")[0].strip())
        facts.setdefault(fn, {}).update(
            hgmma=body.count("HGMMA"), hmma=len(re.findall(r"\bHMMA\b", body)),
            local_stores=body.count("STL"),
            max_register=max(int(r) for r in re.findall(r"\bR(\d+)\b", body)))
    return facts


def flash_build_facts():
    """The flash kernels' build facts (a 384-thread block starts at 168
    registers a thread, and the consumer warpgroups' code after
    ``setmaxnreg.inc`` may use up to 240)."""
    def short(mangled):
        m = re.search(r"(flash_fwd_\w+?)I(\w+?)EEv", mangled)
        if not m:
            return mangled
        args = ["bf16" if a.group(0)[0] == "1" else "f32" if a.group(0) == "f"
                else a.group(1)
                for a in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f(?=Li)",
                                     m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"

    facts = build_facts("flash_attention", short)
    if not sum(f.get("hgmma", 0) for f in facts.values()):
        _fail(f"no HGMMA in the flash library: {facts}")
    return facts


def scan_build_facts():
    """The two linear scans' build facts: the diagonal scan's ring and step
    kernels and the GLA scan's FMA and tensor-core kernels. Fails unless
    the tensor-core GLA kernel has HMMA instructions."""
    def short(mangled):
        m = re.search(r"\d+(diag_scan_\w+?|gla_scan_\w+?)(?:I(\w+?)E)?(?:EvP|EPK)",
                      mangled)
        if not m:
            return mangled
        arg = m.group(2) or ""
        return m.group(1) + ("<bf16>" if "bfloat16" in arg else
                             "<f32>" if arg == "f" else "")

    facts = {"diag_scan": build_facts("diag_scan", short),
             "linear_scan": build_facts("linear_scan", short)}
    mma = facts["linear_scan"].get("gla_scan_mma", {})
    if not mma.get("hmma"):
        _fail(f"no HMMA in the tensor-core GLA kernel: {facts}")
    return facts


def shuffle_build_facts():
    """The shuffle kernels' build facts: dispatch's walk and direct kernels
    and combine, by data (and gate) type. None takes dynamic shared memory
    (the launches pass 0 bytes); the walk kernel's hit list is static."""
    def short(mangled):
        m = re.search(r"\d+(dispatch_walk|dispatch_direct|combine_kernel)"
                      r"I(\w+?)EEv", mangled)
        if not m:
            return mangled
        # S1_ names the first type again (bf16 data with bf16 gates)
        args = ["bf16" if a in ("13__nv_bfloat16", "S1_") else
                "f32" if a == "f" else f"KG={a[2:-1]}"
                for a in re.findall(r"13__nv_bfloat16|S1_|Li\d+E|f",
                                    m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"

    facts = build_facts("shuffle_dispatch", short)
    for f in facts.values():
        f.setdefault("static_smem", 0)            # ptxas names none
        f["dynamic_smem"] = 0
    return facts


def paged_build_facts():
    """The paged kernels' build facts (bf16 by its head-dim bound DM, fp32
    by its group bound GB) and the dynamic shared memory a block asks for at
    the served geometries (the library's count, the one its launch passes).
    Fails unless every bf16 kernel has HMMA instructions."""
    def short(mangled):
        m = re.search(r"paged_attention_kernelI(13__nv_bfloat16|f)Li(\d+)ELi"
                      r"(\d+)E", mangled)
        if not m:
            return mangled
        return (f"paged<bf16,DM={m.group(2)}>" if m.group(1) != "f"
                else f"paged<f32,GB={m.group(3)}>")

    facts = build_facts("paged_attention", short)
    for f in facts.values():
        f.setdefault("static_smem", 0)            # ptxas names none
    for fn, f in facts.items():
        if "bf16" in fn and not f.get("hmma"):
            _fail(f"no HMMA in the bf16 paged kernel {fn}: {facts}")
    facts["dynamic_smem"] = {
        f"{name} {'fp32' if dtype == torch.float32 else 'bf16'}":
            paged_kernel.smem_bytes(dtype, G, D)
        for name, G, D in (("qwen3 G=2 D=128", 2, 128),
                           ("grok G=6 D=128", 6, 128),
                           ("glm4 G=16 D=128", 16, 128),
                           ("recurrentgemma G=16 D=256", 16, 256))
        for dtype in (torch.float32, torch.bfloat16)}
    return facts


# -- phase 3: kernels against their plain versions ------------------------------
def check_flash(rng):
    worst = {}
    # the reference's cases from the shared generator, the edge cases from
    # their own, so that the later kernels' inputs stay those of the earlier
    # slices
    erng = np.random.default_rng(15)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES + FLASH_EDGE_CASES:
            B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale = \
                tuple(case) + (0, 1.0)[len(case) - 8:]
            g = rng if len(case) == 8 else erng
            q = rand(g, (B, H, Tq, D), dtype) * q_scale
            k, v = rand(g, (B, KH, Tk, D), dtype), rand(g, (B, KH, Tk, D), dtype)
            route = kernel_route(dtype, D)
            before = flash_attention.launches_by_route[route]
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, impl="kernel")
            torch.cuda.synchronize()
            if flash_attention.launches_by_route[route] != before + 1:
                _fail(f"flash {case} {dtype}: not on the {route} route")
            ref = attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
            err = close_or_fail(out, ref, TOL[dtype], f"flash {case} {dtype}")
            worst[f"{route} {dtype}"] = max(worst.get(f"{route} {dtype}", 0.0),
                                            err)
    # the serving paths' prefills, 4 prompts each: qwen3-0.6b's heads over
    # 512 tokens, and recurrentgemma-9b's over 2100 with its window of 2048
    paths = {"qwen3-0.6b": flash_at(rng, 4, 16, 8, 512, 128, None)}
    # recurrentgemma-9b's heads (D = 256, 16 query heads over one kv head, a
    # window shorter than T) from their own generator, so that the later
    # kernels' inputs stay those of the earlier slices
    grng = np.random.default_rng(13)
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(grng, (1, 16, 300, 256), dtype)
        k = rand(grng, (1, 1, 300, 256), dtype)
        v = rand(grng, (1, 1, 300, 256), dtype)
        out = flash_attention(q, k, v, causal=True, window=128, impl="kernel")
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=True, window=128)
        worst[f"D=256 {dtype}"] = close_or_fail(out, ref, TOL[dtype],
                                                f"flash D=256 {dtype}")
    paths["recurrentgemma-9b"] = flash_at(grng, 4, 16, 1, 2100, 256, 2048)
    # grok-1-314b's prefill: 48 query heads over 8 kv heads of 128
    paths["grok-1-314b"] = flash_at(np.random.default_rng(14), 4, 48, 8, 512,
                                    128, None)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:84",
                cases_max_abs_err=worst, **paths["qwen3-0.6b"], paths=paths)


def flash_at(rng, B, H, KH, T, D, window):
    """The kernel at one serving path's prefill shape (bf16, causal): its
    route and tiles, error against the plain version, times of the kernel,
    the plain version and SDPA (causal, or with the window as a boolean
    mask), and the bound."""
    dtype = torch.bfloat16
    q = rand(rng, (B, H, T, D), dtype)
    k, v = rand(rng, (B, KH, T, D), dtype), rand(rng, (B, KH, T, D), dtype)
    out = flash_attention(q, k, v, causal=True, window=window, impl="kernel")
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True, window=window)
    err = close_or_fail(out, ref, TOL[dtype], f"flash served shape D={D}")
    del out, ref

    def run():
        return flash_attention(q, k, v, causal=True, window=window,
                               impl="kernel")

    pos = torch.arange(T, device=DEV)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True,
                                             window=window))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(
        (lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        if window is None else
        (lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)))
    pairs = B * H * int(mask.sum())                  # live (q, k) pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * D * pairs, dtype)
    route = kernel_route(dtype, D)
    return dict(shape=f"B={B} H={H} KH={KH} T={T} D={D} bf16 causal"
                      + (f" window={window}" if window else ""),
                kernel_route=route,
                tiles=wgmma_tiles(D) if route == "wgmma" else None,
                max_abs_err=err, tolerance=TOL[dtype], ms=kernel_ms,
                kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def paged_inputs(rng, B, H, KH, D, P, page, lengths, dtype):
    q = rand(rng, (B, H, D), dtype)
    kv = rand(rng, (P, page, 2, KH, D), dtype)
    max_pages = max(-(-n // page) for n in lengths)
    bt = np.full((B, max_pages), -1, np.int32)
    for b, n in enumerate(lengths):
        npages = -(-n // page)
        bt[b, :npages] = rng.choice(P, size=npages, replace=False)
    return q, kv, bt, np.asarray(lengths, np.int32)


def check_paged(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in PAGED_CASES:
            B, H, KH, D, P, page, maxp = case
            lengths = []
            for _ in range(B):
                n = int(rng.integers(1, maxp + 1))
                lengths.append(int(rng.integers((n - 1) * page + 1, n * page + 1)))
            q, kv, bt, ln = paged_inputs(rng, B, H, KH, D, P, page, lengths,
                                         dtype)
            out = paged_attention(q, kv, bt, ln, impl="kernel")
            torch.cuda.synchronize()
            ref = paged_attention(q, kv, bt, ln, impl="xla")
            err = close_or_fail(out, ref, TOL[dtype], f"paged {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
        # long sequences: many chunks per split block
        q, kv, bt, ln = paged_inputs(rng, 2, 4, 1, 128, 600, 16, [7999, 3001],
                                     dtype)
        out = paged_attention(q, kv, bt, ln, impl="kernel")
        torch.cuda.synchronize()
        ref = paged_attention(q, kv, bt, ln, impl="xla")
        worst[f"long {dtype}"] = close_or_fail(out, ref, TOL[dtype],
                                               f"paged long {dtype}")
    # the serving path's decode read: qwen3-0.6b heads over an fp32 pool with
    # page 64, ragged lengths up to max_len 552, tables in random slot order
    B, H, KH, D, P, page = 4, 16, 8, 128, 40, 64
    lengths = [552, 471, 300, 65]
    slice_inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        slice_inputs[dtype] = paged_inputs(rng, B, H, KH, D, P, page, lengths,
                                           dtype)
    shapes = {name: paged_shape(*inputs)
              for name, inputs in paged_cases(slice_inputs).items()}
    for name, entry in shapes.items():
        worst[name] = entry["max_abs_err"]
    top = shapes["slice fp32"]
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:79",
                shape=top["shape"], tolerance=TOL[torch.float32],
                cases_max_abs_err=worst, max_abs_err=top["max_abs_err"],
                ms=top["kernel_ms"], kernel_ms=top["kernel_ms"],
                call_ms=top["call_ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=None, shapes=shapes)


def paged_long_inputs(B, H, KH, D, page, dtype, seed):
    """B sequences of lengths drawn from integers(2048, 4097) with the
    phase's seed (its own generator, so that the later kernels' inputs stay
    those of the earlier slices), each on its own pages of a pool of B * 64
    pages drawn on the card, tables in random page order."""
    lrng = np.random.default_rng(seed)
    lengths = [int(n) for n in lrng.integers(2048, 4097, size=B)]
    width = 4096 // page
    P = B * width
    gen = torch.Generator(DEV).manual_seed(seed)
    kv = torch.randn((P, page, 2, KH, D), generator=gen, device=DEV,
                     dtype=dtype)
    q = torch.randn((B, H, D), generator=gen, device=DEV, dtype=dtype)
    perm = lrng.permutation(P).astype(np.int32)
    bt = np.full((B, width), -1, np.int32)
    for b, n in enumerate(lengths):
        npages = -(-n // page)
        bt[b, :npages] = perm[b * width:b * width + npages]
    return q, kv, bt, np.asarray(lengths, np.int32)


def paged_cases(slice_inputs):
    """The paged kernel's timed shapes: qwen3-0.6b's served decode read
    (B=4, page 64, lengths 552/471/300/65) over an fp32 pool (the served
    one) and a bf16 one, a long bf16 batch at qwen3's geometry (B=32,
    lengths 2048-4096), glm4-9b's group (32 query heads over 2 kv heads)
    and recurrentgemma-9b's (16 over 1 of 256, the ring filled by
    ``cp.async``) at the same lengths."""
    return {
        "slice fp32": slice_inputs[torch.float32],
        "slice bf16": slice_inputs[torch.bfloat16],
        "long bf16": paged_long_inputs(32, 16, 8, 128, 64, torch.bfloat16, 42),
        "glm4 group bf16": paged_long_inputs(32, 32, 2, 128, 64,
                                             torch.bfloat16, 42),
        "recurrentgemma group bf16": paged_long_inputs(32, 16, 1, 256, 64,
                                                       torch.bfloat16, 42),
    }


def seq_rel_err(out, ref):
    """The largest relative (Frobenius) error of one sequence's output."""
    out, ref = out.float().flatten(1), ref.float().flatten(1)
    return float(((out - ref).norm(dim=1) / ref.norm(dim=1)).max())


def paged_shape(q, kv, bt, ln):
    """The paged kernel at one shape: its error against the plain version,
    within TOL and, per sequence, within PAGED_REL_TOL, which the plain
    version with one chunk of keys dropped (the longest sequence's last 32,
    the smaller chunk of the two routes) must fail; kernel_ms, call_ms,
    plain_ms, the bound and, as a yardstick that the port never calls,
    dense SDPA on the same K/V already gathered into [B, KH, T, D] with a
    key mask (not the same function: the gather is not timed)."""
    B, H, D = q.shape
    P, page, _, KH, _ = kv.shape
    dtype = q.dtype
    lengths = [int(n) for n in ln]
    bt_d, ln_d = torch.as_tensor(bt, device=DEV), torch.as_tensor(ln, device=DEV)
    entry = dict(shape=f"B={B} H={H} KH={KH} D={D} page={page} "
                       f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                       f"pool of {P} pages, lengths "
                       + (str(lengths) if B <= 4 else
                          f"{min(lengths)}-{max(lengths)} (sum "
                          f"{sum(lengths)})"),
                 tolerance=TOL[dtype], rel_tolerance=PAGED_REL_TOL[dtype])
    tokens = sum(lengths)                            # live K/V rows
    nbytes = (tokens * 2 * KH * D + 2 * q.numel()) * kv.element_size() \
        + bt.nbytes + ln.nbytes
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 4 * H * D * tokens,
                                                 dtype)
    got = paged_attention(q, kv, bt_d, ln_d, impl="kernel")
    torch.cuda.synchronize()
    ref = paged_attention(q, kv, bt_d, ln_d, impl="xla")
    entry["max_abs_err"] = close_or_fail(got, ref, TOL[dtype], f"paged "
                                         f"{entry['shape']}")
    entry["rel_err"] = seq_rel_err(got, ref)
    if entry["rel_err"] > PAGED_REL_TOL[dtype]:
        _fail(f"paged {entry['shape']}: a sequence's relative error "
              f"{entry['rel_err']} over {PAGED_REL_TOL[dtype]}")
    short = ln.copy()             # 32 keys: the fp32 route's chunk, half bf16's
    short[int(np.argmax(ln))] -= 32
    entry["dropped_chunk_rel_err"] = seq_rel_err(paged_attention(
        q, kv, bt_d, torch.as_tensor(short, device=DEV), impl="xla"), ref)
    if entry["dropped_chunk_rel_err"] <= PAGED_REL_TOL[dtype]:
        _fail(f"paged {entry['shape']}: the check passes a dropped chunk "
              f"({entry['dropped_chunk_rel_err']})")
    del got, ref

    def run():
        return paged_attention(q, kv, bt_d, ln_d, impl="kernel")

    entry["kernel_ms"] = entry["ms"] = time_ms(run)
    entry["call_ms"] = time_ms(run, spin=False)
    entry["plain_ms"] = time_ms(
        lambda: paged_attention(q, kv, bt_d, ln_d, impl="xla"),
        reps=5 if B > 4 else 20)
    # the yardstick: dense [B, KH, T, D] K and V, a key mask by length
    T = bt.shape[1] * page
    dense = kv[bt_d.clamp_min(0).long()]            # [B, pages, page, 2, KH, D]
    k = dense[..., 0, :, :].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    v = dense[..., 1, :, :].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    del dense
    mask = (torch.arange(T, device=DEV)[None, :] < ln_d[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry["yardstick"] = "dense SDPA, not the same function"
    entry["yardstick_ms"] = time_ms(
        lambda: sdpa(q4, k, v, attn_mask=mask, enable_gqa=True))
    return entry


def gla_inputs(rng, B, T, Dk, Dv, w0, dtype, rk_scale=1.0):
    """r, k, v, w (log decays <= 0), u as the reference's tests draw them,
    with the decays' scale set by ``w0``."""
    r = rand(rng, (B, T, Dk), torch.float32) * rk_scale
    k = rand(rng, (B, T, Dk), torch.float32) * rk_scale
    v = rand(rng, (B, T, Dv), torch.float32)
    w = -torch.exp(w0 + rand(rng, (B, T, Dk), torch.float32) * 0.5)
    u = rand(rng, (B, Dk), torch.float32)
    return [x.to(dtype) for x in (r, k, v, w, u)]


def gla_close(inputs, chunk, dtype, what):
    """Kernel against the chunked plain version: o and S_T. Returns the max
    abs error and the plain o."""
    route = scan_kernel.gla_route(dtype)
    before = gla_scan.launches_by_route[route]
    o, S = gla_scan(*inputs, impl="kernel", chunk=chunk)
    torch.cuda.synchronize()
    if gla_scan.launches_by_route[route] != before + 1:
        _fail(f"{what}: not on the {route} route")
    ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=chunk)
    if o.dtype != inputs[2].dtype or S.dtype != torch.float32:
        _fail(f"{what}: dtypes o {o.dtype}, S {S.dtype}")
    return max(close_or_fail(o, ro, GLA_TOL[dtype], f"{what} o"),
               close_or_fail(S, rS, GLA_TOL[dtype], f"{what} S")), ro


def rel_gap(out, exact):
    """The least tol for which ``out`` passes close_or_fail against
    ``exact``: max |out - exact| / (1 + |exact|)."""
    return float(((out.double() - exact).abs() / (1 + exact.abs())).max())


def gla_witness(inputs, chunk, what):
    """The kernel at unit-scale r and k, as the model feeds it: o reaches
    ~170 and its terms cancel, so no fixed tolerance is known a priori. The
    witness is the exact scan (``gla_scan_ref`` in fp64) and the gap to it
    of the chunked plain version, the same factorisation in fp32. In fp32
    (the FMA route) the kernel must come as close to the exact scan as twice
    that gap, in o and S. In bf16 (the tensor-core route, operands split in
    two bf16 parts) o, which is rounded to bf16, must come as close as twice
    the plain version's gap, and S within GLA's bf16 tolerance."""
    exact_o, exact_S = gla_scan_ref(*(x.double() for x in inputs))
    o, S = gla_scan(*inputs, impl="kernel", chunk=chunk)
    ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=chunk)
    torch.cuda.synchronize()
    reading = dict(route=scan_kernel.gla_route(inputs[0].dtype),
                   plain_vs_exact_o=rel_gap(ro, exact_o),
                   plain_vs_exact_S=rel_gap(rS, exact_S),
                   kernel_vs_exact_o=rel_gap(o, exact_o),
                   kernel_vs_exact_S=rel_gap(S, exact_S),
                   kernel_vs_plain=max(rel_gap(o, ro.double()),
                                       rel_gap(S, rS.double())),
                   exact_max_abs=float(exact_o.abs().max()))
    plain = max(reading["plain_vs_exact_o"], reading["plain_vs_exact_S"])
    if inputs[0].dtype == torch.float32:
        reading["tolerance"] = 2 * plain
        gaps = {"o and S": max(reading["kernel_vs_exact_o"],
                               reading["kernel_vs_exact_S"])}
        tols = {"o and S": reading["tolerance"]}
    else:
        reading["tolerance_o"] = 2 * reading["plain_vs_exact_o"]
        reading["tolerance_S"] = GLA_TOL[torch.bfloat16]
        gaps = {"o": reading["kernel_vs_exact_o"],
                "S": reading["kernel_vs_exact_S"]}
        tols = {"o": reading["tolerance_o"], "S": reading["tolerance_S"]}
    log("gla_witness", what, json.dumps(reading))
    if not (torch.isfinite(o).all() and torch.isfinite(S).all()):
        _fail(f"{what}: non-finite output")
    for key, gap in gaps.items():
        if gap > tols[key]:
            _fail(f"{what}: kernel {key} {gap} from the exact scan, over "
                  f"{tols[key]}")
    return max(gaps.values())


def check_gla(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in GLA_CASES:
            B, T, Dk, Dv, chunk, w0 = case
            err, _ = gla_close(gla_inputs(rng, B, T, Dk, Dv, w0, dtype), chunk,
                               dtype, f"gla {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # the served prefill: rwkv6-3b's 32 heads of 80 over 4 prompts of 512
    # tokens, chunk 64, the served decays (w0 = -2). In fp32 twice: with r and
    # k scaled by Dk^-1/2, so that o stays O(1), at the fixed tolerance; and
    # at unit scale against the exact scan, with the tolerance its witness
    # gives.
    B, T, D, chunk = 4 * 32, 512, 80, 64
    worst["slice fp32"], _ = gla_close(
        gla_inputs(rng, B, T, D, D, -2.0, torch.float32, rk_scale=D ** -0.5),
        chunk, torch.float32, "gla slice shape fp32")
    worst["slice fp32 unit scale, vs exact"] = gla_witness(
        gla_inputs(rng, B, T, D, D, -2.0, torch.float32), chunk,
        "slice shape fp32 unit scale")
    dtype = torch.bfloat16
    inputs = gla_inputs(rng, B, T, D, D, -2.0, dtype)
    err, ro = gla_close(inputs, chunk, dtype, "gla slice shape bf16")
    worst["slice bf16 unit scale, vs exact"] = gla_witness(
        inputs, chunk, "slice shape bf16 unit scale")

    def run():
        return gla_scan(*inputs, impl="kernel", chunk=chunk)

    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: gla_scan(*inputs, impl="xla_chunked",
                                        chunk=chunk))
    tv = scan_kernel.mma_dv_tile(B, D, D, chunk, torch.cuda
                                 .get_device_properties(0).multi_processor_count)
    lib = scan_kernel._lib()
    strict = chunk * (chunk - 1) // 2        # A's strictly lower entries
    flops = B * (T // chunk) * (     # per (row, chunk), products only:
        2 * chunk * D * D            # q_inter S
        + 2 * chunk * D * D          # the state update k_intra^T v
        + 2 * strict * D             # A = q_intra k_intra^T
        + 2 * strict * D             # A v
        + 5 * chunk * D)             # the bonus: sum r u k, times v
    nbytes = (sum(x.numel() for x in inputs) + B * T * D) \
        * inputs[0].element_size() + B * D * D * 4          # + o, S_T
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log("gla_work", json.dumps(dict(
        flops=flops, bytes=nbytes,
        fp32_fma_floor_ms=flops / PEAK_FLOPS[torch.float32] * 1e3)))
    return dict(name="gla_scan", route="cuda",
                source="src/repro_torch/csrc/linear_scan.cu",
                replaces="src/repro/kernels/linear_scan/kernel.py:134",
                shape=f"B*H={B} T={T} Dk=Dv={D} chunk={chunk} bf16",
                kernel_route=scan_kernel.gla_route(dtype),
                tiles=dict(dv_tile=tv, blocks=B * -(-D // tv),
                           smem_bytes=lib.gla_scan_mma_smem(chunk, D, tv)),
                max_abs_err=err, tolerance=GLA_TOL[dtype],
                ref_max_abs=float(ro.float().abs().max()),
                cases_max_abs_err=worst, ms=kernel_ms, kernel_ms=kernel_ms,
                call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def diag_inputs(rng, B, T, D, dtype, near_one=False):
    """a in (0, 1) and b as the reference's tests draw them, and an fp32
    h0. ``near_one``: a = exp(-U(0, 0.02)) instead, as RG-LRU's a is where
    its gate r is small, so that a 256-step segment's product of a's stays
    near 0.08 and the carry across segments decides the output."""
    if near_one:
        a = torch.exp(-0.02 * torch.from_numpy(rng.uniform(size=(B, T, D))))
        a = a.to(DEV, dtype)
    else:
        a = torch.sigmoid(rand(rng, (B, T, D), torch.float32)).to(dtype)
    return a, rand(rng, (B, T, D), dtype), rand(rng, (B, D), torch.float32)


def diag_close(a, b, h0, chunk, dtype, what):
    """Kernel against the sequential oracle: h and h_T, their dtypes, the
    route the launch took, and their bits: both routes walk each channel in
    order and round the multiply and the add apart, as the oracle does, so
    any difference fails."""
    route = scan_kernel.diag_route(a.shape[1])
    before = diag_scan.launches_by_route[route]
    h, hT = diag_scan(a, b, h0, impl="kernel", chunk=chunk)
    torch.cuda.synchronize()
    if diag_scan.launches_by_route[route] != before + 1:
        _fail(f"{what}: not on the {route} route")
    rh, rT = diag_scan(a, b, h0, impl="xla")
    if h.dtype != a.dtype or hT.dtype != a.dtype:
        _fail(f"{what}: dtypes h {h.dtype}, h_T {hT.dtype}")
    err = max(close_or_fail(h, rh, TOL[dtype], f"{what} h"),
              close_or_fail(hT, rT, TOL[dtype], f"{what} h_T"))
    if not (torch.equal(h, rh) and torch.equal(hT, rT)):
        _fail(f"{what}: the {route} route's bits differ from the plain "
              f"version's (max abs err {err})")
    return err


def check_diag(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in DIAG_CASES:
            B, T, D, chunk = case
            a, b, h0 = diag_inputs(rng, B, T, D, dtype)
            # h0 in both dtypes, each read as it is (T = 1 included: the
            # step route's bits with an fp32 and a bf16 h0)
            for init in (None, h0, h0.bfloat16()):
                err = diag_close(a, b, init, chunk, dtype,
                                 f"diag {case} {dtype} h0 "
                                 f"{None if init is None else init.dtype}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # the served path: recurrentgemma-9b's 4 prompts of 2100 tokens over
    # d_model = 4096 channels, in bf16 (the 24 superblock layers) and in
    # fp32 (the 2 rem layers, whose fp32 vectors promote), from the cache's
    # bf16 zero state; and one decode step (T = 1) from a state
    B, T, D = 4, 2100, 4096
    zero = torch.zeros((B, D), dtype=torch.bfloat16, device=DEV)
    # at the served width with a near 1: with sigmoid draws the product of
    # a's over a few hundred steps underflows to 0, and a kernel that lost
    # the carry from one stage of its ring to the next would still agree
    for dtype in (torch.float32, torch.bfloat16):
        a, b, h0 = diag_inputs(rng, B, T, D, dtype, near_one=True)
        worst[f"T={T} near one {dtype}"] = diag_close(
            a, b, h0, 256, dtype, f"diag served T={T} a near one {dtype}")
        del a, b
    served = {}
    work = {}
    for dtype, T_ in ((torch.bfloat16, T), (torch.float32, T),
                      (torch.bfloat16, 1), (torch.float32, 1)):
        a, b, _ = diag_inputs(rng, B, T_, D, dtype)
        init = zero if T_ > 1 else rand(rng, (B, D), dtype)
        err = diag_close(a, b, init, 256, dtype, f"diag served T={T_} {dtype}")

        def run():
            return diag_scan(a, b, init, impl="kernel")

        # a, b read and h written; h0 read and h_T written
        nbytes = 3 * a.numel() * a.element_size() \
            + B * D * (init.element_size() + a.element_size())
        bound_ms, bound_by = bound(nbytes, 2 * a.numel(), dtype)
        work[f"T={T_} {dtype}"] = dict(flops=2 * a.numel(), bytes=nbytes)
        served[f"T={T_} {dtype}"] = dict(
            kernel_route=scan_kernel.diag_route(T_),
            plan=scan_kernel.diag_plan_built(B, T_, D, dtype),
            h0_dtype=str(init.dtype), bits_equal_plain=True,
            max_abs_err=err, ms=time_ms(run), call_ms=time_ms(run, spin=False),
            plain_ms=time_ms(lambda: diag_scan(a, b, init, impl="xla"),
                             reps=5 if T_ > 1 else 20),
            bound_ms=bound_ms, bound_by=bound_by)
    # the floor of this timing for one launch: the step kernel on 8
    # channels, next to nothing to move (its own generator, so that the
    # later kernels' inputs stay those of the earlier slices)
    frng = np.random.default_rng(16)
    a, b, _ = diag_inputs(frng, 1, 1, 8, torch.bfloat16)
    init = rand(frng, (1, 8), torch.bfloat16)
    served[f"T=1 {torch.bfloat16}"]["launch_floor_ms"] = time_ms(
        lambda: diag_scan(a, b, init, impl="kernel"))
    log("diag_work", json.dumps(work))
    top = served[f"T={T} {torch.bfloat16}"]
    return dict(name="diag_scan", route="cuda",
                source="src/repro_torch/csrc/diag_scan.cu",
                replaces="src/repro/kernels/linear_scan/kernel.py:49",
                shape=f"B={B} T={T} D={D} bf16, h0 bf16 zeros",
                tolerance=TOL[torch.bfloat16], cases_max_abs_err=worst,
                kernel_ms=top["ms"], library_ms=None, served=served,
                **{k: top[k] for k in ("max_abs_err", "ms", "call_ms",
                                       "plain_ms", "bound_ms", "bound_by")})


def shuffle_inputs(rng, T, D, E, K, C, kind, dtype):
    """x [T, D], y [E, C, D] and fp32 gates [T, K] on the card, and int32
    expert ids and slots [T, K]. ``kind``: "slots" (K distinct experts a
    token, slots from ``compute_slots``, some past C), "drops" (as "slots",
    then ids of -1 and E and slots of -1 and C + 3 here and there) or
    "repeats" (ids and slots drawn at random: pairs share rows and sum)."""
    x, y = rand(rng, (T, D), dtype), rand(rng, (E, C, D), dtype)
    gates = torch.from_numpy(rng.random((T, K))).to(DEV, torch.float32)
    if kind == "repeats":
        eid = rng.integers(0, E, size=(T, K))
        slot = rng.integers(0, C, size=(T, K))
    else:
        eid = np.argsort(rng.random((T, E)), axis=1)[:, :K]
        slot = compute_slots(torch.from_numpy(eid), E, C).numpy()
        if kind == "drops":
            u, v = rng.random((T, K)), rng.random((T, K))
            eid = np.where(u < 0.1, -1, np.where(u < 0.15, E, eid))
            slot = np.where(v < 0.05, -1, np.where(v < 0.1, C + 3, slot))
    ids = [torch.from_numpy(a.astype(np.int32)).to(DEV) for a in (eid, slot)]
    return x, y, gates, ids[0], ids[1]


def shuffle_close(x, y, gates, eid, slot, E, C, what):
    """dispatch and combine (gates in fp32 and in the data's dtype) against
    their plain versions. Returns the max abs errors."""
    dtype = x.dtype
    out = dispatch(x, eid, slot, E, C, impl="kernel")
    torch.cuda.synchronize()
    if out.dtype != dtype:
        _fail(f"dispatch {what}: dtype {out.dtype}")
    d_err = close_or_fail(out, dispatch(x, eid, slot, E, C, impl="xla"),
                          SHUFFLE_TOL[dtype], f"dispatch {what}")
    c_err = 0.0
    for g in {gates, gates.to(dtype)}:
        out = combine(y, eid, slot, g, x.shape[0], impl="kernel")
        torch.cuda.synchronize()
        if out.dtype != dtype:
            _fail(f"combine {what}: dtype {out.dtype}")
        c_err = max(c_err, close_or_fail(
            out, combine(y, eid, slot, g, x.shape[0], impl="xla"),
            SHUFFLE_TOL[dtype], f"combine {what} gates {g.dtype}"))
    return d_err, c_err


def served_routing(rng, B, T, E, K, C):
    """grok-1-314b's routing as the MoE block hands it to the kernels: K
    distinct experts of E a token, row b's ids offset by b * E, slots over
    the B * E buffers from ``compute_slots``."""
    eid = np.argsort(rng.random((B, T, E)), axis=2)[..., :K]
    flat = torch.from_numpy(eid + E * np.arange(B)[:, None, None]).reshape(
        B * T, K)
    slot = compute_slots(flat, B * E, C)
    return flat.int().to(DEV), slot.to(DEV)


def gather_or_fail(x, eid, slot, R, C, what):
    """Under served routing every kept pair has a row of its own: dispatch
    must be the gather of the kept tokens' x at their rows, bit for bit,
    and 0.0 in every other row."""
    out = dispatch(x, eid, slot, R, C, impl="kernel")
    kept = (slot >= 0) & (slot < C)
    rows = (eid.long() * C + slot.long())[kept]
    if torch.unique(rows).numel() != rows.numel():
        _fail(f"dispatch {what}: served rows are not unique")
    expect = torch.zeros((R * C, x.shape[1]), dtype=x.dtype, device=DEV)
    expect[rows] = x.index_select(0, torch.nonzero(kept)[:, 0])
    if not torch.equal(out.reshape(R * C, -1), expect):
        _fail(f"dispatch {what}: not the gather of the kept tokens")


def in_token_order(x, eid, slot, E, C):
    """Each row's fp32 sum of x over its pairs, one after another in pair
    (so token) order as numpy's cumsum takes them, in x's dtype [E, C, D]."""
    xs = x.float().cpu().numpy()
    e = eid.reshape(-1).cpu().numpy()
    rows = e * C + slot.reshape(-1).cpu().numpy()
    out = np.zeros((E * C, xs.shape[1]), np.float32)
    for row in np.unique(rows):
        toks = np.nonzero(rows == row)[0] // eid.shape[1]
        out[row] = np.cumsum(xs[toks], axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(out.reshape(E, C, -1)).to(DEV, x.dtype)


def check_overflow(rng, dtype):
    """OVERFLOW_CASES on the walk route: bits equal the sequential sum in
    token order (normal draws), and the plain version within the reference's
    tolerance where x holds small integers (every fp32 partial sum exact,
    so any summation order gives the same value). Returns the max abs
    errors against the plain version."""
    errs = {}
    for kind, T, D, E, K, C in OVERFLOW_CASES:
        if kind == "one row":
            eid = torch.zeros((T, K), dtype=torch.int32, device=DEV)
            slot = eid.clone()
        else:
            eid, slot = (torch.from_numpy(rng.integers(0, n, size=(T, K))
                                          .astype(np.int32)).to(DEV)
                         for n in (E, C))
        if shuffle_kernel.dispatch_route(T * K) != "walk":
            _fail(f"overflow {kind}: not on the walk route")
        x = rand(rng, (T, D), dtype)
        out = dispatch(x, eid, slot, E, C, impl="kernel")
        if not torch.equal(out, in_token_order(x, eid, slot, E, C)):
            _fail(f"dispatch overflow {kind} {dtype}: not the sum in token "
                  f"order")
        xi = torch.from_numpy(rng.integers(-8, 9, size=(T, D))).to(DEV, dtype)
        errs[f"overflow {kind} {dtype}"] = close_or_fail(
            dispatch(xi, eid, slot, E, C, impl="kernel"),
            dispatch(xi, eid, slot, E, C, impl="xla"), SHUFFLE_TOL[dtype],
            f"dispatch overflow {kind} {dtype}")
    return errs


def check_shuffle(rng):
    """The dispatch and combine kernels against their plain versions (and
    dispatch past its hit list), then at grok-1-314b's served prefill (4
    rows x 512 tokens, top-2 of 8 experts, C = 160, D = 6144, bf16) and
    decode (T = 1, C = 4): dispatch bit for bit the gather of the kept
    tokens, and timed."""
    worst = {"dispatch": {}, "combine": {}}

    def note(key, errs):
        for name, err in zip(("dispatch", "combine"), errs):
            worst[name][key] = max(worst[name].get(key, 0.0), err)

    for dtype in (torch.float32, torch.bfloat16):
        for case in SHUFFLE_CASES:
            for kind in ("slots", "drops", "repeats"):
                T, D, E, K, C = case
                note(f"{kind} {dtype}", shuffle_close(
                    *shuffle_inputs(rng, T, D, E, K, C, kind, dtype), E, C,
                    f"{case} {kind} {dtype}"))
    # the reference's round trip: K = 1, no drops, gate 1 gives x back
    T, D, E, C = 32, 8, 4, 32
    x = rand(rng, (T, D), torch.float32)
    eid = torch.from_numpy(rng.integers(0, E, size=(T, 1))).to(DEV)
    slot = compute_slots(eid, E, C)
    back = combine(dispatch(x, eid, slot, E, C, impl="kernel"), eid, slot,
                   torch.ones((T, 1), device=DEV), T, impl="kernel")
    torch.cuda.synchronize()
    worst["combine"]["round trip"] = close_or_fail(back, x, 1e-6, "round trip")
    for dtype in (torch.float32, torch.bfloat16):
        worst["dispatch"].update(check_overflow(rng, dtype))
    B, E, K, D = 4, 8, 2, 6144
    entries = {"dispatch": {}, "combine": {}}
    work = {}
    for T, C in ((512, 160), (1, 4)):
        eid, slot = served_routing(rng, B, T, E, K, C)
        N, R = B * T, B * E
        for dtype in (torch.float32, torch.bfloat16):
            x, y = rand(rng, (N, D), dtype), rand(rng, (R, C, D), dtype)
            gates = torch.from_numpy(rng.random((N, K))).to(DEV, dtype)
            errs = shuffle_close(x, y, gates.float(), eid, slot, R, C,
                                 f"served T={T} {dtype}")
            note(f"served T={T} {dtype}", errs)
            gather_or_fail(x, eid, slot, R, C, f"served T={T} {dtype}")
        # timed in bf16, the served dtype, with bf16 gates as the MoE block
        # passes them
        kept = (slot >= 0) & (slot < C)
        tok = torch.nonzero(kept)[:, 0]
        rows = (eid.long() * C + slot.long())[kept]
        sel = torch.unique(rows)
        elem = x.element_size()
        ids = 2 * eid.numel() * 4
        n_kept = int(kept.sum())
        d_bytes = (int(torch.unique(tok).numel()) + R * C) * D * elem + ids
        c_bytes = (int(sel.numel()) + N) * D * elem + ids \
            + gates.numel() * elem
        work[f"T={T}"] = dict(
            tokens=N, buffers=R, capacity=C, kept_pairs=n_kept,
            dispatch_bytes=d_bytes, dispatch_flops=n_kept * D,
            combine_bytes=c_bytes, combine_flops=2 * n_kept * D)
        mg = torch.zeros((N, R * C), dtype=dtype, device=DEV)
        mg.index_put_((tok, rows), gates[kept], accumulate=True)
        mg = mg.reshape(N, R, C)
        flat_x = torch.zeros((R * C, D), dtype=dtype, device=DEV)
        runs = {
            "dispatch": (lambda: dispatch(x, eid, slot, R, C, impl="kernel"),
                         lambda: dispatch(x, eid, slot, R, C, impl="xla"),
                         lambda: flat_x.zero_().index_add_(
                             0, rows, x.index_select(0, tok)),
                         d_bytes, n_kept * D),
            "combine": (lambda: combine(y, eid, slot, gates, N, impl="kernel"),
                        lambda: combine(y, eid, slot, gates, N, impl="xla"),
                        lambda: torch.einsum("tec,ecd->td", mg, y),
                        c_bytes, 2 * n_kept * D),
        }
        for name, (kern, plain, lib, nbytes, flops) in runs.items():
            bound_ms, bound_by = bound(nbytes, flops, dtype)
            entries[name][f"T={T}"] = dict(
                max_abs_err=worst[name][f"served T={T} {dtype}"],
                ms=time_ms(kern), call_ms=time_ms(kern, spin=False),
                plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib),
                bound_ms=bound_ms, bound_by=bound_by)
        entries["dispatch"][f"T={T}"]["kernel_route"] = \
            shuffle_kernel.dispatch_route(N * K)
        del x, y, mg, flat_x
    # where dispatch's time goes: the prefill's routing at D = 8 (the same
    # grid and walk, one 16-byte piece a row: walk_ms), and a launch with
    # next to nothing to move (the direct route on one row of 8:
    # launch_floor_ms). Their own generator, so that the later phases'
    # inputs stay those of the earlier slices
    frng = np.random.default_rng(17)
    eid, slot = served_routing(frng, B, 512, E, K, 160)
    x8 = rand(frng, (B * 512, 8), torch.bfloat16)
    entries["dispatch"]["T=512"]["walk_ms"] = time_ms(
        lambda: dispatch(x8, eid, slot, B * E, 160, impl="kernel"))
    one = torch.zeros((1, 1), dtype=torch.int32, device=DEV)
    x1 = rand(frng, (1, 8), torch.bfloat16)
    entries["dispatch"]["T=1"]["launch_floor_ms"] = time_ms(
        lambda: dispatch(x1, one, one, 1, 1, impl="kernel"))
    log("shuffle_work", json.dumps(work))
    out = []
    for name, line in (("dispatch", 51), ("combine", 105)):
        top = entries[name]["T=512"]
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/shuffle_dispatch.cu",
            replaces=f"src/repro/kernels/shuffle_dispatch/kernel.py:{line}",
            shape=f"N={B}x512 tokens K={K} buffers={B}x{E} C=160 D={D} bf16",
            tolerance=SHUFFLE_TOL[torch.bfloat16],
            cases_max_abs_err=worst[name], kernel_ms=top["ms"],
            served=entries[name], **top))
    return out


def check_model_small(cfg, rng, tol, n_layers=2, T=130, **impls):
    """The LM's kernel path against its plain path on a small input:
    ``n_layers`` full-width layers in fp32, prefill logits over ``T`` tokens
    and, for the hybrid and MoE families, one decode step. ``impls``: the
    plain path's impls."""
    small = cfg.with_(n_layers=n_layers, compute_dtype="float32",
                      kv_cache_dtype="float32")
    kern = build_model(small)
    plain = build_model(small, **impls)
    params = kern.init(torch.Generator("cuda").manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, T)))
    lk, ck = kern.prefill(params, {"tokens": toks}, max_len=T + 8)
    lp, cp = plain.prefill(params, {"tokens": toks}, max_len=T + 8)
    torch.cuda.synchronize()
    what = f"{cfg.name} {n_layers}-layer"
    err = close_or_fail(lk, lp, tol, f"{what} prefill kernel vs plain")
    if cfg.family in ("hybrid", "moe"):
        nxt = lp[:, -1:].argmax(dim=-1)
        del lk, lp
        dk, _ = kern.decode_step(params, {"tokens": nxt}, ck, T)
        dp, _ = plain.decode_step(params, {"tokens": nxt}, cp, T)
        torch.cuda.synchronize()
        err = max(err, close_or_fail(dk, dp, tol,
                                     f"{what} decode kernel vs plain"))
    return err


# -- phase 4: serve ---------------------------------------------------------------
def serve(cfg, prompts, expect, hbm_pages=None, max_len=552, params=None,
          routes=None):
    """``expect``: {counted wrapper: launches per batch} that the path must
    make exactly; ``routes``: {counted wrapper: {route: launches per
    batch}}, the same for its routes. With ``hbm_pages`` the pool is too
    small for a batch and must offload; without, it is ServeLoop's default.
    ``params``: the model's params (else ServeLoop draws its own)."""
    loop = ServeLoop(cfg, batch_slots=4, max_len=max_len,
                     hbm_pages=hbm_pages, params=params)
    reqs = [Request(i, p, max_new_tokens=32) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    out = loop.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if len(out) != len(prompts):
        _fail(f"served {len(out)} of {len(prompts)} requests")
    for rid, toks in out.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab for t in toks):
            _fail(f"request {rid}: {len(toks)} tokens, ids {toks[:4]}...")
    st = loop.stats
    if hbm_pages is not None and st["offloads"] <= 0:
        _fail("the page pool never offloaded")
    n_prefills = -(-len(prompts) // 4)
    for kernel, per_batch in expect.items():
        want = per_batch * n_prefills
        if kernel.launches != want:
            _fail(f"{kernel.__name__} kernel launched {kernel.launches} "
                  f"times, want {want}")
    if flash_attention in expect and (flash_attention.launches_by_route["wgmma"]
                                      != flash_attention.launches):
        _fail(f"flash_attention launches by route "
              f"{flash_attention.launches_by_route}: not all on wgmma")
    for kernel, per_route in (routes or {}).items():
        want = {r: n * n_prefills for r, n in per_route.items()}
        got = {r: n for r, n in kernel.launches_by_route.items() if n or r in want}
        if got != want:
            _fail(f"{kernel.__name__} launches by route {got}, want {want}")
    report = dict(arch=cfg.name, requests=len(out), wall_s=wall_s,
                  prefill_ms_per_batch=st["prefill_s"] / n_prefills * 1e3,
                  decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                  decode_tok_per_s_whole_run=st["decode_tok_per_s"],
                  prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                  pager_s=st["pager_s"],
                  offloads=st["offloads"], fetches=st["fetches"],
                  offload_bytes=st["offload_bytes"],
                  peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("serve", json.dumps(report))
    return loop


# -- phase 5: the KV page pool read in place ---------------------------------------
def kv_pool(loop, cfg, prompts, rng):
    L, KH, D, page = cfg.n_layers, cfg.kv_heads, cfg.resolved_head_dim, cfg.page_size
    H = cfg.n_heads
    lengths = [512, 461, 300, 130]                   # 8 + 8 + 5 + 3 pages
    _, cache = loop.model.prefill(
        loop.params_c, {"tokens": torch.from_numpy(np.stack(prompts[:4]))})
    dense_k, dense_v = cache["k"].float(), cache["v"].float()  # [L, B, KH, T, D]
    # fp32 as ServeLoop builds it; 20 slots < 24 pages written
    pool = PagedKVCache(num_layers=L, hbm_pages=20, page_size=page,
                        kv_heads=KH, head_dim=D, dtype=np.float32)
    written = {}
    for s, n in enumerate(lengths):
        pool.start_sequence(s)
        pool.ensure_capacity(s, n)
        pool.advance(s, n)
        for i in range(pool.num_pages(s)):
            sl = slice(i * page, (i + 1) * page)
            slab = torch.stack([cache["k"][:, s, :, sl].transpose(1, 2),
                                cache["v"][:, s, :, sl].transpose(1, 2)], dim=2)
            pool.write_page(s, i, slab)              # bf16 widens to fp32 exactly
            written[(s, i)] = slab.float().cpu().numpy()
    gen = torch.Generator("cuda").manual_seed(2)

    def attend(seqs):
        # one batch's pages fit the pool together: a restore inside
        # block_table may evict a page of another table (exclude_set is
        # ignored, as in the reference)
        max_pages = max(pool.num_pages(s) for s in seqs)
        tables = np.stack([pool.block_table(s, max_pages) for s in seqs])
        lens = np.asarray([pool.seq_length(s) for s in seqs], np.int32)
        q = torch.randn((len(seqs), H, D), generator=gen, device=DEV)
        worst = 0.0
        for layer in range(L):
            out = paged_attention(q, pool.kv[layer], tables, lens, impl="kernel")
            torch.cuda.synchronize()
            plain = paged_attention(q, pool.kv[layer], tables, lens, impl="xla")
            worst = max(worst, close_or_fail(out, plain, POOL_TOL,
                                             f"pool layer {layer} vs plain"))
            for j, s in enumerate(seqs):
                n = lengths[s]
                dense = attention_ref(q[j][None, :, None],
                                      dense_k[layer, s][None, :, :n],
                                      dense_v[layer, s][None, :, :n],
                                      causal=False)[0, :, 0]
                worst = max(worst, close_or_fail(
                    out[j], dense, POOL_TOL, f"pool layer {layer} seq {s} vs dense"))
        return worst

    worst = max(attend([0, 3]), attend([1, 2]), attend([0, 3]))
    st = pool.stats
    if st["offloads"] <= 0 or st["fetches"] <= 0:
        _fail(f"pool did not evict and restore: {st}")
    for (s, i), slab in written.items():
        if pool.read_page(s, i).tobytes() != slab.tobytes():
            _fail(f"read_page({s}, {i}) differs from what was written")
    log("kv_pool", json.dumps(dict(max_abs_err=worst, tolerance=POOL_TOL, **st)))


# -- phase 13: the serving tier at qwen3-0.6b's KV geometry -------------------------
TIER_POOL_PAGES = 32       # a node's device pool: 32 fp32 slabs of 14.68 MB
TIER_SESSIONS = 16
TIER_PROMPTS = (448, 960)  # prompt tokens: 7 to 15 pages of 64
TIER_HOST_SLABS = 8        # a shard's host budget, in slabs: level 3 fires
TIER_DECODE, TIER_FAILOVER_DECODE = 16, 4


def tier_batches(tier):
    """Per-shard batches of sessions whose pages fit the shard's pool
    together: a restore inside one table may evict a page that another
    table of the same batch points at (exclude_set is ignored, as in the
    reference)."""
    by_node = {}
    for s, sess in sorted(tier.sessions.items()):
        by_node.setdefault(sess.node, []).append(s)
    batches = []
    for _node, seqs in sorted(by_node.items()):
        cur, used = [], 0
        for s in seqs:
            n = tier._pages_for(tier.sessions[s].length)
            if cur and used + n > tier.hbm_pages_per_node:
                batches.append(cur)
                cur, used = [], 0
            cur.append(s)
            used += n
        batches.append(cur)
    return batches


def tier_dense(tier, s):
    """fp64 softmax attention of session s's q over its K/V as the oracle
    (``expected_slabs``, not the pool) has them: [L, KH, D]."""
    n = tier.sessions[s].length
    kv = torch.from_numpy(np.concatenate(tier.expected_slabs(s), axis=1)
                          [:, :n]).to(DEV, torch.float64)   # [L, n, 2, KH, D]
    k, v = kv[:, :, 0], kv[:, :, 1]
    q = torch.full((tier.kv_heads, tier.head_dim),
                   float(np.float32(token_value(s, n))), dtype=torch.float64,
                   device=DEV)
    p = torch.softmax(torch.einsum("hd,lthd->lht", q, k)
                      * tier.head_dim ** -0.5, dim=-1)
    return torch.einsum("lht,lthd->lhd", p, v).cpu()


def tier_attend(tier, want):
    """``attend(impl="kernel")`` at every layer over every per-shard batch,
    held to ``attend(impl="xla")`` and, where the batch's pages fit the
    pool, to dense fp64 attention over the oracle's K/V, at POOL_TOL (a
    session longer than the pool has its own pages evict one another while
    its table is built, so kernel and plain version read the same stale
    slots). ``want["paged"]`` gains the launches each call must make: one
    a shard, counted from ``tier.sessions``. Returns the largest error and
    the sessions held to the dense answer."""
    worst, dense_checked = 0.0, []
    for batch in tier_batches(tier):
        fits = sum(tier._pages_for(tier.sessions[s].length)
                   for s in batch) <= tier.hbm_pages_per_node
        dense = {s: tier_dense(tier, s) for s in batch} if fits else {}
        dense_checked += sorted(dense)
        for layer in range(tier.num_layers):
            want["paged"] += len({tier.sessions[s].node for s in batch})
            ker = tier.attend(batch, layer, impl="kernel")
            plain = tier.attend(batch, layer, impl="xla")
            for s in batch:
                got = torch.from_numpy(ker[s])
                worst = max(worst, close_or_fail(
                    got, torch.from_numpy(plain[s]), POOL_TOL,
                    f"tier layer {layer} seq {s} vs plain"))
                if s in dense:
                    worst = max(worst, close_or_fail(
                        got, dense[s][layer], POOL_TOL,
                        f"tier layer {layer} seq {s} vs dense"))
    return worst, dense_checked


def tier_settle(tier):
    """Wait until no level-3 copy is in flight on any shard."""
    for shard in tier._shards.values():
        while shard.store._inflight:
            tier.cluster.transfer.drain(timeout=60.0)
            shard.store._reap()


def tier_counters(tier):
    """The tier's stats, each shard's pager (pool) and spill (store)
    counters, and each live node's replication: its replica and level-3
    blobs and the bytes its pool holds for them."""
    nodes = {}
    for nid, rep in tier.cluster.pressure_report().items():
        if nid not in tier.cluster.nodes:     # -1: the cluster's own manager
            continue
        sets = tier.cluster.nodes[nid].pool.paging.sets
        nodes[nid] = dict(
            replica_blobs=sum(n.startswith("kvrep/") for n in sets),
            spill_blobs=sum(n.startswith("kvspill/") for n in sets),
            resident_bytes=rep["resident"], spilled_bytes=rep["spilled"],
            reserved_bytes=rep["reserved"], refused=rep["refused"],
            forced=rep["forced"])
    return dict(tier=dict(tier.stats), nodes=nodes, shards={
        node: dict(pool=dict(sh.cache.stats), store=dict(sh.store.stats),
                   host_bytes=sh.store.host_bytes,
                   resident_pages=sh.cache.resident_pages())
        for node, sh in sorted(tier._shards.items())})


def tier_verify(tier, what):
    for s in sorted(tier.sessions):
        if not tier.verify(s):
            _fail(f"tier {what}: session {s} differs from the oracle")


def tier_inproc(cfg, want):
    """qwen3-0.6b's KV in the tier's own fp32 on a four-node inproc cluster:
    admit TIER_SESSIONS prompts, decode, attend and verify, kill one
    session's primary, decode (failover), attend and verify again. Returns
    the report, the live tier and its cluster (for the timed launch)."""
    rng = np.random.default_rng(1300)
    prompts = {s: int(n) for s, n in enumerate(
        rng.integers(TIER_PROMPTS[0], TIER_PROMPTS[1] + 1, TIER_SESSIONS))}
    geometry = dict(num_layers=cfg.n_layers, page_tokens=cfg.page_size,
                    kv_heads=cfg.kv_heads, head_dim=cfg.resolved_head_dim)
    slab_nbytes = int(np.prod(list(geometry.values()))) * 2 * 4
    cluster = Cluster(4, node_capacity=3 << 30, page_size=1 << 20,
                      replication_factor=1, admission=True)
    tier = ServingTier(cluster, hbm_pages_per_node=TIER_POOL_PAGES,
                       host_budget_bytes=TIER_HOST_SLABS * slab_nbytes,
                       dtype=np.float32, device="cuda", **geometry)
    report = dict(sessions=TIER_SESSIONS, prompts=prompts,
                  slab_mb=tier.slab_nbytes / 1e6,
                  pool_gb=4 * TIER_POOL_PAGES * tier.slab_nbytes / 1e9,
                  host_budget_mb=tier.host_budget_bytes / 1e6)
    t0 = time.perf_counter()
    plan = tier.admit(prompts)
    report["diversions"] = {s: list(d) for s, d in plan.diversions.items()}
    report["admit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tier.decode(sorted(prompts), steps=TIER_DECODE)
    report["decode_s"] = time.perf_counter() - t0
    tier_settle(tier)
    report["after_decode"] = tier_counters(tier)
    stores = [sh.store.stats for sh in tier._shards.values()]
    pools = [sh.cache.stats for sh in tier._shards.values()]
    if not (sum(p["offloads"] for p in pools) > 0
            and sum(st["host_puts"] for st in stores) > 0
            and sum(st["remote_spills"] for st in stores) > 0):
        _fail(f"tier: spills did not reach level 3: {report['after_decode']}")
    t0 = time.perf_counter()
    report["max_abs_err"], dense_checked = tier_attend(tier, want)
    report["attend_s"] = time.perf_counter() - t0
    if sorted(dense_checked) != sorted(prompts):
        _fail(f"tier: only sessions {dense_checked} held to the dense answer")
    t0 = time.perf_counter()
    tier_verify(tier, "after decode")
    report["verify_s"] = time.perf_counter() - t0
    victim = tier.sessions[0].node
    cluster.kill_node(victim)
    report["killed_node"] = victim
    tier.decode(sorted(prompts), steps=TIER_FAILOVER_DECODE)
    if tier.stats["failovers"] < 1:
        _fail(f"tier: no failover after node {victim} died: {tier.stats}")
    err, dense_checked = tier_attend(tier, want)
    report["max_abs_err"] = max(report["max_abs_err"], err)
    if sorted(dense_checked) != sorted(prompts):
        _fail(f"tier: only sessions {dense_checked} held to the dense answer "
              f"after the failover")
    tier_verify(tier, "after failover")
    tier_settle(tier)
    report["after_failover"] = tier_counters(tier)
    return report, tier, cluster


def tier_proc(want):
    """The tier on the card over a four-node proc cluster, its node
    processes forked after CUDA is up: admit, decode, a SIGKILL of a
    session's primary mid-decode, failover, verify, attend. Fails unless
    close() leaves no child and no shared-memory segment, and no envelope
    value was refused as non-JSON."""
    before = pickle_fallbacks()
    cluster = Cluster(4, backend="proc", node_capacity=8 << 20,
                      page_size=1 << 14, replication_factor=1, admission=True)
    try:
        tier = ServingTier(cluster, hbm_pages_per_node=3,
                           host_budget_bytes=1024, device="cuda")
        tier.admit({1: 10, 2: 6})
        tier.decode([1, 2], steps=4)
        victim = tier.sessions[1].node
        tier.add_fault_hook("mid_decode", lambda: cluster.kill_node(victim))
        tier.decode([1, 2], steps=6)
        if tier.stats["failovers"] < 1:
            _fail(f"proc tier: no failover after SIGKILL: {tier.stats}")
        tier_verify(tier, "proc")
        worst, dense_checked = tier_attend(tier, want)
        stats = dict(tier.stats)
        tier.close()
    finally:
        cleanup = cluster.close()
    if not cleanup.ok:
        _fail(f"proc tier: close() left {cleanup}")
    if pickle_fallbacks() != before:
        _fail("proc tier: an rpc value was refused as non-JSON")
    return dict(killed_node=victim, max_abs_err=worst, stats=stats,
                dense_checked=dense_checked, close_ok=cleanup.ok)


def tier_timed(tier):
    """One attend launch at layer 0 over the largest per-shard batch, timed
    as phase 3 times its shapes (``paged_shape``)."""
    batch = max(tier_batches(tier), key=lambda b: sum(
        tier.sessions[s].length for s in b))
    shard = tier._shard(tier.sessions[batch[0]].node)
    max_pages = max(shard.cache.num_pages(s) for s in batch)
    bt = np.stack([shard.cache.block_table(s, max_pages) for s in batch])
    ln = np.array([tier.sessions[s].length for s in batch], np.int32)
    q = torch.from_numpy(np.stack([np.full(
        (tier.kv_heads, tier.head_dim), token_value(s, int(n)), np.float32)
        for s, n in zip(batch, ln)])).to(DEV)
    return paged_shape(q, shard.cache.kv[0], bt, ln)


# the port's own kernels: every __global__ function of csrc/*.cu
OUR_KERNELS = re.compile(r"\(anonymous namespace\)::(%s)\b" % "|".join(sorted(
    {name for src in _build.SOURCES for name in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        (_build.CSRC / f"{src}.cu").read_text())})))


def profile_steps(loop, prompts):
    """Where a warm prefill (the served batch: 4 x 512 tokens) and one warm
    decode step spend their time: host wall ms without and with
    torch.profiler, device busy ms (sum of kernel times in the profiled run),
    the device's idle share of the profiled wall time, the top kernels and
    the port's own kernels. Runs after the launch counts are read."""
    from torch.profiler import ProfilerActivity, profile
    model, params = loop.model, loop.params_c
    toks = torch.from_numpy(np.stack(prompts[:4]))
    state = {}

    def prefill():
        logits, state["cache"] = model.prefill(params, {"tokens": toks},
                                               max_len=loop.max_len)
        state["last"] = logits[:, -1].argmax(dim=-1)[:, None]
        state["finite"] = torch.isfinite(logits[:, -1]).all()

    def decode():
        logits, _ = model.decode_step(params, {"tokens": state["last"]},
                                      state["cache"], toks.shape[1])
        logits[:, 0].argmax(dim=-1)
        state["finite"] = torch.isfinite(logits).all()

    report = {}
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        ours = [e for e in kernels if OUR_KERNELS.search(e.key)]
        report[name] = dict(
            wall_ms=plain_wall * 1e3, profiled_wall_ms=wall * 1e3,
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / (wall * 1e3),
            kernel_launches=sum(e.count for e in kernels),
            top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                 for e in top],
            ours=[[OUR_KERNELS.search(e.key).group(1),
                   e.self_device_time_total / 1e3, e.count] for e in ours])
        if not bool(state["finite"]):
            _fail(f"{loop.cfg.name} {name}: non-finite logits")
    log("profile", loop.cfg.name, json.dumps(report))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Seconds since the last lap, kept for the ``elapsed`` line."""
        nonlocal t0
        now = time.perf_counter()
        phase_s[name] = now - t0
        t0 = now

    built = _build.build()
    lap("build")
    log("build", json.dumps(dict(seconds=phase_s["build"], per_source=built)))
    _DISASSEMBLY.update(start_disassembly(
        ("flash_attention", "paged_attention", "linear_scan", "diag_scan",
         "shuffle_dispatch")))
    rng = np.random.default_rng(42)
    kernels = [check_flash(rng), check_paged(rng), check_gla(rng),
               check_diag(rng), *check_shuffle(rng)]
    lap("kernels")
    flash_build = flash_build_facts()
    log("flash_build", json.dumps(flash_build))
    scan_build = scan_build_facts()
    log("scan_build", json.dumps(scan_build))
    shuffle_build = shuffle_build_facts()
    log("shuffle_build", json.dumps(shuffle_build))
    paged_build = paged_build_facts()
    log("paged_build", json.dumps(paged_build))
    lap("build facts")
    cfg = get_config("qwen3-0.6b")
    rcfg = get_config("rwkv6-3b")
    gcfg = get_config("recurrentgemma-9b")
    # grok-1-314b at full width and 4 of its 64 layers: 316.5 B params
    # (633 GB in bf16) do not fit one card
    kcfg = get_config("grok-1-314b").with_(n_layers=4)
    for c, tol, kw in ((cfg, 1e-4, dict(attn_impl="xla")),
                       (rcfg, 2e-4, dict(scan_impl="xla_chunked")),
                       (gcfg, 1e-4, dict(attn_impl="xla", scan_impl="xla",
                                         n_layers=4, T=2100)),
                       (kcfg, 1e-4, dict(attn_impl="xla", moe_impl="xla",
                                         n_layers=1))):
        # fp32 sums of a few layers taken in another order; GLA's own
        # tolerance for the scan. recurrentgemma-9b: one superblock (rec,
        # rec, attn) and one rem layer, past the window. grok-1-314b: one
        # layer (26 GB in fp32 with the embeddings)
        log("model_small", c.name, json.dumps(dict(
            max_abs_err=check_model_small(c, rng, tol, **kw),
            tolerance=tol)))
    lap("model_small")
    gc.collect()
    torch.cuda.empty_cache()
    counted = (flash_attention, paged_attention, gla_scan, diag_scan,
               dispatch, combine)

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        for fn in (flash_attention, gla_scan, diag_scan, dispatch):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    prompts = [np.random.default_rng(100 + i).integers(0, cfg.vocab, 512,
                                                       dtype=np.int32)
               for i in range(8)]
    zero_counts()
    loop = serve(cfg, prompts, {flash_attention: cfg.n_layers}, hbm_pages=18)
    kv_pool(loop, cfg, prompts, rng)
    if paged_attention.launches != 3 * cfg.n_layers:   # 3 attended batches
        _fail(f"paged_attention: {paged_attention.launches} launches on the "
              f"{cfg.name} path, not {3 * cfg.n_layers}")
    launches = {"flash_attention": {cfg.name: flash_attention.launches},
                "paged_attention": {cfg.name: paged_attention.launches}}
    flash_routes = {cfg.name: dict(flash_attention.launches_by_route)}
    profile_steps(loop, prompts)
    del loop
    free()
    lap("qwen3-0.6b")

    rprompts = [np.random.default_rng(200 + i).integers(0, rcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    zero_counts()
    rloop = serve(rcfg, rprompts, {gla_scan: rcfg.n_layers},
                  routes={gla_scan: {"mma": rcfg.n_layers}})
    launches["gla_scan"] = {rcfg.name: gla_scan.launches}
    scan_routes = {"gla_scan": {rcfg.name: dict(gla_scan.launches_by_route)}}
    profile_steps(rloop, rprompts)
    del rloop
    free()
    lap("rwkv6-3b")

    # recurrentgemma-9b: 10.4 B params, 41.8 GB in fp32. Cast to bf16 once
    # and free the fp32 tree before serving (ServeLoop's own cast then keeps
    # the same tensors), so 21 GB stay resident.
    gmodel = build_model(gcfg)
    gparams = gmodel._compute_cast(gmodel.init(
        torch.Generator("cuda").manual_seed(3)))
    free()
    gprompts = [np.random.default_rng(300 + i).integers(0, gcfg.vocab, 2100,
                                                        dtype=np.int32)
                for i in range(8)]
    n_rec = sum(k == "rec" for k in gcfg.block_pattern) * (
        gcfg.n_layers // len(gcfg.block_pattern)) \
        + gcfg.n_layers % len(gcfg.block_pattern)            # 24 + 2
    n_attn = gcfg.n_layers - n_rec                           # 12
    zero_counts()
    gloop = serve(gcfg, gprompts,
                  {diag_scan: n_rec * (1 + 32), flash_attention: n_attn},
                  max_len=2140, params=gparams,
                  routes={diag_scan: {"ring": n_rec, "step": n_rec * 32}})
    launches["diag_scan"] = {gcfg.name: diag_scan.launches}
    scan_routes["diag_scan"] = {gcfg.name: dict(diag_scan.launches_by_route)}
    launches["flash_attention"][gcfg.name] = flash_attention.launches
    flash_routes[gcfg.name] = dict(flash_attention.launches_by_route)
    del gparams
    profile_steps(gloop, gprompts)
    del gloop
    free()
    lap("recurrentgemma-9b")

    # grok-1-314b, 4 layers: 21.3 B params drawn straight in bf16 (42.6 GB;
    # one expert weight alone would be 25.8 GB in fp32)
    kmodel = build_model(kcfg)
    kparams = kmodel.init(torch.Generator("cuda").manual_seed(4),
                          dtype=torch.bfloat16)
    del kmodel
    kprompts = [np.random.default_rng(400 + i).integers(0, kcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    per_batch = kcfg.n_layers * (1 + 32)     # prefill and 32 decode steps
    zero_counts()
    # dispatch: the walk in prefill (2048 pairs a batch row), the direct
    # route in decode (8 pairs)
    kloop = serve(kcfg, kprompts, {dispatch: per_batch, combine: per_batch,
                                   flash_attention: kcfg.n_layers},
                  params=kparams,
                  routes={dispatch: {"walk": kcfg.n_layers,
                                     "direct": kcfg.n_layers * 32}})
    launches["dispatch"] = {kcfg.name: dispatch.launches}
    shuffle_routes = {kcfg.name: dict(dispatch.launches_by_route)}
    launches["combine"] = {kcfg.name: combine.launches}
    launches["flash_attention"][kcfg.name] = flash_attention.launches
    flash_routes[kcfg.name] = dict(flash_attention.launches_by_route)
    del kparams
    profile_steps(kloop, kprompts)
    del kloop
    free()
    lap("grok-1-314b")

    zero_counts()
    want = {"paged": 0}
    tier_report, tier, tier_cluster = tier_inproc(cfg, want)
    tier_report["proc"] = tier_proc(want)
    path = f"{cfg.name}/ServingTier"
    if paged_attention.launches != want["paged"]:
        _fail(f"paged_attention: {paged_attention.launches} launches on the "
              f"{path} path, not {want['paged']}")
    others = {fn.__name__: fn.launches for fn in counted
              if fn is not paged_attention and fn.launches}
    if others:
        _fail(f"{path}: other kernels launched: {others}")
    launches["paged_attention"][path] = paged_attention.launches
    tier_shape = tier_timed(tier)
    tier.close()
    tier_cluster.shutdown()
    del tier
    free()
    lap("serving tier")
    tier_report["seconds"] = phase_s["serving tier"]
    log("serving_tier", json.dumps(tier_report))
    next(k for k in kernels if k["name"] == "flash_attention").update(
        launches_by_route=flash_routes, build=flash_build)
    for name, lib in (("gla_scan", "linear_scan"), ("diag_scan", "diag_scan")):
        next(k for k in kernels if k["name"] == name).update(
            launches_by_route=scan_routes[name], build=scan_build[lib])
    next(k for k in kernels if k["name"] == "dispatch").update(
        launches_by_route=shuffle_routes,
        build={f: v for f, v in shuffle_build.items() if "dispatch" in f})
    next(k for k in kernels if k["name"] == "combine").update(
        build={f: v for f, v in shuffle_build.items() if "combine" in f})
    next(k for k in kernels if k["name"] == "paged_attention").update(
        build=paged_build, serving_tier=tier_shape)
    for k in kernels:
        k["launches_by_path"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]].values())
        if min(launches[k["name"]].values()) <= 0:
            _fail(f"{k['name']} was never launched on a main path: "
                  f"{launches[k['name']]}")
    log("elapsed", json.dumps(dict(seconds=time.perf_counter() - t_start,
                                   phases=phase_s)))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
