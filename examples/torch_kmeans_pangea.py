"""The paper's flagship application (§9.2.1) on the PyTorch port: k-means
over Pangea storage, computing on the GPU.

  PYTHONPATH=src python examples/torch_kmeans_pangea.py [--points 200000]
  PYTHONPATH=src python examples/torch_kmeans_pangea.py --device cpu

The job of examples/kmeans_pangea.py over ``repro_torch``: the input points
are a write-through locality set and the derived norms a write-back set.
Each iteration scans both sets through the buffer pool's page iterators, in
the iterators' order, into a host staging buffer a set (pinned on CUDA;
each page is copied out before the pool may evict or reuse it), moves each
buffer to the device in one copy, and runs ``assign_update`` there. The
products run in true fp32: TF32 stays off, torch's default.

It prints the JAX example's lines, then one JSON line of the numbers it
printed and each iteration's split: the pool scan with the host-to-device
copy (``scan_s``) and ``assign_update``'s device ms (``assign_ms``, CUDA
events; host seconds on the CPU). ``main(argv)`` returns that dict.
"""
import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core import BufferPool
from repro_torch.core.attributes import AttributeSet, DurabilityType
from repro_torch.core.services import SequentialWriter, get_page_iterators


def assign_update(points, norms, centroids):
    """One k-means step, the arithmetic of the JAX example's: returns the
    new centroids (an empty cluster's becomes 0) and the assignments (the
    first nearest centroid on a tie)."""
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 — the norms set saves a pass
    xc = points @ centroids.T
    c2 = (centroids ** 2).sum(-1)
    d = norms[:, None] - 2 * xc + c2[None, :]
    assign = torch.argmin(d, dim=1)
    onehot = F.one_hot(assign, centroids.shape[0]).to(points.dtype)
    sums = onehot.T @ points
    counts = onehot.sum(0)[:, None]
    return sums / torch.clamp(counts, min=1.0), assign


def scan_into(pool, ls, dtype, out: np.ndarray) -> int:
    """Copy the set's records into ``out`` in the page iterators' order;
    returns how many there were."""
    n = 0
    for it in get_page_iterators(pool, ls, dtype, 1):
        for recs in it:
            out[n:n + len(recs)] = recs
            n += len(recs)
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--pool-mb", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(args.points, args.dim)).astype(np.float32)
    pool = BufferPool(args.pool_mb << 20)
    pdt = np.dtype((np.float32, (args.dim,)))

    t0 = time.perf_counter()
    inp = pool.create_set("points", 1 << 20,
                          AttributeSet(durability=DurabilityType.WRITE_THROUGH))
    w = SequentialWriter(pool, inp, pdt)
    w.append_batch(pts)
    w.close()
    norms_ls = pool.create_set("norms", 1 << 20)   # write-back derived data
    nw = SequentialWriter(pool, norms_ls, np.dtype(np.float32))
    for it in get_page_iterators(pool, inp, pdt, 1):
        for recs in it:
            nw.append_batch((recs ** 2).sum(1))
    nw.close()
    init_s = time.perf_counter() - t0
    print(f"init (load + norms): {init_s:.3f}s")

    # a staging buffer for each set, refilled every iteration
    stage_p = torch.empty((args.points, args.dim), dtype=torch.float32,
                          pin_memory=cuda)
    stage_n = torch.empty((args.points,), dtype=torch.float32,
                          pin_memory=cuda)
    cents = torch.from_numpy(pts[:args.k].copy()).to(dev)
    iters = []
    for i in range(args.iters):
        t1 = time.perf_counter()
        n_pts = scan_into(pool, inp, pdt, stage_p.numpy())
        n_norms = scan_into(pool, norms_ls, np.dtype(np.float32),
                            stage_n.numpy())
        if n_pts != args.points or n_norms != args.points:
            raise RuntimeError(f"scanned {n_pts} points and {n_norms} norms, "
                               f"not {args.points}")
        points, norms = stage_p.to(dev), stage_n.to(dev)
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t2 = time.perf_counter()
        cents, assign = assign_update(points, norms, cents)
        if cuda:
            end.record()
            end.synchronize()
            assign_ms = start.elapsed_time(end)
        else:
            assign_ms = (time.perf_counter() - t2) * 1e3
        dt = time.perf_counter() - t1
        resident = pool.resident_bytes / 2**20
        spilled = pool.stats["spill_bytes"] / 2**20
        print(f"iter {i}: {dt:.3f}s "
              f"(pool resident {resident:.0f} MB, spilled {spilled:.0f} MB)")
        iters.append(dict(seconds=dt, scan_s=t2 - t1, assign_ms=assign_ms,
                          resident_mb=resident, spilled_mb=spilled))
        del points, norms
    sizes = np.bincount(assign.cpu().numpy(), minlength=args.k)
    print("cluster sizes:", sizes)
    result = dict(device=str(dev), points=args.points, dim=args.dim,
                  k=args.k, pool_mb=args.pool_mb, init_s=init_s,
                  iters=iters, cluster_sizes=sizes.tolist(),
                  centroids=cents.cpu().tolist())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
