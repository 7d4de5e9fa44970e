"""The port's PagedKVCache against the JAX package's: one op sequence on
both caches gives byte-identical pages, identical block tables and identical
stats; paged attention over the two pools agrees at 2e-5 (the reference's
tolerance, tests/test_kvcache.py). The scenarios are those of
tests/test_kvcache.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HBMExhaustedError as JaxHBMExhaustedError
from repro.core import PagedKVCache as JaxPagedKVCache
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.core import HBMExhaustedError, PagedKVCache
from repro_torch.kernels.paged_attention.ops import paged_attention

torch.set_num_threads(2)

GEOM = dict(num_layers=2, page_size=4, kv_heads=2, head_dim=4)

# (op, args...) sequences; "write" fills every page of a sequence with
# random slabs, "attend" runs paged attention over layer 0 of the pool
SCENARIOS = {
    "offload_and_restore": (4, [
        ("start", 0), ("ensure", 0, 8), ("advance", 0, 8), ("write", 0),
        ("start", 1), ("ensure", 1, 12), ("advance", 1, 12), ("write", 1),
        ("table", 0, 4)]),
    "finished_sequences_free_pages": (4, [
        ("start", 0), ("ensure", 0, 8), ("advance", 0, 8),
        ("start", 1), ("ensure", 1, 8), ("advance", 1, 8),
        ("finish", 0), ("start", 2), ("ensure", 2, 8)]),
    "cold_sequence_evicted_before_hot": (4, [
        ("start", 0), ("ensure", 0, 8), ("advance", 0, 8),
        ("start", 1), ("ensure", 1, 8), ("advance", 1, 8),
        ("table", 1, 2), ("start", 2), ("ensure", 2, 4)]),
    "own_pages_evicted_when_alone": (2, [
        ("start", 0), ("ensure", 0, 8), ("advance", 0, 8), ("table", 0, 2),
        ("start", 1), ("ensure", 1, 4)]),
    "ragged_partial_last_pages": (16, [
        ("start", 0), ("ensure", 0, 7), ("advance", 0, 7), ("write", 0),
        ("start", 1), ("ensure", 1, 5), ("advance", 1, 5), ("write", 1),
        ("start", 2), ("ensure", 2, 3), ("advance", 2, 3), ("write", 2),
        ("attend", (0, 1, 2))]),
    "length_one_sequence": (16, [
        ("start", 0), ("ensure", 0, 1), ("advance", 0, 1), ("write", 0),
        ("start", 1), ("ensure", 1, 9), ("advance", 1, 9), ("write", 1),
        ("attend", (0, 1))]),
    "noncontiguous_pages_after_evict_restore": (6, [
        ("start", 0), ("ensure", 0, 12), ("advance", 0, 12), ("write", 0),
        ("start", 2), ("ensure", 2, 12), ("advance", 2, 12), ("write", 2),
        ("start", 1), ("ensure", 1, 12), ("advance", 1, 12), ("write", 1),
        ("finish", 2), ("attend", (0, 1)), ("table", 0, 3)]),
}


def _run(cache, ops, jax_side):
    """Apply ``ops``; return the trace of tables, residency and attention."""
    rng = np.random.default_rng(0)
    qrng = np.random.default_rng(7)
    bf16 = "bfloat16" in str(cache.kv.dtype)
    trace = []
    for op, *args in ops:
        if op == "start":
            cache.start_sequence(args[0])
        elif op == "ensure":
            cache.ensure_capacity(*args)
        elif op == "advance":
            cache.advance(*args)
        elif op == "finish":
            cache.finish_sequence(args[0])
        elif op == "write":
            for k in range(cache.num_pages(args[0])):
                slab = rng.standard_normal((cache.num_layers, cache.page_size,
                                            2, cache.kv_heads, cache.head_dim))
                slab = slab.astype(np.float32)
                if bf16:   # the same bf16 values: ml_dtypes / uint16 bits
                    slab = np.asarray(jnp.asarray(slab, jnp.bfloat16))
                    if not jax_side:
                        slab = slab.view(np.uint16)
                cache.write_page(args[0], k, slab)
        elif op == "table":
            trace.append(("table", cache.block_table(*args).tolist()))
        elif op == "attend":
            seqs = args[0]
            max_pages = max(cache.num_pages(s) for s in seqs)
            tables = np.stack([cache.block_table(s, max_pages) for s in seqs])
            lengths = np.asarray([cache.seq_length(s) for s in seqs], np.int32)
            q = qrng.standard_normal(
                (len(seqs), cache.kv_heads, cache.head_dim)).astype(np.float32)
            trace.append(("table", tables.tolist()))
            if jax_side:
                outs = [np.asarray(jax_paged(q, cache.kv[0], tables, lengths,
                                             impl=impl))
                        for impl in ("xla", "kernel")]
            else:
                outs = [paged_attention(torch.from_numpy(q), cache.kv[0],
                                        tables, lengths, impl=impl).numpy()
                        for impl in ("xla", "kernel")]
            trace.append(("attend", outs))
        trace.append(("resident", cache.resident_pages()))
    return trace


def _slabs(cache):
    return {s: [a.tobytes() for a in cache.sequence_slabs(s)]
            for s in cache.active_sequences()}


def _compare(jax_cache, port_cache, ops):
    jt = _run(jax_cache, ops, jax_side=True)
    pt = _run(port_cache, ops, jax_side=False)
    assert len(jt) == len(pt)
    for (jk, jv), (pk, pv) in zip(jt, pt):
        assert jk == pk
        if jk == "attend":
            for a in jv + pv:      # JAX kernel/xla and port kernel/xla
                np.testing.assert_allclose(a, jv[0], rtol=2e-5, atol=2e-5)
            assert np.isfinite(pv[1]).all()
        else:
            assert jv == pv, jk
    assert jax_cache.stats == port_cache.stats
    assert _slabs(jax_cache) == _slabs(port_cache)
    return port_cache


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_op_sequence_matches_jax_fp32(name):
    hbm, ops = SCENARIOS[name]
    port = _compare(JaxPagedKVCache(hbm_pages=hbm, **GEOM),
                    PagedKVCache(hbm_pages=hbm, device="cpu", **GEOM), ops)
    if name in ("offload_and_restore", "noncontiguous_pages_after_evict_restore"):
        assert port.stats["offloads"] > 0 and port.stats["fetches"] > 0


@pytest.mark.parametrize("name", ["offload_and_restore",
                                  "noncontiguous_pages_after_evict_restore"])
def test_op_sequence_matches_jax_bf16_pool(name):
    """A bf16 pool moves its slabs as np.uint16 bytes; they equal the
    reference's ml_dtypes bfloat16 bytes."""
    hbm, ops = SCENARIOS[name]
    ops = [o for o in ops if o[0] != "attend"]
    port = _compare(
        JaxPagedKVCache(hbm_pages=hbm, dtype=jnp.bfloat16, **GEOM),
        PagedKVCache(hbm_pages=hbm, dtype="bfloat16", device="cpu", **GEOM),
        ops)
    assert port.kv.dtype == torch.bfloat16
    assert port.read_page(0, 0).dtype == np.uint16
    assert port.stats["offloads"] > 0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_op_sequence_matches_jax_bf16_pool_by_name(name):
    """Every scenario at a bf16 pool given as the JAX package gives it
    (ml_dtypes' bfloat16, taken by its name): the same tables and stats,
    and slabs as ``np.uint16`` bits of the JAX slab."""
    hbm, ops = SCENARIOS[name]
    ops = [o for o in ops if o[0] != "attend"]
    port = _compare(JaxPagedKVCache(hbm_pages=hbm, dtype=jnp.bfloat16, **GEOM),
                    PagedKVCache(hbm_pages=hbm, dtype=jnp.bfloat16,
                                 device="cpu", **GEOM), ops)
    assert port.kv.dtype == torch.bfloat16
    assert port.host_dtype == np.uint16
    assert port.slab_nbytes == 2 * 4 * 2 * 2 * 4 * 2
    for s in port.active_sequences():
        for slab in port.sequence_slabs(s):
            assert slab.dtype == port.host_dtype
    if name in ("offload_and_restore", "noncontiguous_pages_after_evict_restore"):
        assert port.stats["offloads"] > 0 and port.stats["fetches"] > 0


@pytest.mark.parametrize("bad", [np.float64, np.int8, np.float16,
                                 torch.float64, torch.float16, torch.int32,
                                 "float8"])
def test_pool_refuses_dtypes_it_does_not_hold(bad):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        PagedKVCache(hbm_pages=2, dtype=bad, device="cpu", **GEOM)


def test_restored_pages_keep_their_bytes():
    kv = PagedKVCache(hbm_pages=6, device="cpu", **GEOM)
    rng = np.random.default_rng(2)
    written = {}
    for seq in (0, 2, 1):
        kv.start_sequence(seq)
        kv.ensure_capacity(seq, 12)
        kv.advance(seq, 12)
        for k in range(3):
            slab = rng.standard_normal((2, 4, 2, 2, 4)).astype(np.float32)
            kv.write_page(seq, k, slab)
            written[(seq, k)] = slab
    assert kv.stats["offloads"] > 0
    offloaded = kv.read_page(0, 0)          # from the host store
    kv.finish_sequence(2)
    table = kv.block_table(0, 3)            # restores seq 0
    assert kv.stats["fetches"] > 0
    assert len(set(table.tolist())) == 3
    for k in range(3):
        assert kv.read_page(0, k).tobytes() == written[(0, k)].tobytes()
        assert torch.equal(kv.kv[:, table[k]],
                           torch.from_numpy(written[(0, k)]))
    assert offloaded.tobytes() == written[(0, 0)].tobytes()


def test_write_page_takes_tensors_and_numpy_alike():
    a = PagedKVCache(hbm_pages=2, device="cpu", **GEOM)
    b = PagedKVCache(hbm_pages=2, device="cpu", **GEOM)
    slab = np.random.default_rng(4).standard_normal((2, 4, 2, 2, 4))
    for c, s in ((a, slab), (b, torch.from_numpy(slab))):
        c.start_sequence(0)
        c.ensure_capacity(0, 4)
        c.write_page(0, 0, s)
    assert a.read_page(0, 0).tobytes() == b.read_page(0, 0).tobytes()
    assert a.read_page(0, 0).dtype == np.float32
    # the host copy is not a view of the pool
    got = a.read_page(0, 0)
    a.kv.zero_()
    assert got.tobytes() == b.read_page(0, 0).tobytes()


def test_exhausted_pool_raises_like_the_reference():
    for cache, err in ((JaxPagedKVCache(hbm_pages=0, **GEOM),
                        JaxHBMExhaustedError),
                       (PagedKVCache(hbm_pages=0, device="cpu", **GEOM),
                        HBMExhaustedError)):
        cache.start_sequence(0)
        with pytest.raises(err):
            cache.ensure_capacity(0, 1)
