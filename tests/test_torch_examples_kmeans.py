"""``examples/torch_kmeans_pangea.py`` (k-means over the port's buffer pool,
computing with torch) against ``examples/kmeans_pangea.py`` (the JAX
package's, jitted on the CPU), both loaded by path.

- One ``assign_update`` step from the same points, norms and centroids:
  the assignments equal and the centroids within 3e-5 (the JAX package's
  fp32 tolerance), after an fp64 check that no point of the seed lies
  within 1e-5 of a tie between two centroids.
- The whole example at 20 000 points, each iteration fed the centroids the
  reference's iteration started from: the same cluster sizes, and the same
  printed lines with the seconds masked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_examples import load, masked, run_jax, run_port

torch.set_num_threads(2)

TOL = 3e-5
TIE_GAP = 1e-5
SECONDS = r"\d+\.\d+s\b"


def _inputs(case, n=20_000, dim=10, k=8):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, dim)).astype(np.float32)
    norms = (pts ** 2).sum(1)              # as the examples' norms set
    if case == "first_points":
        cents = pts[:k].copy()
    else:                                  # one centroid no point is near
        cents = rng.normal(size=(k, dim)).astype(np.float32)
        cents[3] = 100.0
    return pts, norms, cents


@pytest.mark.parametrize("case", ["first_points", "one_empty"])
def test_assign_update_matches_the_reference(case):
    pts, norms, cents = _inputs(case)
    d = ((pts.astype(np.float64)[:, None, :]
          - cents.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > TIE_GAP
    jx, pt = load("kmeans_pangea"), load("torch_kmeans_pangea")
    want_c, want_a = jx.assign_update(jnp.asarray(pts), jnp.asarray(norms),
                                      jnp.asarray(cents))
    got_c, got_a = pt.assign_update(torch.from_numpy(pts),
                                    torch.from_numpy(norms),
                                    torch.from_numpy(cents))
    assert got_a.dtype == torch.int64 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=TOL, atol=TOL)
    if case == "one_empty":
        assert not (got_a.numpy() == 3).any()
        assert (got_c[3] == 0).all()


def test_example_gives_the_reference_cluster_sizes():
    jx, pt = load("kmeans_pangea"), load("torch_kmeans_pangea")
    fed = []
    jax_update = jx.assign_update

    def record(points, norms, centroids):
        fed.append(np.asarray(centroids))
        return jax_update(points, norms, centroids)

    jx.assign_update = record
    want = run_jax(jx, "--points", "20000")
    calls = iter(fed)
    port_update = pt.assign_update

    def feed(points, norms, centroids):
        ref = torch.from_numpy(np.array(next(calls)))
        # the port's own centroids follow the reference's up to rounding
        assert torch.allclose(centroids, ref, rtol=TOL, atol=TOL)
        return port_update(points, norms, ref)

    pt.assign_update = feed
    res, lines = run_port(pt, "--points", "20000")
    assert len(fed) == 5 and next(calls, None) is None
    assert masked(lines, SECONDS) == masked(want, SECONDS)
    sizes = want[-1].split("[")[1].rstrip("]").split()
    assert res["cluster_sizes"] == [int(s) for s in sizes]
    assert sum(res["cluster_sizes"]) == res["points"] == 20000
    assert len(res["iters"]) == 5
    assert all(it["scan_s"] <= it["seconds"] for it in res["iters"])
    assert np.asarray(res["centroids"]).shape == (8, 10)


def test_example_scans_a_spilled_pool():
    """At 4 MB of points through a 2 MB pool the pool spills, and each
    iteration's scan still hands ``assign_update`` every point and norm in
    order; fed the centroids of the JAX ``assign_update`` iterated over the
    same arrays held in memory, the port gives its cluster sizes. (The JAX
    example itself is not the oracle here: on the CPU ``jnp.asarray`` of a
    64-byte-aligned page view aliases the page, so once the pool reuses
    pages its points are overwritten; ROADMAP queue 3, quirk 14.)"""
    n, iters = 100_000, 2
    pts, norms, _ = _inputs("first_points", n=n)
    jx, pt = load("kmeans_pangea"), load("torch_kmeans_pangea")
    cents, fed = jnp.asarray(pts[:8]), []
    for _ in range(iters):
        fed.append(np.array(cents))
        cents, assign = jx.assign_update(jnp.asarray(pts), jnp.asarray(norms),
                                         cents)
    calls = iter(fed)
    port_update = pt.assign_update

    def feed(points, norms_t, centroids):
        assert np.array_equal(points.numpy(), pts)
        assert np.array_equal(norms_t.numpy(), norms)
        return port_update(points, norms_t, torch.from_numpy(next(calls)))

    pt.assign_update = feed
    res, _ = run_port(pt, "--points", str(n), "--pool-mb", "2",
                      "--iters", str(iters))
    assert next(calls, None) is None
    assert all(it["spilled_mb"] > 2 for it in res["iters"])
    assert res["cluster_sizes"] == np.bincount(np.asarray(assign),
                                               minlength=8).tolist()
