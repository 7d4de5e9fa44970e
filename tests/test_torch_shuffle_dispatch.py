"""The port's MoE shuffle dispatch/combine against the JAX package's.

On the CPU the port's ``impl="kernel"`` takes its plain version (the dense
one-hot oracle); the JAX kernels run as the JAX package's own tests run them
(Pallas ``interpret=True``), beside the JAX oracle. Inputs come from one
numpy seed and go through both packages. Tolerances are the reference's MoE
tolerance, 1e-5, in fp32 and its bf16 tolerance, 2e-2, in bf16. The CUDA
kernels themselves are tested on the card by tests/test_torch_cuda.py,
which imports no jax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.shuffle_dispatch.ops import combine as jax_combine
from repro.kernels.shuffle_dispatch.ops import compute_slots as jax_slots
from repro.kernels.shuffle_dispatch.ops import dispatch as jax_dispatch
from repro.kernels.shuffle_dispatch.ops import \
    host_dispatch_plan as jax_host_plan
from repro.kernels.shuffle_dispatch.ref import combine_ref as jax_combine_ref
from repro.kernels.shuffle_dispatch.ref import dispatch_ref as jax_dispatch_ref
from repro_torch.kernels.shuffle_dispatch import kernel as shuffle_kernel
from repro_torch.kernels.shuffle_dispatch.ops import (combine, compute_slots,
                                                      dispatch,
                                                      host_dispatch_plan)
from test_torch_cuda import (OVERFLOW_CASES, SHUFFLE_CASES, SHUFFLE_KINDS,
                             SHUFFLE_TOL, shuffle_inputs)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference's cases and the odd width; the served shapes run on the card
CPU_CASES = [c for c in SHUFFLE_CASES if c[1] < 1024]


def _both(a, dtype_name):
    """The same values as a jnp array and a torch CPU tensor of one dtype."""
    jd, td = DTYPES[dtype_name]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, dtype_name, what):
    tol = SHUFFLE_TOL[dtype_name]
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
@pytest.mark.parametrize("case", CPU_CASES)
def test_dispatch_and_combine_match_jax(case, kind, dtype):
    """Every port path (the oracle, and "kernel" on CPU tensors) against the
    JAX oracle and the interpreted Pallas kernels: with capacity drops,
    dropped ids and slots, and repeated slots that sum."""
    T, D, E, K, C = case
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(T + D),
                                            T, D, E, K, C, kind)
    jx, tx = _both(x, dtype)
    jy, ty = _both(y, dtype)
    jg, tg = _both(gates, "float32")
    jeid, jslot = jnp.asarray(eid), jnp.asarray(slot)
    teid, tslot = torch.from_numpy(eid), torch.from_numpy(slot)
    refs = {"oracle": jax_dispatch_ref(jx, jeid, jslot, E, C),
            "pallas": jax_dispatch(jx, jeid, jslot, E, C, impl="kernel")}
    crefs = {"oracle": jax_combine_ref(jy, jeid, jslot, jg),
             "pallas": jax_combine(jy, jeid, jslot, jg, T, impl="kernel")}
    before = (dispatch.launches, combine.launches)
    for impl in ("xla", "kernel"):
        out = dispatch(tx, teid, tslot, E, C, impl=impl)
        cout = combine(ty, teid, tslot, tg, T, impl=impl)
        assert out.dtype == tx.dtype and tuple(out.shape) == (E, C, D)
        assert cout.dtype == ty.dtype and tuple(cout.shape) == (T, D)
        for name in refs:
            _close(out, refs[name], dtype, f"dispatch {impl} vs {name}")
            _close(cout, crefs[name], dtype, f"combine {impl} vs {name}")
    assert (dispatch.launches, combine.launches) == before   # CPU: plain


def test_repeated_slots_sum_and_drops_add_nothing():
    """Two pairs on one (e, c) add up; ids of -1 or E and slots of -1 or C
    are dropped; rows nobody lands on are zero."""
    x = torch.arange(1.0, 6.0)[:, None] * torch.ones(1, 3)       # rows 1..5
    eid = torch.tensor([[0], [0], [-1], [2], [1]], dtype=torch.int32)
    slot = torch.tensor([[1], [1], [0], [0], [2]], dtype=torch.int32)
    out = dispatch(x, eid, slot, 2, 2, impl="kernel")
    expect = torch.zeros(2, 2, 3)
    expect[0, 1] = 1.0 + 2.0
    assert torch.equal(out, expect)
    y = torch.arange(1.0, 5.0).reshape(2, 2, 1)
    gates = torch.tensor([[0.5], [2.0], [1.0], [1.0], [1.0]])
    back = combine(y, eid, slot, gates, 5, impl="kernel")
    assert back[:, 0].tolist() == [1.0, 4.0, 0.0, 0.0, 0.0]


def test_round_trip_is_the_identity():
    """Mirror of test_dispatch_combine_roundtrip_identity."""
    T, D, E, C = 32, 8, 4, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    eid = torch.from_numpy(rng.integers(0, E, size=(T, 1)))
    slot = compute_slots(eid, E, C)
    buf = dispatch(x, eid, slot, E, C, impl="kernel")
    back = combine(buf, eid, slot, torch.ones((T, 1)), T, impl="kernel")
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(64, 2, 4), (130, 6, 16), (7, 1, 3)])
def test_compute_slots_matches_jax(shape):
    T, K, E = shape
    rng = np.random.default_rng(T)
    eid = rng.integers(-1, E, size=(T, K)).astype(np.int32)   # -1: no expert
    ours = compute_slots(torch.from_numpy(eid), E, 8)
    ref = np.asarray(jax_slots(jnp.asarray(eid), E, 8))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), ref)
    assert (ours.numpy()[eid < 0] == -1).all()


def test_compute_slots_counts_each_leading_row_on_its_own():
    """A [B, T, K] batch of assignments gives each row the reference's
    slots of that row alone."""
    rng = np.random.default_rng(5)
    eid = rng.integers(-1, 6, size=(3, 40, 2)).astype(np.int32)
    ours = compute_slots(torch.from_numpy(eid), 6, 8)
    assert ours.shape == eid.shape and ours.dtype == torch.int32
    for b in range(3):
        assert np.array_equal(ours[b].numpy(),
                              np.asarray(jax_slots(jnp.asarray(eid[b]), 6, 8)))


def test_compute_slots_capacity_semantics():
    """Mirror of the reference's test of the same name."""
    eid = torch.tensor([[0], [0], [0], [1]], dtype=torch.int32)
    slot = compute_slots(eid, num_experts=2, capacity=2)
    assert slot[:, 0].tolist() == [0, 1, 2, 0]   # 2 >= C: dropped downstream


@pytest.mark.parametrize("n", [0, 1, 257])
def test_host_dispatch_plan_matches_jax(n):
    ids = np.random.default_rng(n).integers(0, 5, size=n)
    for ours, ref in zip(host_dispatch_plan(ids, 5), jax_host_plan(ids, 5)):
        assert ours.dtype == ref.dtype
        assert np.array_equal(ours, ref)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA launchers raise before any build: CPU data, fp16 data, ids
    that are not int32 [N, K], gates of another shape; and the public
    wrappers reject an unknown impl and a wrong num_tokens."""
    x = torch.zeros(4, 8)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        shuffle_kernel.dispatch_kernel(x, ids, ids, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        shuffle_kernel.combine_kernel(torch.zeros(2, 4, 8), ids, ids,
                                      torch.zeros(4, 2))
    cpu = torch.device("cpu")
    with pytest.raises(TypeError, match="int32"):
        shuffle_kernel.check_assignment("dispatch", cpu, ids.long(), ids)
    with pytest.raises(ValueError, match="N, K"):
        shuffle_kernel.check_assignment("combine", cpu, ids, ids,
                                        torch.zeros(4, 3))
    with pytest.raises(TypeError, match="gates"):
        shuffle_kernel.check_assignment("combine", cpu, ids, ids,
                                        torch.zeros(4, 2, dtype=torch.half))
    with pytest.raises(ValueError, match="contiguous"):
        shuffle_kernel.check_assignment("dispatch", cpu, ids,
                                        torch.zeros(2, 4, dtype=torch.int32).t())
    with pytest.raises(ValueError):
        dispatch(x, ids, ids, 2, 4, impl="pallas")
    with pytest.raises(ValueError, match="num_tokens"):
        combine(torch.zeros(2, 4, 8), ids, ids, torch.zeros(4, 2), 3)


@pytest.mark.parametrize("pairs,route", [
    (4 * 512 * 2, "walk"),       # grok-1-314b's served prefill
    (4 * 1 * 2, "direct"),       # and its decode step
    (0, "direct"), (1, "direct"),
    (shuffle_kernel.DIRECT_MAX_PAIRS, "direct"),     # the boundary
    (shuffle_kernel.DIRECT_MAX_PAIRS + 1, "walk"),
    (2 ** 31 - 1, "walk"),
])
def test_dispatch_route_at_the_served_shapes_and_the_boundary(pairs, route):
    """The wrapper picks dispatch's kernel from the number of pairs alone:
    a decode step's few pairs go straight to the rows, a prefill's through
    the walk."""
    assert shuffle_kernel.dispatch_route(pairs) == route
    assert route in shuffle_kernel.DISPATCH_ROUTES


def test_card_cases_reach_both_dispatch_routes():
    """The card tests' cases launch each route: the served decode and the
    round trip take ``direct``, the reference's cases, the served prefill
    and the hit-list overflows ``walk``."""
    routes = {shuffle_kernel.dispatch_route(T * K)
              for T, D, E, K, C in SHUFFLE_CASES}
    assert routes == set(shuffle_kernel.DISPATCH_ROUTES)
    assert {shuffle_kernel.dispatch_route(T * K)
            for _, T, D, E, K, C in OVERFLOW_CASES} == {"walk"}
    assert shuffle_kernel.dispatch_route(32 * 1) == "direct"    # round trip


def test_dispatch_on_cpu_counts_no_route():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch on any route."""
    x = torch.ones(4, 8)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    before = dict(dispatch.launches_by_route)
    dispatch(x, ids, ids, 2, 4, impl="kernel")
    assert dispatch.launches_by_route == before
