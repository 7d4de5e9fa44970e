"""``examples/torch_quickstart.py`` against ``examples/quickstart.py``, both
loaded by path, the port's ``run_training`` started from the reference's
initial params (its init from seed 0, bridged). Each pair runs once for
the module at fp32 compute, as ``tests/test_torch_train.py``'s
run_training parity runs, and once as shipped (bf16 compute):

- the losses of the 10 steps within that test's 1e-4 at fp32, within the
  repo's bf16 tolerance (2e-2) as shipped;
- the params restored from the checkpoint bit-identical to the ones the
  last step saved, each in its own dtype;
- at fp32 the same greedy token ids (in bf16 a near tie can flip a greedy
  token between the two packages' sums)."""
import ast
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_examples import load, run_jax, run_port
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import _flatten

torch.set_num_threads(2)

LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _recording(fn, key, into, **extra):
    def wrapped(*args, **kwargs):
        into[key] = fn(*args, **extra, **kwargs)
        return into[key]
    return wrapped


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request):
    jx, pt = load("quickstart"), load("torch_quickstart")
    if request.param == "float32":
        for mod in (jx, pt):
            mod.smoke_config = functools.partial(
                lambda arch, smoke: smoke(arch).with_(
                    compute_dtype="float32"), smoke=mod.smoke_config)
    ref, port = {}, {}
    jx.run_training = _recording(jx.run_training, "train", ref)
    ref["lines"] = run_jax(jx)
    jp = jax_build_model(jx.smoke_config("qwen3-0.6b")).init(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    pt.run_training = _recording(pt.run_training, "train", port,
                                 params=params)
    pt.restore_params = _recording(pt.restore_params, "restored", port)
    port["res"], port["lines"] = run_port(pt)
    port["compute"] = request.param
    return ref, port


def test_losses_follow_the_reference(runs):
    ref, port = runs
    res = port["res"]
    assert res["steps"] == ref["train"].steps == 10
    assert res["losses"] == port["train"].losses
    tol = LOSS_TOL[port["compute"]]
    np.testing.assert_allclose(res["losses"], ref["train"].losses, rtol=tol,
                               atol=tol)


def test_restored_params_are_the_saved_ones(runs):
    _, port = runs
    params, step = port["restored"]
    assert step == port["res"]["restored_step"] == 10
    saved = _flatten(port["train"].state.params)
    got = _flatten(params)
    assert sorted(got) == sorted(saved)
    assert all(got[k].dtype == saved[k].dtype
               and got[k].tobytes() == saved[k].tobytes() for k in saved)


def test_generated_tokens_equal_the_reference(runs):
    ref, port = runs
    want = ast.literal_eval(ref["lines"][-1].split(":", 1)[1].strip())
    assert len(want) == len(port["res"]["generated"]) == 5
    if port["compute"] == "float32":
        assert port["res"]["generated"] == want
    assert port["lines"][0] == ref["lines"][0]
    assert port["lines"][-2] == "restored checkpoint at step 10"
    assert port["lines"][-1] == \
        f"generated token ids: {port['res']['generated']}"
