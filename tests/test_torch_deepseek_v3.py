"""DeepSeek-V3 on the port (smoke size, CPU, seeded random weights) held
to the plain float32 model of ``tests/plain_deepseek_v3.py``: the loss
and every leaf's gradient through ``LM`` with remat on and off, the
grouped sigmoid router against an enumeration of the groups, YaRN against
its closed form, the expert share against the uncut layer, the selection
bias's update, the share's counters, the wrong variants the comparison
has to catch, and the benchmark's reference against the tests'.

Tolerances. Both sides compute in float32 (the port at
``compute_dtype="float32"``), in other orders of the same sums: values
agree to ~1e-6 relative, gradients to ~1e-5 (a sum over T tokens and K
pairs in another order), so the comparisons hold them to 1e-4 and 1e-3.
Each wrong variant moves the compared numbers by more than 1e-2.
"""
from __future__ import annotations

import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_deepseek_v3 as plain
from repro_torch import trace
from repro_torch.configs import (ARCH_IDS, PORT_ONLY_ARCH_IDS, get_config,
                                 smoke_config)
from repro_torch.models import blocks
from repro_torch.models.common import (apply_rope, rope_freqs, yarn_freqs,
                                       yarn_mscale, yarn_range)
from repro_torch.models.model import build_model
from repro_torch.optim import make_train_state, make_train_step

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
ROOT = Path(__file__).resolve().parents[1]
VALUE_TOL = 1e-4     # fp32 on both sides, other summation orders
GRAD_TOL = 1e-3
WRONG = 1e-2         # what each wrong variant moves at the least


def cfg32(**kw):
    return smoke_config(ARCH).with_(compute_dtype="float32", **kw)


def model_and_params(cfg, seed=0, bias_scale=0.05):
    """The model, its params and its state, the biases drawn at
    ``bias_scale``."""
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(seed))
    st = m.init_state()
    g = torch.Generator().manual_seed(seed + 1)
    st["router_bias"].copy_(bias_scale * torch.randn(
        st["router_bias"].shape, generator=g))
    return m, p, st


def batch_of(cfg, B=2, T=16, seed=3):
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)))
    labels = torch.cat([toks[:, 1:], torch.full((B, 1), -100)], 1)
    return {"tokens": toks, "labels": labels}


def leaves_of(tree, out=None):
    out = [] if out is None else out
    for v in tree.values():
        leaves_of(v, out) if isinstance(v, dict) else out.append(v)
    return out


def grads(fn, params):
    ps = [t.detach().clone().requires_grad_(True) for t in leaves_of(params)]
    it = iter(ps)
    tree = _rebuild(params, it)
    loss = fn(tree)
    return loss.detach(), torch.autograd.grad(loss, ps)


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


# ------------------------------------------------------------ the config --
def test_v3_is_the_ports_own():
    assert ARCH in PORT_ONLY_ARCH_IDS and ARCH not in ARCH_IDS
    cfg = get_config(ARCH)
    assert (cfg.n_experts, cfg.top_k, cfg.n_group, cfg.topk_group) == \
        (256, 8, 8, 4)
    assert (cfg.q_lora, cfg.kv_lora, cfg.first_dense, cfg.d_ff) == \
        (1536, 512, 3, 18432)
    s = smoke_config(ARCH)
    assert s.n_group > s.topk_group > 1 and s.n_experts > s.held
    assert s.yarn_factor > 1 and s.yarn_original < 128
    # the mirrored configs read the port-only defaults
    v2 = get_config("deepseek-v2-lite-16b")
    assert (v2.first_dense, v2.scoring, v2.yarn_factor, v2.held) == \
        (0, "softmax", 1.0, 64)


# ------------------------------------------------- loss and gradients --
@pytest.mark.parametrize("remat", ["none", "layer"])
def test_loss_and_gradients_follow_the_plain_model(remat):
    """Loss and every leaf's gradient, experts dropping pairs (capacity
    0.5), a nonzero bias, and the balance loss at alpha 0.1 so that its
    gradient shows."""
    cfg = cfg32(remat=remat, capacity_factor=0.5, balance_alpha=0.1)
    m, params, st = model_and_params(cfg)
    c = plain.config_of(cfg)
    b = batch_of(cfg)
    bias = st["router_bias"].clone()
    with plain.fp32():
        lp, gp = grads(lambda t: m.loss(t, b, st), params)
        lr, gr = grads(lambda t: plain.loss(t, c, b["tokens"], b["labels"],
                                            bias)[0], params)
    torch.testing.assert_close(lp, lr, rtol=VALUE_TOL, atol=VALUE_TOL)
    assert len(gp) == len(gr) == len(leaves_of(params))
    for a, r in zip(gp, gr):
        torch.testing.assert_close(a, r, rtol=GRAD_TOL, atol=GRAD_TOL * 1e-2)


def test_the_leaves_are_the_references():
    """The port's ``init`` and the benchmark reference's ``leaves`` name
    the same leaves with the same shapes."""
    from perfbench import harness
    ref = harness.load_module(ROOT / "perfbench" / "reference"
                              / "deepseek_v3.py", "ds3")
    cfg = smoke_config(ARCH)
    conf = dict(plain.config_of(cfg), num_experts_per_tok=cfg.top_k,
                init_depth=61)
    _, params, _ = model_and_params(cfg)

    def paths(tree, pre=()):
        for k, v in tree.items():
            yield from (paths(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), tuple(v.shape))])
    assert sorted(paths(params)) == sorted(
        (p, s) for p, s, _ in ref.leaves(conf))


# ---------------------------------------------------------------- router --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_against_enumerating_the_groups(seed):
    """For each token, every choice of ``topk_group`` groups is tried: the
    one whose group scores sum highest, then the top K experts in it."""
    cfg = smoke_config(ARCH)
    g = torch.Generator().manual_seed(seed)
    E, G, K = cfg.n_experts, cfg.n_group, cfg.top_k
    h = torch.randn(2, 8, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, E, generator=g) * cfg.d_model ** -0.5
    bias = 0.1 * torch.randn(E, generator=g)
    s, gates, eid = blocks.moe_route_grouped(w, h, cfg, bias)
    s_want = torch.sigmoid(h @ w)
    torch.testing.assert_close(s, s_want, rtol=1e-6, atol=1e-6)
    for b, t in itertools.product(range(2), range(8)):
        sel = (s_want[b, t] + bias).tolist()
        per = E // G
        score = [sum(sorted(sel[i * per:(i + 1) * per])[-2:])
                 for i in range(G)]
        best = max(itertools.combinations(range(G), cfg.topk_group),
                   key=lambda gs: sum(score[i] for i in gs))
        cand = [e for i in best for e in range(i * per, (i + 1) * per)]
        want = sorted(cand, key=lambda e: -sel[e])[:K]
        assert sorted(eid[b, t].tolist()) == sorted(want)
        chosen = s_want[b, t, eid[b, t]]
        torch.testing.assert_close(
            gates[b, t], chosen / chosen.sum() * cfg.routed_scaling,
            rtol=1e-6, atol=1e-6)


def test_balance_loss_by_hand():
    s = torch.tensor([[[0.5, 0.25, 0.25, 0.0], [0.2, 0.2, 0.2, 0.4]]])
    ids = torch.tensor([[[0, 1], [3, 0]]])
    # f = E / (K T) counts = 4 / 4 * [2, 1, 0, 1]; P = mean of s / sum s
    P = torch.tensor([0.35, 0.225, 0.225, 0.2])
    want = (torch.tensor([2.0, 1.0, 0.0, 1.0]) * P).sum()
    torch.testing.assert_close(blocks.balance_loss(s, ids, 4), want)
    torch.testing.assert_close(plain.balance(s, ids, 4), want)


# ------------------------------------------------------------------ YaRN --
def test_yarn_at_v3s_numbers():
    cfg = get_config(ARCH)
    assert yarn_range(64, 1e4, 4096, 32, 1) == (10, 23)
    assert blocks.mla_scale(cfg) == pytest.approx(192 ** -0.5 * 1.87385,
                                                  rel=1e-5)
    assert blocks.mla_scale(cfg) == pytest.approx(0.135234, abs=5e-7)
    assert yarn_mscale(40, 1) / yarn_mscale(40, 1) == 1.0
    f = yarn_freqs(64, 1e4, 40.0, 4096, 32, 1)
    base = rope_freqs(64, 1e4)
    torch.testing.assert_close(f[:11], base[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(f[23:], base[23:] / 40, rtol=1e-6, atol=0)
    r = (torch.arange(11, 23).float() - 10) / 13
    torch.testing.assert_close(f[11:23], base[11:23] / 40 * r
                               + base[11:23] * (1 - r), rtol=1e-5, atol=0)
    c = plain.config_of(cfg)
    assert plain.ramp(c) == (10, 23)
    torch.testing.assert_close(f, plain.inv_freq(c).float(), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_yarn_at_factor_one_or_less_is_plain_rope_bit_for_bit(factor):
    cfg = smoke_config(ARCH).with_(yarn_factor=factor)
    x = torch.randn(2, 9, 3, cfg.qk_rope_dim, dtype=torch.bfloat16)
    pos = torch.arange(9)
    assert torch.equal(blocks.mla_rope(cfg, x, pos),
                       apply_rope(x, pos, cfg.rope_theta))
    assert blocks.mla_scale(cfg) is None


def test_yarn_mscale_on_cos_and_sin():
    cfg = smoke_config(ARCH).with_(yarn_mscale=0.707, yarn_mscale_all_dim=1.0)
    c = plain.config_of(cfg)
    x = torch.randn(1, 12, 2, cfg.qk_rope_dim)
    want = plain.rope(x, c)
    torch.testing.assert_close(blocks.mla_rope(cfg, x, torch.arange(12)),
                               want, rtol=1e-5, atol=1e-6)
    m = yarn_mscale(4.0, 0.707) / yarn_mscale(4.0, 1.0)
    assert m < 1 and plain.rope_factors(c)[0] == pytest.approx(m)


# ------------------------------------------------------------- the share --
def test_the_shares_add_up_to_the_uncut_layer():
    """Each of the E / held shares computes its experts' part of one
    expert layer; with the shared expert counted once they sum to the
    uncut plain layer, dropped pairs and all."""
    cfg = cfg32(capacity_factor=0.5)
    _, params, st = model_and_params(cfg)
    p = plain.layer(params["layers"], 0)["moe"]
    bias = st["router_bias"][0]
    E, held = cfg.n_experts, cfg.held
    full = dict(p, **{k: torch.cat([p[k]] * (E // held)) for k in
                      ("w1", "w3", "w2")})
    # the uncut layer: E experts, share 0 of them E wide; w_j of expert j
    rng = torch.Generator().manual_seed(9)
    for k in ("w1", "w3", "w2"):
        full[k] = full[k] + 0.1 * torch.randn(full[k].shape, generator=rng)
    c = plain.config_of(cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=rng)
    want, _, _ = plain.moe(full, x, c, bias, first=0, held=E)
    h = plain.rms(x, p["norm"])
    sp = p["shared"]
    shared = plain.swiglu(h, sp["w1"], sp["w3"], sp["w2"])
    total = torch.zeros_like(x)
    for s in range(E // held):
        part = dict(full, **{k: full[k][s * held:(s + 1) * held]
                             for k in ("w1", "w3", "w2")})
        out, _ = blocks.moe_apply_grouped(
            part, x, cfg=cfg.with_(first_held=s * held), bias=bias)
        total = total + (out - x)
    got = x + total - (E // held - 1) * shared
    torch.testing.assert_close(got, want, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_a_share_holds_only_its_experts_buffers(monkeypatch):
    cfg = cfg32()
    _, params, st = model_and_params(cfg)
    seen = []
    dispatch = blocks.dispatch

    def spy(x, eid, slot, R, C, **kw):
        seen.append((R, C, x.shape[0]))
        return dispatch(x, eid, slot, R, C, **kw)
    monkeypatch.setattr(blocks, "dispatch", spy)
    x = torch.randn(3, 16, cfg.d_model)
    blocks.moe_apply_grouped(plain.layer(params["layers"], 0)["moe"], x,
                             cfg=cfg, bias=st["router_bias"][0])
    C = blocks._capacity(cfg, 16)
    assert seen == [(3 * cfg.held, C, 3 * 16)]


# -------------------------------------------------------------- the bias --
def test_one_bias_update_a_step_by_the_sign_rule():
    """Two steps under remat: each step's forward counts its selections
    once (the recompute reads the same bias and counts nothing), and the
    bias then moves by gamma sign(mean load - load)."""
    cfg = cfg32(remat="layer", bias_speed=0.01)
    m, params, _ = model_and_params(cfg)
    c = plain.config_of(cfg)
    # a wrapped loss, and a state the first step starts
    step = make_train_step(lambda p, b: m.loss(p, b), lr=1e-2)
    state = make_train_state(params)
    assert state.model_state is None
    bias = torch.zeros(cfg.bias_layers, cfg.n_experts)
    for i in range(2):
        b = batch_of(cfg, seed=10 + i)
        tree = _rebuild(state.params,
                        iter([t.clone() for t in leaves_of(state.params)]))
        with torch.no_grad():
            _, loads = plain.loss(tree, c, b["tokens"], b["labels"], bias)
        if i:
            assert torch.equal(state.model_state["router_bias"], bias)
        state, _ = step(state, b)
        bias = plain.bias_step(bias, loads, cfg.bias_speed)
        torch.testing.assert_close(state.model_state["router_bias"], bias,
                                   rtol=0, atol=1e-7)
        assert not state.model_state["router_loads"].any()
    assert bias.abs().max() > 0


def test_a_forward_without_its_state_raises():
    """Outside a train step a forward must be given the biases: none is
    made up for it."""
    cfg = cfg32()
    m, params, _ = model_and_params(cfg)
    with pytest.raises(ValueError, match="model state"):
        m.loss(params, batch_of(cfg))


def test_a_recompute_counts_nothing():
    cfg = cfg32(remat="layer")
    m, params, st = model_and_params(cfg)
    c = plain.config_of(cfg)
    b = batch_of(cfg)
    with torch.no_grad():
        _, want = plain.loss(params, c, b["tokens"], b["labels"],
                             st["router_bias"].clone())
    ps = [t.requires_grad_(True) for t in leaves_of(params)]
    loss = m.loss(params, b, st)
    assert torch.equal(st["router_loads"], want)
    torch.autograd.grad(loss, ps)
    assert torch.equal(st["router_loads"], want)


def test_a_restart_from_a_checkpoint_goes_on_as_one_run(tmp_path):
    """A run that checkpoints at step 2 and crashes there, then a run that
    restores and goes on to step 4, against one uninterrupted run: the
    same losses and the same final state, the biases and loads included,
    bit for bit. One batch of tokens serves every step, since a restart
    reads the feed from its start; gamma 0.05, so that the biases move
    the selections."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.train import SimulatedFailure, run_training
    cfg = cfg32(bias_speed=0.05)
    kw = dict(steps=4, batch_size=2, seq_len=16, num_sequences=2, lr=1e-2,
              log_every=100, device="cpu")
    whole = run_training(cfg, **kw)
    with pytest.raises(SimulatedFailure):
        run_training(cfg, ckpt_dir=str(tmp_path), ckpt_every=2,
                     fail_at_step=2, **kw)
    rest = run_training(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert rest.restored_from == 2 and rest.steps == 4
    assert rest.losses == whole.losses[2:]
    a, b = _flatten(whole.state), _flatten(rest.state)
    assert {"model_state/router_bias", "model_state/router_loads"} <= set(a)
    assert np.abs(a["model_state/router_bias"]).max() > 0.05
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.cuda
def test_a_train_step_on_the_card_syncs_with_no_host():
    """One step on the card at the smoke size, bf16, remat on, under
    ``torch.cuda.set_sync_debug_mode("error")``: the router, the loads,
    the counters and the bias update read nothing back to the host (the
    first step, which builds the kernels, runs outside it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cfg = smoke_config(ARCH).with_(remat="layer")
    m = build_model(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    state = make_train_state(params, cfg.opt_state_dtype, m.init_state())
    step = make_train_step(m.loss, lr=1e-2)
    b = {k: v.cuda() for k, v in batch_of(cfg, B=2, T=64).items()}
    state, _ = step(state, b)
    torch.cuda.synchronize()
    trace.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.model_state["router_bias"].abs().max() > 0
    assert trace.counters()["moe.pairs_held"] > 0


# ---------------------------------------------------------- the counters --
def test_counters_against_a_hand_count():
    cfg = cfg32(capacity_factor=0.5, remat="layer")
    m, params, st = model_and_params(cfg)
    b = batch_of(cfg, B=3)
    trace.reset_counters()
    ps = [t.requires_grad_(True) for t in leaves_of(params)]
    torch.autograd.grad(m.loss(params, b, st), ps)    # recompute included
    got = trace.counters()
    c = plain.config_of(cfg)
    held = kept = ratio = layers = 0.0
    x = params["embed"].detach()[b["tokens"]]
    for i in range(cfg.n_layers):
        dense = i < cfg.first_dense
        p = plain.layer(params["dense_layers" if dense else "layers"],
                        i if dense else i - cfg.first_dense)
        with torch.no_grad():
            x = plain.attention(p["attn"], x, c)
            if dense:
                f = p["ffn"]
                x = x + plain.swiglu(plain.rms(x, f["norm"]), f["w1"],
                                     f["w3"], f["w2"])
                continue
            h = plain.rms(x, p["moe"]["norm"])
            _, _, ids = plain.route(p["moe"], h, c,
                                    st["router_bias"][i - cfg.first_dense])
            x = plain.moe(p["moe"], x, c,
                          st["router_bias"][i - cfg.first_dense])[0]
        C = plain.capacity(c, ids.shape[1])
        loads = [0] * cfg.held
        for row in ids:
            seen = {}
            for e in row.reshape(-1).tolist():
                n = seen.get(e, 0)
                seen[e] = n + 1
                if cfg.first_held <= e < cfg.first_held + cfg.held:
                    held += 1
                    loads[e - cfg.first_held] += 1
                    kept += n < C
        if sum(loads):
            ratio += max(loads) / (sum(loads) / len(loads))
            layers += 1
    assert got["moe.pairs_held"] == held
    assert got["moe.pairs_kept"] == kept < held
    assert got["moe.load_ratio_n"] == layers == cfg.n_layers - 1
    assert got["moe.load_ratio_sum"] == pytest.approx(ratio, rel=1e-6)
    # a layer whose held experts got no pair adds no ratio
    lid = torch.zeros(2, 3, 4, dtype=torch.long)
    blocks.count_share(lid == 1, torch.full_like(lid, 8), lid, cfg.held, 8)
    after = trace.counters()
    assert after == dict(got, **{"moe.load_ratio_n": layers})


# ------------------------------------------------------ the wrong variants --
@pytest.mark.parametrize("wrong", ["plain_rope", "no_group_limit",
                                   "softmax_scores", "zero_bias"])
def test_each_wrong_variant_fails_the_comparison(wrong):
    cfg = cfg32()
    m, params, st = model_and_params(cfg, bias_scale=0.2)
    c = plain.config_of(cfg)
    b = batch_of(cfg)
    bias = st["router_bias"].clone()
    kw = {}
    if wrong == "plain_rope":
        c["rope_scaling"] = dict(c["rope_scaling"], factor=1.0)
    elif wrong == "no_group_limit":
        kw["group_limit"] = False
    elif wrong == "softmax_scores":
        kw["scoring"] = "softmax"
    else:
        bias = torch.zeros_like(bias)
    with torch.no_grad():
        port, _ = m.forward(params, b, st)
        right, _, _ = plain.forward(params, plain.config_of(cfg),
                                    b["tokens"], st["router_bias"])
        other, _, _ = plain.forward(params, c, b["tokens"], bias, **kw)
    torch.testing.assert_close(port, right, rtol=VALUE_TOL, atol=VALUE_TOL)
    assert (port - other).abs().max() > WRONG


# ------------------------------------------- the benchmark's reference --
def small_conf(**over):
    import json
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / "deepseek-v3-671b-l5e8.json").read_text())
    conf.update(hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
                num_attention_heads=4, vocab_size=256, q_lora_rank=24,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                v_head_dim=16, intermediate_size=128,
                moe_intermediate_size=32, router_outputs=16,
                n_routed_experts=4, first_held_expert=4,
                num_experts_per_tok=4, n_group=4, topk_group=2,
                rope_scaling=dict(conf["rope_scaling"], factor=4,
                                  original_max_position_embeddings=64),
                **over)
    return conf


@pytest.mark.parametrize("remat", [False, True])
def test_the_benchmark_reference_agrees_with_the_tests(remat):
    from perfbench import harness, weights
    ref = harness.load_module(ROOT / "perfbench" / "reference"
                              / "deepseek_v3.py", "ds3")
    conf = small_conf(capacity_factor=0.5, balance_loss_alpha=0.1)
    leaves = ref.leaves(conf)
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 20)))
    labels = torch.cat([toks[:, 1:], torch.full((2, 1), -100)], 1)
    p1 = weights.make(leaves, 5, torch.float32, "cpu")
    bias0 = ref.router_bias(p1, conf).clone()
    l1 = ref.loss(p1, conf, toks, ref.Numerics("fp32"), remat=remat)
    p2 = weights.make(leaves, 5, torch.float32, "cpu")
    l2, loads = plain.loss(p2, conf, toks, labels, bias0)
    torch.testing.assert_close(l1, l2, rtol=VALUE_TOL, atol=VALUE_TOL)
    torch.testing.assert_close(p1["router_bias"], plain.bias_step(
        bias0, loads, conf["bias_update_speed"]), rtol=0, atol=1e-7)
    assert p1["router_bias"].abs().max() > 0


def test_the_configuration_file_is_what_the_port_runs():
    import json

    from perfbench.runners import port_config
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / "deepseek-v3-671b-l5e8.json").read_text())
    cfg = port_config(conf)
    rs = conf["rope_scaling"]
    assert (cfg.yarn_factor, cfg.yarn_original, cfg.yarn_beta_fast,
            cfg.yarn_beta_slow, cfg.yarn_mscale, cfg.yarn_mscale_all_dim) \
        == (rs["factor"], rs["original_max_position_embeddings"],
            rs["beta_fast"], rs["beta_slow"], rs["mscale"],
            rs["mscale_all_dim"])
    assert cfg.opt_state_dtype == conf["precision"]["optimizer_state"]
    assert cfg.compute_dtype == conf["precision"]["compute"]
    assert cfg.remat == "layer"
    from perfbench import harness
    ref = harness.load_module(ROOT / "perfbench" / "reference"
                              / "deepseek_v3.py", "ds3")
    count = lambda norms: sum(math.prod(s) for _, s, scale in ref.leaves(conf)
                              if (scale is None) == norms)
    assert (count(False), count(True)) == (3_156_344_832, 89_088)
