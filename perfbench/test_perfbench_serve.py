"""The serving cell on the CPU at a small size: the plain reference against
the port, a run and its check, the control, and faults planted in the
timed path.

The cell is held out of ``BENCHMARK.json``: ``ServeLoop`` pads a batch's
prompts at the end to the longest and answers each after its pad, which
the check, reading each request against its own prompt, fails (``PERF.md``
§7). With one client a batch is one request, served as it is, so the
tests of the harness's check run the port with one client; the witness
test runs the mix's own clients."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import calibrate, harness, smoke, tracing, weights
from perfbench.runners import port_config

torch.set_num_threads(2)

WORKLOAD = "dsv2l.serve.longdoc"
SEED = 2 ** 31 + 77


def test_reference_follows_the_port_through_prefill_and_decode():
    """At fp32 the reference's logits are the port's, through a prefill
    whose experts drop pairs (capacity 4 at T = 12) and three decode
    steps of one token each."""
    cell = smoke.small_cell(WORKLOAD, capacity_factor=0.5)
    cell.conf["program"]["set"].update(compute_dtype="float32",
                                      kv_cache_dtype="float32",
                                      capacity_factor=0.5)
    cfg = port_config(cell.conf)
    ref = cell.reference
    from repro_torch.models.model import build_model
    model = build_model(cfg, device="cpu")
    params = weights.make(ref.leaves(cell.conf), 5, torch.float32, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (3, 15)))
    plen = 12
    logits, cache = model.prefill(params, {"tokens": toks[:, :plen]},
                                  max_len=15)
    got = [logits[:, plen - 1]]
    for t in range(plen, 15):
        lg, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                      cache, t)
        got.append(lg[:, 0])
    got = torch.stack(got, 1)
    want, = ref.served_logits(params, cell.conf,
                              [(toks, plen, list(range(plen - 1, 15)))],
                              ref.Numerics("fp32"))
    assert ref.capacity(cell.conf, plen) == 4
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def one_client(**conf_over):
    cell = smoke.small_cell(WORKLOAD, **conf_over)
    cell.mix["clients"] = 1
    return cell


def run_small(cell, seconds=1.0):
    return harness.execute(cell, SEED, seconds, trace=False, device="cpu")


def test_a_run_is_correct():
    cell = one_client()
    result = run_small(cell)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"ttft_p95_ms", "serve_tok_s",
                                      "setup_s"}
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(cell.limits) == {"mean_gap"}


def test_the_control_is_not_correct():
    """The reference in float8, put in the port's place, reads a mean gap
    over three times the port's on every seed, and the harness judges the
    port correct and the control not against this size's limit, placed
    between the two readings as a cell's is (``smoke.HELD_LIMITS``). The
    readings grow with width and depth, so this size's limit is its own."""
    cell = one_client()
    rs = [calibrate.serve_readings(cell, seed, 2.0, True, "cpu")
          for seed in (1, 2, 3)]
    lower = max(r["mean_gap"] for r in rs)
    upper = min(r["control.mean_gap"] for r in rs)
    assert upper > 3 * lower, rs
    assert all(r["correct"] and not r["control.correct"] for r in rs), rs


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from repro_torch.models.lm import LM
    decode = LM.decode_step

    def altered(self, *a, **kw):
        logits, cache = decode(self, *a, **kw)
        return logits.roll(1, dims=-1), cache
    monkeypatch.setattr(LM, "decode_step", altered)
    result = run_small(one_client())
    assert not result["correct"]
    assert result["check"]["mean_gap"]["value"] > \
        result["check"]["mean_gap"]["limit"]


def test_a_prompt_answered_after_padding_fails(monkeypatch):
    """The loop's own fault at 8 clients, planted with one: the prompt is
    padded with zeros at the end, and the answer read after the pad."""
    from repro_torch.models.lm import LM
    prefill = LM.prefill

    def padded(self, params, batch, **kw):
        toks = batch["tokens"]
        pad = toks.new_zeros((toks.shape[0], 5))
        logits, cache = prefill(self, params,
                                {"tokens": torch.cat([toks, pad], 1)}, **kw)
        return logits[:, pad.shape[1]:], cache
    monkeypatch.setattr(LM, "prefill", padded)
    result = run_small(one_client())
    assert not result["correct"], result["check"]


def test_each_request_is_read_against_its_own_prompt():
    """At the mix's 8 clients: each checked request's row is its own
    prompt and the tokens it was fed, nothing else, read from its own last
    prompt position on. At fp32 the longest prompt of each batch, which
    the loop serves with no padding, gets the reference's best token at
    every position but near ties."""
    cell = smoke.small_cell(WORKLOAD)
    cell.conf["program"]["set"].update(compute_dtype="float32",
                                      kv_cache_dtype="float32")
    assert cell.mix["clients"] == 8
    drv = cell.runner
    run = drv.run(cell, seed=SEED, seconds=0.3, tracer=tracing.Tracer(False),
                  device="cpu", t_process=harness.process_start())
    checked = run.extra["checked"]
    picked = drv.sample(run.records, SEED, cell.mix["check_requests"])
    assert len(picked) == len(checked)
    for (b, i), c in zip(picked, checked):
        prompt, fed, _ = run.records[b]["served"][i]
        assert c.tokens[0].tolist() == list(prompt) + list(fed)
        assert c.at == list(range(len(prompt) - 1, len(prompt) + len(fed)))
        assert c.longest == (len(prompt) == run.records[b]["plen"])
    rows = drv.gap_of(run.extra["logits"], [c.want for c in checked])
    longest = [r for r, c in zip(rows, checked) if c.longest]
    assert longest and len(longest) < len(rows)
    assert drv.mean_gap(longest)["widest_gap"] < 1e-3


def test_a_traced_run_reports_the_per_layer_metrics():
    cell = one_client()
    result = harness.execute(cell, SEED, 0.3, trace=True, device="cpu")
    assert result["correct"]
    # no device on the CPU: the device's readers read nothing
    assert {"prefill_ms.serve", "decode_step_ms.serve", "pager_ms.serve",
            "mfu.prefill", "mfu.serve"} <= set(result["metrics"])
    assert "flash_roofline.prefill" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
