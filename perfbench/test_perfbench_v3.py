"""The DeepSeek-V3 training cell on the CPU at a small size: a run and
its check through the harness, the counters' readers, the control and the
faults, and a port that has no such architecture."""
from __future__ import annotations

import copy

import pytest

from perfbench import calibrate, harness, smoke

WORKLOAD = "dsv3l5e8.train.s512"
SEED = 2 ** 31 + 93
SIZES = dict(hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
             num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
             q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, router_outputs=16,
             n_routed_experts=4, first_held_expert=4, num_experts_per_tok=4,
             n_group=4, topk_group=2)
PORT = dict(n_layers=3, first_dense=1, d_model=64, n_heads=4, kv_heads=4,
            vocab=256, q_lora=24, kv_lora=32, qk_nope_dim=16,
            qk_rope_dim=16, v_head_dim=16, d_ff=128, d_expert=32,
            n_experts=16, experts_held=4, first_held=4, top_k=4, n_group=4,
            topk_group=2, yarn_factor=4.0, yarn_original=64)


def small_cell(**conf_over) -> harness.Cell:
    """The cell with its widths and traffic scaled down, YaRN at factor 4
    over 64 positions so that the traffic's 32 tokens cross its ramp."""
    cell = harness.load_cell(WORKLOAD)
    conf = copy.deepcopy(cell.conf)
    conf.update(SIZES, **conf_over)
    conf["rope_scaling"] = dict(conf["rope_scaling"], factor=4,
                                original_max_position_embeddings=64)
    conf["program"]["set"] = dict(PORT)
    cell.conf = conf
    cell.mix = dict(cell.mix, **smoke.TRAIN)
    return cell


def run_small(cell, seconds=0.3, trace=False):
    return harness.execute(cell, SEED, seconds, trace=trace, device="cpu")


def test_a_run_is_correct_and_reads_its_counters():
    cell = small_cell()
    result = run_small(cell)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_tok_s", "setup_s"}
    run_metrics = harness.read_metrics(
        _last_run(cell), [m for m in cell.per_layer
                          if m["source"] == "program_counter"])
    assert 50 < run_metrics["moe_kept_share.train"]["value"] <= 100
    assert run_metrics["expert_load_ratio.train"]["value"] >= 1


def _last_run(cell):
    from perfbench import tracing
    return cell.runner.run(cell, seed=SEED, seconds=0.2,
                           tracer=tracing.Tracer(False), device="cpu",
                           t_process=harness.process_start())


def test_the_control_and_the_fault_are_not_correct():
    """The reference in float8 in the port's place, and the reference
    with half of each batch left out, fail the cell's own limits at this
    size too, on every seed, where the port passes them."""
    cell = small_cell()
    for seed in (1, 2):
        r = calibrate.train_readings(cell, seed, True, True, "cpu")
        assert r["correct"] and not r["control.correct"], r
        assert not r["half_batch.correct"], r


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from repro_torch.optim import train_state

    def unchanged(params, grads, state, **kw):
        return params, train_state.AdamWState(step=state.step + 1, m=state.m,
                                              v=state.v)
    monkeypatch.setattr(train_state, "adamw_apply", unchanged)
    result = run_small(small_cell())
    assert not result["correct"]
    assert result["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_port_without_the_architecture_fails_at_once(monkeypatch):
    """A port that registers no deepseek-v3-671b fails the cell before
    any work, so that its run ends with an error, soon."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "PORT_ONLY_ARCH_IDS", ())
    with pytest.raises(KeyError):
        run_small(small_cell())


def test_the_readers_read_nothing_without_counters(monkeypatch):
    from repro_torch import trace
    monkeypatch.delattr(trace, "counters")
    run = harness.Run(kind="train", conf={}, mix={}, reference=None,
                      setup_s=1.0, records=[], attempted=0, failed=0,
                      memory_peak_bytes=0, check={})
    cell = harness.load_cell(WORKLOAD)
    assert harness.read_metrics(run, [m for m in cell.per_layer if m[
        "source"] == "program_counter"]) == {}
