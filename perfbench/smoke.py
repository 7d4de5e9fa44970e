"""Cells of the benchmark cut to a size the CPU tests can run: the same
files, the widths and the traffic scaled down, the port on the CPU (its
kernels' plain versions). Only the tests use them; the benchmark's runs
never do."""
from __future__ import annotations

import copy

from perfbench import harness

SIZES = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, vocab_size=256, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
             moe_intermediate_size=32)
PORT = dict(n_layers=2, d_model=64, n_heads=4, kv_heads=4, vocab=256,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, kv_lora=32,
            n_experts=8, top_k=2, n_shared_experts=1, d_expert=32, d_ff=32,
            head_dim=16)
SERVE = dict(prompt_min=16, prompt_max=48, check_requests=10)
TRAIN = dict(batch_size=2, seq_len=32, dataset_rows=40)
# A cell held out of BENCHMARK.json has no limits file; at this size its
# limit sits as a cell's would (``calibrate.place_limit``) between the
# port's largest mean gap with one client, 0.0077, and the float8
# control's smallest, 0.0831 (seeds 1-3 on the CPU, windows of 0.3 and
# 2 seconds).
HELD_LIMITS = {"dsv2l.serve.longdoc": {"mean_gap": 0.0376}}


def small_cell(workload: str, **conf_over) -> harness.Cell:
    cell = harness.load_cell(workload, held_out=True)
    conf = copy.deepcopy(cell.conf)
    conf.update(SIZES, **conf_over)
    conf["program"]["set"] = dict(PORT)
    cell.conf = conf
    cell.limits = cell.limits or dict(HELD_LIMITS.get(workload, {}))
    cell.mix = dict(cell.mix, **(SERVE if cell.mix["runner"]
                                 == "serve_closed_loop" else TRAIN))
    return cell
