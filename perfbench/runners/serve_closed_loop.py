"""Serving in a closed loop through the port's ``ServeLoop``.

Set-up: the port's configuration from the configuration file, weights from
the seed on the device in the served type, one ``ServeLoop`` with a slot a
client and room for the longest prompt and its answer, and one warm-up
batch at the longest prompt (the shapes of the window, and the allocator's
peak). Then the collector is frozen and the window opens: the clients send
a batch, ``ServeLoop.run`` serves it whole, they send the next, until the
window's time is up; the batch in flight completes.

The loop returns the tokens of its decode steps; the token of the prefill
goes into the first decode step and is read there, with its time: it is
each request's first token. After the window the port's state is freed and
a sample of the completed requests, drawn from the seed with the longest
prompt in it, is run through the plain reference, each request by itself:
one forward call over its own prompt, then one call a token of its own
answer, with no other request's prompt or padding beside it. The number
compared is the mean gap by which a served token's logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.runners import (Phases, measure, port_config, served_dtype,
                               spread)


def run(cell, *, seed: int, seconds: float, tracer, device: str,
        t_process: float):
    from perfbench.harness import Run
    from repro_torch.launch.serve import Request, ServeLoop

    conf, mix, ref = cell.conf, cell.mix, cell.reference
    phases = Phases(t_process)
    cfg = port_config(conf)
    params = weights.make(ref.leaves(conf), seed, served_dtype(conf), device)
    _sync(device)
    phases.mark("weights")
    clients, new = mix["clients"], mix["new_tokens"]
    loop = ServeLoop(cfg, batch_slots=clients,
                     max_len=traffic.max_prompt(mix) + new, params=params,
                     device=device)
    fed: List[np.ndarray] = []          # the tokens each decode step took
    first: List[float] = []
    decode_step, prefill = loop.model.decode_step, loop.model.prefill

    def decode_entry(params_, batch, cache, pos):
        if not fed:
            first.append(time.perf_counter())
        fed.append(np.asarray(batch["tokens"])[:, 0].copy())
        with tracer.span("serve.decode_step"):
            tracer.phase = "decode"
            return decode_step(params_, batch, cache, pos)

    def prefill_entry(*a, **kw):
        with tracer.span("serve.prefill"):
            tracer.phase = "prefill"
            return prefill(*a, **kw)

    loop.model.decode_step = decode_entry
    loop.model.prefill = prefill_entry
    phases.mark("port_setup")

    def serve(batch) -> Dict:
        fed.clear()
        first.clear()
        reqs = [Request(r.req_id, r.prompt, max_new_tokens=r.new_tokens)
                for r in batch]
        before = dict(loop.stats)
        t_send = time.perf_counter()
        with tracer.span("serve.batch"):
            out = loop.run(reqs)
        t_done = time.perf_counter()
        plen = max(len(r.prompt) for r in batch)
        return {"t_send": t_send, "t_first": first[0], "t_done": t_done,
                "plen": plen, "prompt_lens": [len(r.prompt) for r in batch],
                "steps": len(fed), "returned": [len(out[r.req_id])
                                                for r in batch],
                "delta": {k: loop.stats[k] - before.get(k, 0)
                          for k in ("prefill_s", "decode_s", "pager_s",
                                    "prefill_tokens", "decode_tokens")},
                "served": [(r.prompt, np.array([f[i] for f in fed]),
                            np.array(out[r.req_id]))
                           for i, r in enumerate(batch)]}

    serve(traffic.warmup_batch(mix, seed, cfg.vocab))
    phases.mark("warmup")
    batches = traffic.serve_batches(mix, seed, cfg.vocab)
    records, setup_s, summary = measure(lambda: serve(next(batches)),
                                        seconds, tracer, device, t_process)
    spread("batch s", [r["t_done"] - r["t_send"] for r in records])
    spread("decode step ms", [1e3 * r["delta"]["decode_s"] / r["steps"]
                              for r in records])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    loop.model.decode_step, loop.model.prefill = decode_step, prefill
    del loop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    phases.mark("window")
    checked = groups(records, sample(records, seed, mix["check_requests"]),
                     params["embed"].device)
    logits = reference_logits(ref, conf, params, checked)
    check = mean_gap(gap_of(logits, [g.want for g in checked]))
    phases.mark("check")
    n = sum(len(r["prompt_lens"]) for r in records)
    return Run(kind="serve", conf=conf, mix=mix, reference=ref,
               setup_s=setup_s, records=records,
               attempted=n, failed=sum(
                   x != new for r in records for x in r["returned"]),
               memory_peak_bytes=peak, check=check, trace=summary,
               extra={"params": params, "phases": phases.seconds,
                      "checked": checked, "logits": logits})


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def sample(records: List[Dict], seed: int, n: int) -> List[tuple]:
    """(batch, row) of ``n`` completed requests drawn from the seed, the
    one with the longest prompt among them."""
    every = [(b, i) for b, r in enumerate(records)
             for i in range(len(r["prompt_lens"]))]
    longest = max(every, key=lambda bi: records[bi[0]]["prompt_lens"][bi[1]])
    rest = [x for x in every if x != longest]
    pick = traffic.rng(seed, 5).permutation(len(rest))[:max(n - 1, 0)]
    return sorted([longest] + [rest[i] for i in pick])


@dataclass
class Checked:
    """One checked request as the reference reads it."""
    tokens: torch.Tensor      # [1, L + steps]: its prompt, then the tokens fed
    prompt_len: int           # L
    at: List[int]             # the positions whose logits gave its tokens
    want: torch.Tensor        # [1, steps + 1]: the prefill's token, then the
    #                           ones the loop returned
    longest: bool             # its prompt the longest of its batch


def groups(records, picked, device) -> List[Checked]:
    """The reference's inputs: each picked request alone, its own prompt
    followed by the tokens it was fed in the decode steps."""
    out = []
    for b, i in picked:
        r = records[b]
        prompt, fed, returned = r["served"][i]
        L = len(prompt)
        out.append(Checked(
            torch.as_tensor(np.concatenate([prompt, fed]).astype(np.int64),
                            device=device)[None],
            L, list(range(L - 1, L + len(fed))),
            torch.as_tensor(np.concatenate([fed[:1], returned]),
                            device=device)[None],
            L == r["plen"]))
    return out


def reference_logits(ref, conf, params, checked: List[Checked],
                     precision="fp32") -> List:
    return ref.served_logits(params, conf,
                             [(c.tokens, c.prompt_len, c.at) for c in checked],
                             ref.Numerics(precision))


def gap_of(logits, tokens) -> List[List[float]]:
    """For each checked request, the reference's best logit at each
    position less its logit of the token given there."""
    out = []
    for lg, tok in zip(logits, tokens):
        best = lg.max(-1).values
        got = torch.gather(lg, -1, tok[..., None])[..., 0]
        out.append((best - got).flatten().tolist())
    return out


def mean_gap(g: List[List[float]]) -> Dict[str, float]:
    """The number compared: the mean gap over the checked tokens. (The
    widest gap is kept beside it, not compared: see ``PERF.md``.)"""
    flat = [x for row in g for x in row]
    return {"mean_gap": sum(flat) / len(flat), "widest_gap": max(flat)}
