"""The one generator of every traffic mix: a mix is a JSON file of
parameters under ``perfbench/traffic/``, read here.

Serving (``"runner": "serve_closed_loop"``): ``clients`` clients in a
closed loop, so a batch is ``clients`` requests and the next batch is sent
when the last reply is in. Prompt lengths follow ``prompt_dist``
("loguniform") on [``prompt_min``, ``prompt_max``], stratified: a cycle of
``cycle_batches`` batches holds the ``clients * cycle_batches`` quantiles
(i + 1/2) / n of the distribution, stratum s (the s-th ``cycle_batches``
of them) giving each batch one length. The seed picks which quantile of a
stratum each batch of a cycle gets, the order of a batch's requests and
every token id, so that every seed serves the same lengths a cycle and
every batch the same spread. Each request asks for ``new_tokens`` tokens.

Training (``"runner": "train"``): ``dataset_rows`` rows of ``seq_len``
token ids drawn uniformly from the vocabulary, fed ``batch_size`` rows a
step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of ``stream`` for a run seeded with ``seed``
    (any integer)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 64, *stream]))


@dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray        # [L] int32
    new_tokens: int


def _quantile_lengths(mix: Dict) -> np.ndarray:
    """The ``clients * cycle_batches`` lengths of one cycle, ascending."""
    n = mix["clients"] * mix["cycle_batches"]
    u = (np.arange(n) + 0.5) / n
    lo, hi = mix["prompt_min"], mix["prompt_max"]
    if mix["prompt_dist"] != "loguniform":
        raise ValueError(f"unknown prompt_dist {mix['prompt_dist']!r}")
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                   ).astype(np.int64)


def serve_lengths(mix: Dict, seed: int, cycle: int) -> np.ndarray:
    """[cycle_batches, clients] prompt lengths of cycle ``cycle``: row j is
    batch j of the cycle, in the order its requests are sent."""
    nb, nc = mix["cycle_batches"], mix["clients"]
    strata = _quantile_lengths(mix).reshape(nc, nb)      # [stratum, rank]
    r = rng(seed, 1, cycle)
    pick = np.stack([r.permutation(nb) for _ in range(nc)])
    lengths = np.take_along_axis(strata, pick, axis=1).T  # [batch, stratum]
    return np.stack([row[r.permutation(nc)] for row in lengths])


def serve_batches(mix: Dict, seed: int, vocab: int
                  ) -> Iterator[List[ServeRequest]]:
    """The batches the clients send, without end."""
    req = 0
    for cycle in range(2 ** 62):
        lengths = serve_lengths(mix, seed, cycle)
        tok = rng(seed, 2, cycle)
        for row in lengths:
            batch = []
            for L in row:
                batch.append(ServeRequest(req, tok.integers(
                    0, vocab, int(L), dtype=np.int32), mix["new_tokens"]))
                req += 1
            yield batch


def max_prompt(mix: Dict) -> int:
    """The longest prompt the mix sends."""
    return int(_quantile_lengths(mix)[-1])


WARMUP_IDS = 1 << 40


def warmup_batch(mix: Dict, seed: int, vocab: int) -> List[ServeRequest]:
    """One batch of ``clients`` prompts at the longest length of the mix,
    the shapes set-up warms; ids above any real request's."""
    tok = rng(seed, 3)
    return [ServeRequest(WARMUP_IDS + i, tok.integers(
        0, vocab, max_prompt(mix), dtype=np.int32), mix["new_tokens"])
        for i in range(mix["clients"])]


def train_rows(mix: Dict, seed: int, vocab: int) -> np.ndarray:
    """[dataset_rows, seq_len] int32 token ids."""
    return rng(seed, 4).integers(0, vocab, (mix["dataset_rows"],
                                            mix["seq_len"]), dtype=np.int32)
