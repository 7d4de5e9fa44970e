#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its serving path, its
storage tier, its trainer (every family: dense, recurrent, MoE with MLA,
the encoder-decoder and the VLM with M-RoPE), its sharding layer (at
world size 1; the dry-run of a production cell) and the repo's examples
(k-means over the buffer pool among them) on a GPU.

Run from the root of a checkout on a machine with one NVIDIA H100 (Hopper,
``nvcc`` under ``/usr/local/cuda``): ``python3 chip_smoke.py``.

Phases, each raising on failure (nothing is caught, so a failed phase is a
non-zero exit):

1. the card's name and power limit from ``nvidia-smi``;
2. build the five CUDA sources from ``src/repro_torch/csrc`` with ``nvcc``,
   one process per source, all started together; ``ptxas``' registers and
   spills and, from ``cuobjdump -sass``, the tensor-core instruction counts
   (``HGMMA``, ``HMMA``), the highest register and the local stores of each
   flash kernel (``flash_build`` line) and of each linear-scan kernel
   (``scan_build``: the diagonal scan's ring and step kernels, the GLA
   scan's FMA and tensor-core kernels; fails without HMMA in the latter),
   and of the shuffle kernels (``shuffle_build``: dispatch's walk and
   direct kernels and combine, with their static and dynamic shared
   memory), and of the paged kernels (``paged_build``: a bf16 kernel for
   each head-dim bound and an fp32 kernel for each group bound, with the
   dynamic shared memory a block asks for at the served geometries; fails
   without HMMA in a bf16 kernel);
   the disassembly runs in the background during phase 3 and both lines
   are logged after it;
3. each kernel against its plain PyTorch version on the card: the reference
   test cases in fp32 and bf16, and the serving paths' own shapes, with
   CUDA-event timings of the kernel, its plain version and (flash) SDPA as a
   yardstick that the port never calls; paged attention at qwen3-0.6b's
   decode read over an fp32 and a bf16 pool, a long bf16 batch (32
   sequences of 2048-4096 keys), glm4-9b's group (32 query heads over 2
   kv heads) and recurrentgemma-9b's (16 over 1 of 256), each also held to
   a per-sequence relative error that one dropped chunk of keys fails, with
   dense SDPA over the gathered K/V as a yardstick that is not the same
   function; flash on both routes (fp32 and
   D % 8 != 0 scalar, bf16 wgmma) over the reference's cases and the edges
   of its tiles and masks, and timed at the prefills of qwen3-0.6b,
   recurrentgemma-9b (D = 256, one kv head, window 2048) and grok-1-314b
   (48 heads over 8), each with its route and tiles; the GLA scan on its
   two routes (fp32 FMA, bf16 tensor cores), also at unit scale against the
   exact (fp64) scan with the tolerance its witness gives, in fp32 and bf16,
   and timed at rwkv6-3b's prefill; the diagonal scan on its two routes (the ring for T > 1, the step
   for T = 1) with h0 in fp32 and bf16, failing unless its bits equal the
   plain version's, timed at recurrentgemma-9b's prefill in bf16 and fp32
   and at its decode; the MoE shuffle kernels (dispatch and combine) on the
   reference's cases with capacity drops, dropped ids and slots, repeated
   slots that sum, the round trip, rows that collect more pairs than
   dispatch's hit list holds (bits equal to the sum in token order), and
   grok-1-314b's served prefill and decode shapes (dispatch bit for bit the
   gather of the kept tokens, on its walk and its direct route); then
   full-width layers of each model, kernel path against
   plain path (recurrentgemma-9b: one superblock and one RG-LRU layer over
   2100 tokens, and a decode step; grok-1-314b: one layer in fp32, prefill
   and a decode step); then the training path's flash kernel (its own
   generator): each row's lse on both routes against the plain version
   (relative 1e-5 fp32, 1e-3 bf16), the output bit for bit that of a
   launch without lse, ``_FlashAttention``'s dq, dk, dv through the kernel
   forward against autograd of fp64 attention (3e-4 fp32, 2e-2 bf16) at
   the gradient cases and at qwen3-0.6b's training shape (B=8, H=16, KH=8,
   T=512, D=128) and the enc-dec's and the VLM's (seamless-m4t-large-v2's
   encoder: B=8, H=KH=16, T=512, D=64, non-causal; qwen2-vl-72b: B=4, 64
   query heads over 8, T=512, D=128), and at each of the three the
   forward's time with and without lse beside its bound, the plain
   backward's beside its bound and SDPA's forward, and its forward and
   backward, as a yardstick the port never calls (a ``flash_train`` line,
   the two families under ``families``); then MLA's
   heads, v's head dim Dv unlike q's and k's D (``flash_dv`` line): the
   flash kernel on both routes at smoke deepseek-v2-lite-16b's heads (D =
   24, Dv = 16), its full ones (192, 128) and more (Dv over D, a V tile of
   256 beside a q/K tile of 64, the scalar route's D % 8 != 0) against the
   plain version, each row's lse, ``_FlashAttention``'s gradients, and
   deepseek's prefill (B=4, H=KH=16, T=512, D=192, Dv=128) timed beside its
   bound, the plain version and SDPA (with the kernels SDPA ran); dispatch
   and combine at deepseek's served prefill (4 x 512 tokens, top-6 of 64
   experts, C = 60, D = 2048, on dispatch's walk) and decode (T = 1, C = 4,
   on its direct route), dispatch bit for bit the gather of the kept
   tokens, timed beside their bounds (a second ``shuffle_work`` line); one
   full-width deepseek-v2-lite-16b layer (MLA + MoE) in fp32, kernel path
   against plain path in prefill and a decode step, and its absorbed
   decode against the expanded one within 1e-4; flash at the enc-dec and
   VLM families' served shapes (``flash_families`` line): seamless-m4t-
   large-v2's encoder (B=4, H=KH=16, T=1024, D=64, bf16, non-causal) and
   qwen2-vl-72b's prefill (B=4, 64 query heads over 8, T=512, D=128, bf16,
   causal) against the plain version and timed beside the bound, the plain
   version and SDPA, and an fp32 case of each's heads on the scalar route;
   one full-width seamless encoder layer and decoder layer (self, cross,
   FFN) in fp32, kernel path against plain path (memory, forward, the
   cached prompt and a cached step), and one qwen2-vl-72b layer in fp32 at
   image-grid M-RoPE positions (t, h and w differ), prefill and a decode
   step with its positions in the batch; then the recurrent families'
   training kernels: the diagonal scan's backward kernel against its plain
   version (``diag_scan_bwd_ref``) bit for bit at small cases (T = 1,
   ragged widths, with h0 and a cotangent of h_T) and at
   recurrentgemma-9b's training shape (4 x 512 x 4096) in bf16 and fp32,
   timed beside its bound and the plain version (a ``diag_bwd`` line and
   a ``diag_scan_bwd`` kernels entry); at rwkv6-3b's training shape
   (B*H = 256, T = 512, D = 80) and the GLA chunk it trains with (16),
   the GLA kernel's o and S_T under grad (the fp32 FMA route, o in the
   inputs' dtype) against the chunked plain version (GLA_TOL) and, at
   unit-scale r and k in bf16, against the exact scan; ``_GLAScan``'s gradients (its plain backward by recompute,
   which never reads the kernel's o) and ``_DiagScan``'s (the backward
   kernel) against fp64 autograd of the plain versions at rwkv6-3b's and
   recurrentgemma-9b's training shapes (3e-4 fp32, 2e-2 bf16), and the
   GLA's plain backward timed beside its bound (a ``scan_train`` line);
   then the MoE families' training path at deepseek-v2-lite-16b's
   training shape (8 x 512 tokens, top-6 of 64 experts a row: 24576 pairs
   over 512 buffers of C = 60, D = 2048): ``_Dispatch``'s and
   ``_Combine``'s gradients on the kernels (each one's backward a launch
   of the other's kernel, dgates plain) against ``dispatch_bwd_ref`` /
   ``combine_bwd_ref`` (1e-5 fp32, 2e-2 bf16), one forward and one
   backward launch each, dispatch's on the walk; the device ms of
   dispatch's forward, of combine as dispatch's backward, of dispatch as
   combine's backward and of the plain dgates, each beside its byte bound,
   its plain version and ``index_add_`` or the gated-mask einsum (a
   ``moe_train`` line);
4. serve: full-width qwen3-0.6b ``ServeLoop`` answers 8 requests of 512
   prompt tokens and 32 new tokens with a page pool too small to hold them,
   prefill through the flash kernel;
5. KV pool: the served prompts' K/V written into a ``PagedKVCache`` at
   qwen3's geometry, evicted and restored, and read in place by the paged
   kernel, against its plain version and dense attention: exactly 84
   launches (3 attended batches of 28 layers);
6. profile: host wall time, device busy time and idle share of one warm
   prefill and one warm decode step of qwen3-0.6b (torch.profiler);
7. serve: full-width rwkv6-3b ``ServeLoop`` (32 layers, bf16) answers 8
   requests of 512 prompt tokens and 32 new tokens with the default pool,
   prefill through the GLA-scan kernel;
8. profile: as phase 6, for rwkv6-3b;
9. serve: full-width recurrentgemma-9b ``ServeLoop`` (38 layers, bf16,
   params handed over already cast) answers 8 requests of 2100 prompt
   tokens (past the 2048-token window, so local attention keeps a ring) and
   32 new tokens, prefill through the diag-scan kernel (26 RG-LRU layers)
   and the flash kernel (12 attention layers), decode through the diag-scan
   kernel;
10. profile: as phase 6, for recurrentgemma-9b;
11. serve: grok-1-314b at full width and 4 of its 64 layers (21.3 B
    params, drawn in bf16 and handed over cast) answers 8 requests of 512
    prompt tokens and 32 new tokens with the default pool, every MoE layer's
    dispatch and combine through the shuffle kernels in prefill and in
    every decode step, prefill attention through the flash kernel;
12. profile: as phase 6, for grok-1-314b;
13. serving tier: the port's ``ServingTier`` at qwen3-0.6b's KV geometry
    (28 layers, page 64, 8 kv heads of 128, fp32: 14.68 MB a page slab)
    over a four-node inproc cluster, 32 pool pages a node on the card:
    16 sessions of 448-960 prompt tokens admitted and decoded 16 steps,
    so that Eq.-1 evictions, level-2 host slabs and level-3 spills to
    another node all happen; ``attend(impl="kernel")`` at every layer over
    per-shard batches whose pages fit the pool, held to ``attend(impl=
    "xla")`` and to dense fp64 attention over the oracle's K/V at 2e-5;
    every session verified byte for byte; one session's primary killed,
    4 more decode steps (failover), attend and verify again; then a
    four-node proc cluster forked after CUDA is up, a SIGKILL mid-decode,
    failover, verify and attend, failing unless ``close()`` leaves no child
    and no shared-memory segment and no rpc value was refused; one attend
    launch timed beside its bound (the tier's tables and lengths over a copy
    of the pool filled with seeded random K/V); then the inproc part again
    at a bf16 pool, the configs' ``kv_cache_dtype`` (7.34 MB a slab, the
    host budget in slabs of that size), held at 2e-2, every paged launch on
    the bf16 route, and its launch timed and checked the same way;
14. durable tier: phase 4's qwen3-0.6b params (28 layers, bf16, on the
    card) checkpointed in pool mode (``CheckpointManager(cluster=...)``,
    layouts row and col, 4 shards) over a four-node inproc cluster with a
    page log on every node (``pagelog_fsync="group"``, 1 MiB pages, pools
    of 1 GiB, under one layout); node 0, which holds the row layout and
    ``latest``, killed and revived warm: ``latest_step()`` is 1 again, the
    row layout comes back from its replayed log with no network bytes and
    every leaf bit-identical on the card, and one prefill of phase 4's
    first batch with the restored params gives phase 4's first tokens;
    node 0 killed again and revived cold: ``latest_step()`` and a restore
    without a step raise (as the JAX package's do), and a restore of step
    1 falls through to the col layout on node 2 with the same bits; a
    four-node proc cluster forked after CUDA is up with 64 MiB of pairs
    and a replica: a SIGKILLed node recovered warm from its own log (source
    ``pagelog``, no bytes moved, records byte-identical), another recovered
    cold from the replica, a clean ``close()``; ``ClusterJoin`` of two
    sides of 500 k rows, co-partitioned (no network bytes) and with the probe
    side moving, each byte for byte the numpy sort-merge oracle; the port's
    ``fsck`` clean on every node's log; a ``durable_tier`` line;
15. train: full-width qwen3-0.6b (28 layers, 751.6 M fp32 params, bf16
    compute, remat per layer, fp32 AdamW moments) ``run_training`` for 12
    steps of 8 x 512 tokens, 32 sequences written through the buffer pool
    and read back by ``BatchLoader``: every loss finite and the mean of the
    last 4 under that of the first 4; one step from the same params and
    batch with attention's forward on the kernel and on the plain chunked
    path (loss and grad norm within 2e-2); one warm step profiled
    (forward, attention's plain backward, the rest of the backward, AdamW,
    the device's idle share); then the crash and restart of
    ``tests/test_system.py`` at full width and 2 layers (one layout of the
    full-depth fp32 state is ~9 GB): a run that checkpoints at step 2 and
    crashes there, the checkpoint bit-identical to its state on the card,
    a run that restores from step 2 and finishes; a ``train`` line with the
    card's name and power limit;
16. serve: full-width, full-depth deepseek-v2-lite-16b (27 layers of MLA
    over MoE, 16.2 B params drawn in bf16 and handed over cast) answers 8
    requests of 512 prompt tokens and 32 new tokens with the default pool,
    prefill attention through the flash kernel at D = 192, Dv = 128 (on
    wgmma), every MoE layer's dispatch and combine through the shuffle
    kernels in prefill (walk) and every decode step (direct), decode over
    the expanded per-head cache; a ``deepseek`` line (params, peak device
    GB, the phase's seconds);
17. profile: as phase 6, for deepseek-v2-lite-16b;
18. seamless-m4t-large-v2 at full width and depth (24 + 24 layers, d 1024,
    16 heads of 64, vocab 256206; 2.04 B params drawn in bf16) through its
    own entry points, as the JAX package's dry run lowers them: 8 requests
    of 1024 frame embeddings (the stubbed frontend, drawn from the seed), a
    128-token decoder prompt and 32 greedy new tokens, in static batches of
    4: ``encode`` (flash, non-causal, D = 64), ``decode_cache_init`` with
    the memory, the prompt as one ``decode_step``, 32 one-token steps (the
    cached decode and cross-attention plain, as the reference's); then one
    teacher-forced ``forward`` over the first batch, its logits at the
    prompt's positions held to the cached path's: per sequence, a relative
    error at most 2e-2 over the plain forward's (``drift_check``: over 48
    bf16 layers, paths with no kernel already differ by 0.09 absolute); a
    profile of a warm encode and decode step; a ``seamless`` line;
19. qwen2-vl-72b at full width and 24 of its 80 layers (23.6 B params
    drawn in bf16; 80 are ~140 GB): ``ServeLoop`` answers 8 requests of 512
    prompt tokens and 32 new tokens (M-RoPE at the broadcast positions,
    flash at 64 query heads over 8), then one ``LM.prefill`` of 4 x 512
    embeddings at image-grid positions (64 text tokens, a 16 x 16 patch
    grid, 192 text tokens), its last logits held to the plain path's as in
    phase 18 (the second plain path the naive attention), and 8 decode
    steps with their positions in the batch; a ``qwen2vl`` line;
20. profile: as phase 6, for qwen2-vl-72b;
21. train: full-width, full-depth rwkv6-3b (32 layers, 3.07 B fp32 params,
    bf16 compute, remat per layer, fp32 AdamW moments) ``run_training`` for
    12 steps of 8 x 512 tokens over phase 15's 32 repeated sequences, every
    layer's wkv forward on the GLA kernel (and again in its remat
    recompute), on its fp32 FMA route (the tensor-core route's 16-bit
    operands move the bf16 gradient far past the plain path's), and its
    backward plain by recompute, at GLA chunk 16 (at the JAX package's 64
    the loss is NaN from step 2): losses finite and
    falling; one step from the trained params with ``scan_impl="kernel"``
    against ``"xla_chunked"``: the loss within 2e-2 in bf16 compute, the
    loss and grad norm within 2e-2 in fp32 compute (in bf16 the full-depth
    grad norm is not fixed to 2e-2 by any path: two plain algorithms
    differ by 31% there; at the random init paths that differ only in
    rounding give grad norms orders apart even in fp32); a profiled
    warm step (forward, the GLA's plain backward, the rest of the
    backward, AdamW, idle share) at full width and 4 of the 32 layers,
    from init; a ``train_rwkv`` line;
22. train: recurrentgemma-9b at full width and 5 of its 38 layers (one
    (rec, rec, attn) superblock, rematerialised, and the config's two
    ``rem`` RG-LRU layers; 3.22 B fp32 params) with batches of 4 x 512
    tokens over 16 repeated sequences, every RG-LRU layer's scan on the
    diagonal-scan kernels forward and backward, the local attention on
    flash at D = 256: the same checks, ``scan_impl="kernel"`` against
    ``"xla"`` (the sequential oracle); a ``train_hybrid`` line;
23. train: deepseek-v2-lite-16b at full width and 4 of its 27 layers (MLA
    over MoE; 2.76 B fp32 params, 44.1 GB with gradients and fp32 moments)
    for 12 steps of 8 x 512 tokens over phase 15's 32 repeated sequences,
    remat per layer, every MLA layer's attention on flash (D = 192, Dv =
    128, with lse) and every MoE layer's dispatch and combine on the
    shuffle kernels forward and backward (dispatch's gradient a combine
    launch with unit gates; combine's a dispatch launch of the
    gate-weighted rows on the walk, its gate gradient plain): losses
    finite and falling; a profiled warm step (forward, attention's plain
    backward, the dispatch and combine backward nodes, the shuffle
    kernels' own ms, the rest, AdamW, idle share); one step from the
    trained params with attention and MoE on the kernels against both on
    ``"xla"`` (the chunked attention, the dense dispatch mask): the loss
    within 2e-2 in bf16 compute, loss and grad norm in fp32 compute; a
    ``train_moe`` line;
24. train: seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
    2.03 B fp32 params by the port's own ``count_params``, 32.6 GB with
    gradients and fp32 moments) for 12 steps of 8 x 512 tokens over phase
    15's 32 repeated sequences, 8 x 512 standard-normal frames drawn each
    step from (seed, step), remat per encoder and decoder layer, every
    self-attention on flash (the encoder's non-causal at D = 64), the
    cross-attention plain, as the reference runs it: losses finite and
    falling; a profiled warm step (forward, attention's plain backward,
    the rest, AdamW, idle share); one step from the trained params with
    attention on the kernel against ``"xla"``: the loss within 2e-2 in bf16
    compute, loss and grad norm in fp32 compute; a ``train_encdec`` line;
25. train: qwen2-vl-72b at full width and 2 of its 80 layers (4.25 B fp32
    params, bf16 AdamW moments as its config has them) for 12 steps of 4 x
    512 tokens over 16 repeated sequences, each batch the embeddings of its
    tokens gathered from the params before the step, at the broadcast
    M-RoPE positions: the same checks, the route step at image-grid
    positions (64 text tokens, a 16 x 16 patch grid, 192 text tokens); a
    ``train_vlm`` line;
26. sharded training: phase 15's run (full-width qwen3-0.6b, its seed, its
    first 3 batches of 8 x 512) through ``run_training(mesh=)`` on a 1 x 1
    ("data", "model") ``DeviceMesh`` over an NCCL group of world size 1
    (a ``FileStore`` in a temporary directory), the fsdp_tp preset: params,
    moments and batches DTensors, every step under ``sharding.use_rules``,
    every flash launch through ``local_map``; each loss within 1e-4
    max(|loss|, 1) of phase 15's at that step (the gap printed; the bits
    are expected equal); a profiled warm step: the step ms beside phase
    15's, DTensor's host cost and the idle share; a ``train_sharded``
    line;
27. the MoE mesh branch: deepseek-v2-lite-16b at phase 23's cut with
    ``moe_strategy="expert_parallel_shardmap"`` on a 1 x 1 NCCL mesh: the
    loss of phase 23's first batch from phase 23's initial params through
    ``moe_shardmap_apply``'s mesh branch (dispatch and combine on each
    shard's experts, ids shifted, one all-reduce over "model") against the
    same params' loss with no mesh, within 1e-4 max(|loss|, 1); a
    ``shardmap`` line;
28. one production dry-run cell: ``python -m repro_torch.launch.dryrun``
    for qwen3-0.6b x train_4k x 16x16 in a subprocess (its own fake
    process group of 256 ranks, no GPU): rc 0, and its per-device argument
    bytes equal to the figure reckoned from the port's ``sharding_rules``
    and ``param_axes`` (``reckoned_train_args``); a ``dryrun`` line.
    Each phase's process group is taken down before the next; the cluster
    phases' node processes were forked before any group was up.
29. the repo's entry points on the port (run after phase 25 and before
    26, so that its proc-backend nodes too are forked before any process
    group is up): each ``examples/torch_*.py`` loaded by path and its
    ``main`` called in this process on the card, its printed lines logged
    after it. k-means over the buffer pool at 10 M points of 10 dims (400
    MB, norms 40 MB) through a 256 MB pool, 5 iterations: every point
    assigned; each iteration's seconds split into the pool scan with the
    host-to-device copy and ``assign_update``'s device ms; the last
    step's centroids within 1e-5 of an fp64 recomputation from its own
    assignments, and no assignment more than rounding from the fp64
    nearest; ``assign_update`` timed against its byte bound beside the
    host-to-device copy of the same bytes. The cluster quickstart's
    counts and bytes equal to ``CLUSTER_FIGURES``. The serving
    quickstart's ``attend`` on the paged kernel, exactly one launch a
    shard on the fp32 route, within 2e-5 of ``"xla"``. serve_paged (smoke
    glm4-9b, 12 requests): flash in each prefill, exactly a layer a batch
    on wgmma, no paged launch. The quickstart: 10 training steps of smoke
    qwen3-0.6b (a flash launch a layer a step, with lse), the checkpoint
    restored, 5 greedy tokens (one prefill launch a layer). train_100m
    at 40 steps with ``--simulate-failure``: the crash at step 20, the
    restart from its checkpoint, exactly one flash launch a layer a step
    (560), all on the fp32 scalar route with lse. No other kernel on any
    of these paths; an ``example`` line for each and an ``examples`` line
    with every path's launches by route.

Launch counts are zeroed just before phase 4 and read just after phase 5
(flash and paged attention: the qwen3 path), zeroed again just before phase
7 and read just after it (the GLA scan: the rwkv6-3b path), again just
before phase 9 and read just after it (the diagonal scan and flash: the
recurrentgemma-9b path), and again just before phase 11 and read just after
it (dispatch, combine and flash: the grok-1-314b path), and again just
before phase 13 and read just after its fp32 part, and again just before
and after its bf16 part (paged attention: the
``ServingTier`` path, exactly one launch a shard of each ``attend`` call,
counted from the tier's sessions at the call, all on the pool dtype's
route), and again just before
phase 14 and read just after it (flash attention: the durable path's one
prefill, exactly one launch a layer, all on the wgmma route), and again
just before phase 15's training run and read just after it (flash
attention: exactly 2 launches a layer a step, the forward and its remat
recompute, all on the wgmma route and all writing lse), and again just
before phase 16 and read just after it (flash, dispatch and combine: the
deepseek-v2-lite-16b path, with no other kernel), and again just before
phase 18 and read just after it (flash: exactly 24 launches for each of the
2 encodes and 48 for the forward, 96, all on the wgmma route, no other
kernel), and again just before phase 19 and read just after it (flash: 24
a ServeLoop prefill batch and 24 for the embeddings' prefill, 72, all on
wgmma, no other kernel), and again just before phase 21's training run and
read just after it (the GLA scan: exactly 2 launches a layer a step, the
forward and its remat recompute, all on the fp32 FMA route, and one
call of its plain backward a layer a step; no other kernel), and again
just before phase 22's training run and read just after it (the diagonal
scan: 6 forward launches a step, 2 x 2 in the rematerialised superblock
and 2 in the ``rem`` layers, all on the ring, and 4 backward launches;
flash: 2 a step, all wgmma with lse; no other kernel), and again just
before phase 23's training run and read just after it (a layer a step:
flash 2, all wgmma with lse; dispatch 3, all on the walk, the forward, its
remat recompute and combine's backward; combine 3, the same with
dispatch's backward; one plain dgates; no other kernel), and again just
before phase 24's and phase 25's training runs and read just after each
(flash: 2 launches a self-attention layer a step, all wgmma with lse, the
encoder's 2 x 24 a step non-causal; 1152 and 48; no other kernel), and
again just before each example of phase 29 and read just after it
(k-means and the cluster quickstart: no kernel; the serving quickstart:
paged, one a shard of its ``attend("kernel")``, fp32; serve_paged: flash 8,
wgmma; the quickstart: flash 22, wgmma, 20 with lse; train_100m: flash
560, scalar, all with lse), and
again just before phase 26's run and read just after it (flash: exactly 2
a layer a step, 168, all wgmma with lse; no other kernel), and again just
before phase 27's sharded loss and read just after it (a layer: one flash
on wgmma, one dispatch on the walk, one combine; no other kernel). Each
serve phase fails unless every kernel of its path made exactly the launches its
layers and batches call for, every flash launch of a serve phase on the
wgmma route, every GLA launch of a serve phase on the tensor-core route,
and the diagonal
scan's launches on the ring (prefill) and the step (decode) route as its
layers call for, and dispatch's on the walk (prefill) and the direct
(decode) route. The script's own seconds are logged on an ``elapsed``
line; the second-to-last line is ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device":
{...}}``. Without CUDA, or without
the rest of the repo beside it, the script exits non-zero and prints no
result.

``tools/paged_shapes.py`` times the paged kernel alone at this script's
paged shapes (``paged_cases``, ``paged_shape``), with another checkout's
``repro_torch`` or with the ring filled by ``cp.async`` only.
"""
import atexit
import contextlib
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import zlib
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.attention import SDPBackend


def _fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


if not torch.cuda.is_available():
    _fail("torch.cuda.is_available() is False; this runs on an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import BufferPool, PagedKVCache  # noqa: E402
from repro_torch.core.kvcache import host_array, host_to_tensor  # noqa: E402
from repro_torch.core.pagelog import fsck  # noqa: E402
from repro_torch.core.services import (  # noqa: E402
    canonical_join_sort, join_output_dtype)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel, kernel_route, wgmma_tiles)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _attn_bwd_core, flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.linear_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.linear_scan.ops import (  # noqa: E402
    _gla_chunked, diag_scan, gla_scan)
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    diag_scan_bwd_ref, diag_scan_ref, gla_scan_ref)
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.kernels.shuffle_dispatch import kernel as shuffle_kernel  # noqa: E402
from repro_torch.kernels.shuffle_dispatch.ops import (  # noqa: E402
    combine, combine_dgates, compute_slots, dispatch)
from repro_torch.kernels.shuffle_dispatch.ref import (  # noqa: E402
    combine_bwd_ref, dispatch_bwd_ref)
from repro_torch.data.pipeline import (  # noqa: E402
    BatchLoader, synthetic_token_dataset)
from repro_torch.launch.mesh import (  # noqa: E402
    batch_shardings, distribute, make_mesh, param_shardings, sharding_rules)
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    SimulatedFailure, run_training, state_to)
from repro_torch.launch.train import train_batch as complete_batch  # noqa: E402
from repro_torch.models.blocks import (  # noqa: E402
    TRAIN_GLA_CHUNK, _capacity)
from repro_torch.models.lm import torch_dtype, tree_map  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    _on_meta, build_model, count_params)
from repro_torch.optim import adamw_apply, make_train_state  # noqa: E402
from repro_torch.optim.train_state import leaf_grads  # noqa: E402
from repro_torch.runtime.cluster import Cluster  # noqa: E402
from repro_torch.runtime.join import ClusterJoin  # noqa: E402
from repro_torch.runtime.rpc import pickle_fallbacks  # noqa: E402
from repro_torch.runtime.serving import ServingTier, token_value  # noqa: E402
from repro_torch.sharding import spec_for, use_rules  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# the paged kernel's timed shapes, besides TOL: each sequence's relative
# (Frobenius) error over its heads, which one dropped chunk of keys exceeds
PAGED_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
POOL_TOL = 2e-5
GLA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # the reference's
SHUFFLE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # the reference's

# the JAX package's kernel test cases (tests/test_kernels.py)
FLASH_CASES = [  # B, H, KH, Tq, Tk, D, causal, window
    (1, 4, 2, 64, 64, 32, True, None),
    (2, 4, 4, 40, 72, 16, True, None),
    (1, 2, 1, 64, 64, 32, False, None),
    (1, 2, 2, 96, 96, 32, True, 32),
    (1, 8, 4, 128, 128, 64, True, None),
]
# edges of the flash kernels' tiles and masks (tests/test_torch_cuda.py
# FLASH_EDGE_CASES): a continued prefill, T and D off the tiles, windows off
# and under the key tile, groups of 1, 6 and 16, peaked scores, D % 8 != 0
FLASH_EDGE_CASES = [  # B, H, KH, Tq, Tk, D, causal, window, q_offset, q scale
    (1, 4, 2, 100, 260, 64, True, None, 160, 1.0),
    (2, 6, 1, 200, 200, 96, True, None, 0, 1.0),
    (1, 4, 4, 300, 300, 128, True, 200, 0, 1.0),
    (1, 2, 1, 257, 257, 256, True, 40, 0, 1.0),
    (1, 16, 1, 130, 130, 128, True, None, 0, 1.0),
    (1, 4, 2, 192, 192, 64, True, None, 0, 8.0),
    (1, 2, 2, 70, 300, 128, False, None, 0, 1.0),
    (1, 4, 1, 64, 300, 256, True, 100, 236, 1.0),
    (1, 2, 1, 90, 90, 36, True, None, 0, 1.0),
]
# v's head dim unlike q's and k's (MLA; tests/test_torch_cuda.py
# FLASH_DV_CASES): smoke deepseek-v2-lite-16b's heads (D = 24, Dv = 16) and
# its full ones (192, 128), GQA, causal and not, Dv over D, a V tile of 256
# beside a q/K tile of 64, D % 8 != 0 (the scalar route)
FLASH_DV_CASES = [  # B, H, KH, Tq, Tk, D, causal, window, q_offset, q scale, Dv
    (2, 4, 2, 40, 72, 24, True, None, 0, 1.0, 16),
    (1, 4, 4, 64, 64, 24, False, None, 0, 1.0, 16),
    (1, 4, 2, 150, 150, 192, True, None, 0, 1.0, 128),
    (1, 2, 2, 130, 200, 192, False, None, 0, 1.0, 128),
    (1, 2, 1, 70, 90, 16, True, None, 20, 1.0, 24),
    (1, 2, 1, 100, 100, 64, True, 40, 0, 1.0, 256),
    (1, 2, 2, 50, 50, 36, True, None, 0, 1.0, 16),
]
# the gradient cases at Dv != D: B, H, KH, Tq, Tk, D, causal, window,
# q_offset, block_k, Dv
FLASH_DV_GRAD_CASES = [
    (2, 4, 4, 40, 40, 24, True, None, 0, 16, 16),
    (1, 4, 2, 150, 150, 192, True, None, 0, 128, 128),
]
PAGED_CASES = [  # B, H, KH, D, P, page, max_pages
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 16, 8, 16, 3),
    (3, 4, 1, 64, 32, 8, 6),
]
# test_gla_scan_sweep's cases, a T that is not a chunk multiple, the served
# head (80) with a chunk longer than T and a padded two-chunk T, odd widths
# and the widest head the kernel takes. Log decays are -exp(w0 + N(0,
# 0.5^2)): w0 = 0 as the reference's tests draw them, w0 = -2 as rwkv_init's
# w0 makes them (at chunk 64 and w0 = 0 the reference's factorisation
# overflows fp32: e^{c_{i-1} - c_L} passes e^{88})
GLA_CASES = [  # B, T, Dk, Dv, chunk, w0
    (2, 32, 16, 16, 16, 0.0),
    (1, 64, 32, 16, 16, 0.0),
    (2, 48, 8, 24, 16, 0.0),
    (2, 50, 8, 24, 16, 0.0),
    (1, 37, 80, 80, 64, -2.0),
    (1, 100, 80, 80, 64, -2.0),
    (3, 45, 10, 6, 16, 0.0),        # widths that are not whole 16-byte rows
    (2, 130, 128, 128, 64, -2.0),   # the kernel's widest head
]
# test_diag_scan_sweep's cases, a width that is not whole channel pairs, and
# recurrentgemma-9b's decode (T = 1); its prefill is timed in check_diag
DIAG_CASES = [  # B, T, D, chunk
    (2, 64, 16, 16),
    (1, 100, 8, 32),
    (3, 32, 32, 32),
    (2, 77, 33, 16),
    (4, 1, 4096, 256),
]
# test_shuffle_dispatch_sweep's cases and a width that is not whole 16-byte
# rows; grok-1-314b's served shapes are drawn in check_shuffle
SHUFFLE_CASES = [  # T, D, E, K, C
    (64, 32, 4, 2, 32),
    (128, 16, 8, 1, 24),
    (96, 64, 16, 6, 16),
    (50, 37, 5, 3, 12),
]
# more pairs on a walk block's rows than its hit list holds (1024): all
# pairs on one row, and pairs drawn at random over a few rows
OVERFLOW_CASES = [  # kind, T, D, E, K, C
    ("one row", 4096, 64, 4, 2, 8),
    ("spread", 3001, 40, 3, 3, 8),
]


def log(*a):
    print(*a, flush=True)


def close_or_fail(out, ref, tol, what):
    """allclose with rtol = atol = tol; returns the max abs error."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        _fail(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        _fail(f"{what}: non-finite output")
    err = (out - ref).abs()
    excess = float((err - tol * (1 + ref.abs())).max())
    if excess > 0:
        _fail(f"{what}: max abs err {float(err.max())} over tol {tol}")
    return float(err.max())


_FLUSH = None


def time_ms(fn, reps=20, spin=True):
    """Median device ms of one call, timed with CUDA events. The 50 MB L2 is
    flushed before each call, so inputs come from device memory, and the GPU
    then spins for ~1 ms so that the host has enqueued the whole call before
    the start event fires: the host's launch overhead is not counted. With
    ``spin=False`` it is, as far as the device waits for it."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape)).to(DEV, dtype)


# -- phase 2: what the compiler made of the kernels --------------------------------
def start_disassembly(sources):
    """``cuobjdump -sass`` of each built library into ``<library>.sass``
    beside it, started together in the background (seconds of host work
    each, overlapped with phase 3)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    procs = {}
    for src in sources:
        lib = _build._lib_path(src)
        with open(lib.with_suffix(".sass"), "w") as out:
            procs[src] = subprocess.Popen([cuobjdump, "-sass", str(lib)],
                                          stdout=out)
    # a failed phase exits early: stop whatever is still running
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


_DISASSEMBLY = {}


def sass_of(source):
    """The disassembly of ``csrc/<source>.cu``'s library."""
    if _DISASSEMBLY[source].wait():
        _fail(f"cuobjdump of {source} failed")
    return _build._lib_path(source).with_suffix(".sass").read_text()


def build_facts(source, short):
    """Per kernel of ``csrc/<source>.cu``: ``ptxas``' registers, spill
    bytes and static shared memory (-Xptxas -v), and from ``cuobjdump
    -sass`` the tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync), the highest register
    index and the local-memory stores. ``short`` names a kernel from its
    mangled name."""
    facts = {}
    fn = None
    for line in _build.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = short(m.group(1))
            facts[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            facts[fn].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            facts[fn]["ptxas_registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and fn:
            facts[fn]["static_smem"] = int(m.group(1))
    for body in re.split(r"\n\s+Function : ", sass_of(source))[1:]:
        fn = short(body.split("\n")[0].strip())
        facts.setdefault(fn, {}).update(
            hgmma=body.count("HGMMA"), hmma=len(re.findall(r"\bHMMA\b", body)),
            local_stores=body.count("STL"),
            max_register=max(int(r) for r in re.findall(r"\bR(\d+)\b", body)))
    return facts


def flash_build_facts():
    """The flash kernels' build facts (a 384-thread block starts at 168
    registers a thread, and the consumer warpgroups' code after
    ``setmaxnreg.inc`` may use up to 240)."""
    def short(mangled):
        m = re.search(r"(flash_fwd_\w+?)I(\w+?)EEv", mangled)
        if not m:
            return mangled
        args = ["bf16" if a.group(0)[0] == "1" else "f32" if a.group(0) == "f"
                else a.group(1)
                for a in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f(?=Li)",
                                     m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"

    facts = build_facts("flash_attention", short)
    if not sum(f.get("hgmma", 0) for f in facts.values()):
        _fail(f"no HGMMA in the flash library: {facts}")
    return facts


def scan_build_facts():
    """The two linear scans' build facts: the diagonal scan's ring and step
    kernels and the GLA scan's FMA and tensor-core kernels. Fails unless
    the tensor-core GLA kernel has HMMA instructions."""
    def short(mangled):
        m = re.search(r"\d+(diag_scan_\w+?|gla_scan_\w+?)(?:I(\w+?)E)?(?:EvP|EPK)",
                      mangled)
        if not m:
            return mangled
        arg = m.group(2) or ""
        return m.group(1) + ("<bf16>" if "bfloat16" in arg else
                             "<f32>" if arg == "f" else "")

    facts = {"diag_scan": build_facts("diag_scan", short),
             "linear_scan": build_facts("linear_scan", short)}
    mma = facts["linear_scan"].get("gla_scan_mma", {})
    if not mma.get("hmma"):
        _fail(f"no HMMA in the tensor-core GLA kernel: {facts}")
    return facts


def shuffle_build_facts():
    """The shuffle kernels' build facts: dispatch's walk and direct kernels
    and combine, by data (and gate) type. None takes dynamic shared memory
    (the launches pass 0 bytes); the walk kernel's hit list is static."""
    def short(mangled):
        m = re.search(r"\d+(dispatch_walk|dispatch_direct|combine_kernel)"
                      r"I(\w+?)EEv", mangled)
        if not m:
            return mangled
        # S1_ names the first type again (bf16 data with bf16 gates)
        args = ["bf16" if a in ("13__nv_bfloat16", "S1_") else
                "f32" if a == "f" else f"KG={a[2:-1]}"
                for a in re.findall(r"13__nv_bfloat16|S1_|Li\d+E|f",
                                    m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"

    facts = build_facts("shuffle_dispatch", short)
    for f in facts.values():
        f.setdefault("static_smem", 0)            # ptxas names none
        f["dynamic_smem"] = 0
    return facts


def paged_build_facts():
    """The paged kernels' build facts (bf16 by its head-dim bound DM, fp32
    by its group bound GB) and the dynamic shared memory a block asks for at
    the served geometries (the library's count, the one its launch passes).
    Fails unless every bf16 kernel has HMMA instructions."""
    def short(mangled):
        m = re.search(r"paged_attention_kernelI(13__nv_bfloat16|f)Li(\d+)ELi"
                      r"(\d+)E", mangled)
        if not m:
            return mangled
        return (f"paged<bf16,DM={m.group(2)}>" if m.group(1) != "f"
                else f"paged<f32,GB={m.group(3)}>")

    facts = build_facts("paged_attention", short)
    for f in facts.values():
        f.setdefault("static_smem", 0)            # ptxas names none
    for fn, f in facts.items():
        if "bf16" in fn and not f.get("hmma"):
            _fail(f"no HMMA in the bf16 paged kernel {fn}: {facts}")
    facts["dynamic_smem"] = {
        f"{name} {paged_kernel.ROUTES[dtype]}":
            paged_kernel.smem_bytes(dtype, G, D)
        for name, G, D in (("qwen3 G=2 D=128", 2, 128),
                           ("grok G=6 D=128", 6, 128),
                           ("glm4 G=16 D=128", 16, 128),
                           ("recurrentgemma G=16 D=256", 16, 256))
        for dtype in (torch.float32, torch.bfloat16)}
    return facts


# -- phase 3: kernels against their plain versions ------------------------------
def check_flash(rng):
    worst = {}
    # the reference's cases from the shared generator, the edge cases from
    # their own, so that the later kernels' inputs stay those of the earlier
    # slices
    erng = np.random.default_rng(15)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES + FLASH_EDGE_CASES:
            B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale = \
                tuple(case) + (0, 1.0)[len(case) - 8:]
            g = rng if len(case) == 8 else erng
            q = rand(g, (B, H, Tq, D), dtype) * q_scale
            k, v = rand(g, (B, KH, Tk, D), dtype), rand(g, (B, KH, Tk, D), dtype)
            route = kernel_route(dtype, D)
            before = flash_attention.launches_by_route[route]
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, impl="kernel")
            torch.cuda.synchronize()
            if flash_attention.launches_by_route[route] != before + 1:
                _fail(f"flash {case} {dtype}: not on the {route} route")
            ref = attention_ref(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
            err = close_or_fail(out, ref, TOL[dtype], f"flash {case} {dtype}")
            worst[f"{route} {dtype}"] = max(worst.get(f"{route} {dtype}", 0.0),
                                            err)
    # the serving paths' prefills, 4 prompts each: qwen3-0.6b's heads over
    # 512 tokens, and recurrentgemma-9b's over 2100 with its window of 2048
    paths = {"qwen3-0.6b": flash_at(rng, 4, 16, 8, 512, 128, None)}
    # recurrentgemma-9b's heads (D = 256, 16 query heads over one kv head, a
    # window shorter than T) from their own generator, so that the later
    # kernels' inputs stay those of the earlier slices
    grng = np.random.default_rng(13)
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(grng, (1, 16, 300, 256), dtype)
        k = rand(grng, (1, 1, 300, 256), dtype)
        v = rand(grng, (1, 1, 300, 256), dtype)
        out = flash_attention(q, k, v, causal=True, window=128, impl="kernel")
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=True, window=128)
        worst[f"D=256 {dtype}"] = close_or_fail(out, ref, TOL[dtype],
                                                f"flash D=256 {dtype}")
    paths["recurrentgemma-9b"] = flash_at(grng, 4, 16, 1, 2100, 256, 2048)
    # grok-1-314b's prefill: 48 query heads over 8 kv heads of 128
    paths["grok-1-314b"] = flash_at(np.random.default_rng(14), 4, 48, 8, 512,
                                    128, None)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:84",
                cases_max_abs_err=worst, **paths["qwen3-0.6b"], paths=paths)


def flash_at(rng, B, H, KH, T, D, window, Dv=None, causal=True):
    """The kernel at one serving path's prefill shape (bf16, causal unless
    ``causal=False``; v's head dim ``Dv``, D by default): its route and
    tiles, error against the plain version, times of the kernel, the plain
    version and SDPA (causal, with no mask, or with the window as a boolean
    mask; with the backend PyTorch chose for it), and the bound."""
    dtype = torch.bfloat16
    Dv = D if Dv is None else Dv
    q = rand(rng, (B, H, T, D), dtype)
    k, v = rand(rng, (B, KH, T, D), dtype), rand(rng, (B, KH, T, Dv), dtype)
    kw = dict(causal=causal, window=window)
    out = flash_attention(q, k, v, impl="kernel", **kw)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, **kw)
    err = close_or_fail(out, ref, TOL[dtype], f"flash served shape H={H}"
                        f" KH={KH} D={D} Dv={Dv} causal={causal}")
    del out, ref

    def run():
        return flash_attention(q, k, v, impl="kernel", **kw)

    pos = torch.arange(T, device=DEV)
    mask = (pos[None, :] <= pos[:, None]) if causal else torch.ones(
        T, T, dtype=torch.bool, device=DEV)
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_kw = (dict(is_causal=causal) if window is None
               else dict(attn_mask=mask))
    library_ms = time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **sdpa_kw))
    library_backend = SDPBackend(torch._fused_sdp_choice(
        q, k, v, enable_gqa=True, **sdpa_kw)).name
    pairs = B * H * int(mask.sum())                  # live (q, k) pairs
    # read q, k and v once, write the output [B, H, T, Dv] once; products
    # of 2 D (scores) and 2 Dv (P V) flops over each live pair
    nbytes = (q.numel() + k.numel() + v.numel() + B * H * T * Dv) \
        * q.element_size()
    bound_ms, bound_by = bound(nbytes, 2 * (D + Dv) * pairs, dtype)
    route = kernel_route(dtype, D, Dv)
    return dict(shape=f"B={B} H={H} KH={KH} T={T} D={D}"
                      + (f" Dv={Dv}" if Dv != D else "")
                      + (" bf16 causal" if causal else " bf16 non-causal")
                      + (f" window={window}" if window else ""),
                kernel_route=route,
                tiles=wgmma_tiles(D, Dv) if route == "wgmma" else None,
                max_abs_err=err, tolerance=TOL[dtype], ms=kernel_ms,
                kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_backend=library_backend)


# the JAX package's attention-gradient case (tests/test_kernels.py) and the
# masks the training slice's CPU tests cover (tests/test_torch_train.py
# GRAD_CASES): GQA, q_offset, windows, Tk off the kv chunk
FLASH_GRAD_CASES = [  # B, H, KH, Tq, Tk, D, causal, window, q_offset, block_k
    (1, 4, 2, 48, 48, 16, True, None, 0, 16),
    (2, 4, 1, 40, 72, 16, True, None, 32, 16),
    (1, 2, 2, 96, 96, 32, True, 32, 0, 32),
    (1, 4, 4, 33, 50, 8, False, None, 0, 16),
    (1, 8, 2, 20, 70, 16, True, 16, 50, 32),
    (1, 4, 2, 150, 150, 64, True, None, 0, 128),
    # the training shapes of seamless-m4t-large-v2's encoder (non-causal,
    # D = 64) and of qwen2-vl-72b (64 query heads over 8)
    (8, 16, 16, 512, 512, 64, False, None, 0, 128),
    (4, 64, 8, 512, 512, 128, True, None, 0, 128),
]
# qwen3-0.6b's training shape: batch 8 of 512 tokens, 16 heads over 8
TRAIN_SHAPE = (8, 16, 8, 512, 512, 128)
# the enc-dec's and the VLM's (B, H, KH, T, D, causal), timed beside it
FAMILY_TRAIN_SHAPES = {
    "seamless-m4t-large-v2 encoder": (8, 16, 16, 512, 64, False),
    "qwen2-vl-72b": (4, 64, 8, 512, 128, True),
}
# examples/torch_train_100m.py's attention (batch 8 of 128 tokens, 8 heads
# of 64, causal), computed in fp32: the scalar route with lse under grad
TRAIN_100M_SHAPE = (8, 8, 8, 128, 128, 64)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}      # relative
GRAD_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}


def naive_fp64(q, k, v, causal, window, q_offset):
    """Softmax attention in fp64 with autograd (the gradients' oracle)."""
    B, H, Tq, D = q.shape
    KH, Tk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KH, dim=1)
    vr = v.repeat_interleave(H // KH, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) * D ** -0.5
    qp = torch.arange(Tq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= kp > qp - window
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)


def flash_lse_case(rng, case, dtype, out_tol=None):
    """One case of the lse check: each row's lse against the plain version
    (relative to max(|lse|, 1), within LSE_TOL, +inf on the same rows) and
    the output bit for bit that of a launch without lse; with ``out_tol``,
    the output against the plain version's too. Returns (route, the lse's
    relative error, the output's max abs error or None)."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale = \
        tuple(case) + (0, 1.0)[len(case) - 8:]
    q = rand(rng, (B, H, Tq, D), dtype) * q_scale
    k, v = rand(rng, (B, KH, Tk, D), dtype), rand(rng, (B, KH, Tk, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    bare = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    what = f"flash lse {case} {dtype}"
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if not torch.equal(out.view(bits), bare.view(bits)):
        _fail(f"{what}: out with lse differs from out without it")
    ref_out, ref = attention_ref(q, k, v, return_lse=True, **kw)
    out_err = None if out_tol is None else close_or_fail(out, ref_out,
                                                         out_tol, what)
    if not torch.equal(torch.isinf(lse), torch.isinf(ref)):
        _fail(f"{what}: +inf rows differ")
    fin = torch.isfinite(ref)
    rel = float(((lse[fin] - ref[fin]).abs()
                 / ref[fin].abs().clamp_min(1.0)).max()) \
        if fin.any() else 0.0
    if rel > LSE_TOL[dtype]:
        _fail(f"{what}: relative error {rel} over {LSE_TOL[dtype]}")
    return kernel_route(dtype, D), rel, out_err


def flash_grad_case(rng, case, dtype):
    """One case of the gradient check: ``_FlashAttention`` through the
    kernel forward (one launch with lse), its dq, dk, dv against autograd of
    fp64 attention within GRAD_TOL. Returns the worst max abs error."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, bk = case
    q = rand(rng, (B, H, Tq, D), dtype)
    k, v = rand(rng, (B, KH, Tk, D), dtype), rand(rng, (B, KH, Tk, D), dtype)
    w = rand(rng, (B, H, Tq, D), torch.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.lse_launches
    out = flash_attention(*leaves, impl="kernel", block_k=bk, **kw)
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    if flash_attention.lse_launches != before + 1:
        _fail(f"flash grads {case} {dtype}: the forward wrote no lse")
    ref = [t.double().requires_grad_(True) for t in (q, k, v)]
    (naive_fp64(*ref, **kw) * w.double()).sum().backward()
    worst = 0.0
    for t, r, name in zip(leaves, ref, "qkv"):
        worst = max(worst, close_or_fail(t.grad, r.grad, GRAD_TOL[dtype],
                                         f"flash d{name} {case} {dtype}"))
    return worst


def check_flash_train(rng):
    """The training path's flash kernel: the rows' lse on both routes
    against the plain version (relative 1e-5 in fp32, 1e-3 in bf16, +inf on
    the same rows), the output bit for bit that of a launch without lse;
    ``_FlashAttention``'s dq, dk, dv through the kernel forward against
    autograd of fp64 attention (3e-4 fp32, 2e-2 bf16) at the gradient cases
    and at qwen3-0.6b's training shape; and, at that shape in bf16, the
    times of the forward with lse, of the plain backward (no kernel) beside
    its bound, and of SDPA's forward and backward as a yardstick the port
    never calls."""
    lse_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES + FLASH_EDGE_CASES + [
                TRAIN_SHAPE + (True, None), (1, 2, 1, 8, 8, 8, True, None, -3,
                                             1.0)]:
            route, rel, _ = flash_lse_case(rng, case, dtype)
            lse_err[f"{route} {dtype}"] = max(
                lse_err.get(f"{route} {dtype}", 0.0), rel)
    grad_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_GRAD_CASES + [TRAIN_SHAPE + (True, None, 0, 128)]:
            worst = flash_grad_case(rng, case, dtype)
            key = {TRAIN_SHAPE: "train shape", **{
                (b, h, kh, t, t, d): f"{name} train shape"
                for name, (b, h, kh, t, d, _) in FAMILY_TRAIN_SHAPES.items()
            }}.get(case[:6], "cases")
            grad_err[f"{key} {dtype}"] = max(
                grad_err.get(f"{key} {dtype}", 0.0), worst)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    B, H, KH, T, _, D = TRAIN_SHAPE
    times = flash_train_times(rng, B, H, KH, T, D, True)
    return dict(lse_max_rel_err=lse_err,
                lse_tolerance={names[d]: t for d, t in LSE_TOL.items()},
                grads_max_abs_err=grad_err,
                grads_tolerance={names[d]: t for d, t in GRAD_TOL.items()},
                **times,
                families={name: flash_train_times(rng, *shape)
                          for name, shape in FAMILY_TRAIN_SHAPES.items()})


def check_flash_train_100m(rng):
    """train_100m's attention at its own shape and dtype (fp32, the scalar
    route): the output against the plain version within TOL and each row's
    lse within LSE_TOL, then ``_FlashAttention``'s dq, dk, dv through the
    kernel forward against autograd of fp64 attention within GRAD_TOL."""
    dtype = torch.float32
    route, rel, out_err = flash_lse_case(rng, TRAIN_100M_SHAPE + (True, None),
                                         dtype, out_tol=TOL[dtype])
    if route != "scalar":
        _fail(f"flash train_100m shape: route {route}, not scalar")
    grads = flash_grad_case(rng, TRAIN_100M_SHAPE + (True, None, 0, 128),
                            dtype)
    return dict(shape="B={} H={} KH={} T={} D={} causal fp32".format(
                    *TRAIN_100M_SHAPE[:4], TRAIN_100M_SHAPE[5]),
                route=route, out_max_abs_err=out_err, out_tolerance=TOL[dtype],
                lse_max_rel_err=rel, lse_tolerance=LSE_TOL[dtype],
                grads_max_abs_err=grads, grads_tolerance=GRAD_TOL[dtype])


def flash_train_times(rng, B, H, KH, T, D, causal):
    """At one training shape in bf16: the times of the kernel's forward
    with and without lse beside the forward's bound, of the plain backward
    (no kernel) beside its bound, and of SDPA's forward and of its forward
    and backward as a yardstick the port never calls."""
    dtype = torch.bfloat16
    q = rand(rng, (B, H, T, D), dtype)
    k, v = rand(rng, (B, KH, T, D), dtype), rand(rng, (B, KH, T, D), dtype)
    dout = rand(rng, (B, H, T, D), dtype)
    out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                      return_lse=True)
    scale = D ** -0.5
    fwd_ms = time_ms(lambda: flash_attention_kernel(q, k, v, causal=causal))
    fwd_lse_ms = time_ms(lambda: flash_attention_kernel(
        q, k, v, causal=causal, return_lse=True))
    bwd_ms = time_ms(lambda: _attn_bwd_core(q, k, v, out, dout, lse, causal,
                                            None, scale, 0, 128), reps=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
        o.backward(dout)

    sdpa_fwd_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                       enable_gqa=True))
    sdpa_ms = time_ms(sdpa_fwd_bwd)
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # the forward: read q, k, v once, write out and the fp32 lse once; two
    # products of 2 D flops over each live (q, k) pair
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4
    fwd_bound_ms, fwd_bound_by = bound(fwd_bytes, 4 * D * pairs, dtype)
    # the backward: read q, k, v, out, dout and lse once, write dq, dk, dv
    # once; five products of 2 D flops over each live (q, k) pair
    nbytes = (3 * q.numel() + k.numel() + v.numel()) * 2 \
        + lse.numel() * 4 + (q.numel() + k.numel() + v.numel()) * 2
    bwd_bound_ms, bwd_bound_by = bound(nbytes, 10 * D * pairs, dtype)
    return dict(shape=f"B={B} H={H} KH={KH} T={T} D={D} bf16 "
                + ("causal" if causal else "non-causal"),
                fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms,
                fwd_bound_ms=fwd_bound_ms, fwd_bound_by=fwd_bound_by,
                backward_plain_ms=bwd_ms, backward_bound_ms=bwd_bound_ms,
                backward_bound_by=bwd_bound_by, sdpa_fwd_ms=sdpa_fwd_ms,
                sdpa_fwd_bwd_ms=sdpa_ms)


def check_flash_dv(rng):
    """The flash kernel with v's head dim Dv unlike q's and k's D (MLA), on
    both routes: FLASH_DV_CASES in fp32 and bf16 against the plain version
    (the route each takes asserted; the output [B, H, Tq, Dv]), each row's
    lse (relative 1e-5 fp32, 1e-3 bf16, +inf on the same rows, the output's
    bits those of a launch without lse), ``_FlashAttention``'s forward (one
    launch with lse) and gradients against autograd of fp64 attention at
    FLASH_DV_GRAD_CASES; then deepseek-v2-lite-16b's prefill (B=4, H=KH=16,
    T=512, D=192, Dv=128, bf16, causal) timed beside its bound, the plain
    version and SDPA (with the kernels SDPA ran)."""
    worst, lse_err, grad_err = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_DV_CASES:
            B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale, Dv = case
            q = rand(rng, (B, H, Tq, D), dtype) * q_scale
            k, v = rand(rng, (B, KH, Tk, D), dtype), rand(rng, (B, KH, Tk, Dv),
                                                          dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            route = kernel_route(dtype, D, Dv)
            if route != ("wgmma" if dtype == torch.bfloat16 and D % 8 == 0
                         and Dv % 8 == 0 else "scalar"):
                _fail(f"flash {case} {dtype}: route {route}")
            before = flash_attention.launches_by_route[route]
            out = flash_attention(q, k, v, impl="kernel", **kw)
            torch.cuda.synchronize()
            if flash_attention.launches_by_route[route] != before + 1:
                _fail(f"flash {case} {dtype}: not on the {route} route")
            what = f"flash Dv {case} {dtype}"
            ref_out, ref = attention_ref(q, k, v, return_lse=True, **kw)
            worst[f"{route} {dtype}"] = max(
                worst.get(f"{route} {dtype}", 0.0),
                close_or_fail(out, ref_out, TOL[dtype], what))
            out2, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out2, out):
                _fail(f"{what}: out with lse differs from out without it")
            if not torch.equal(torch.isinf(lse), torch.isinf(ref)):
                _fail(f"{what}: +inf rows of lse differ")
            fin = torch.isfinite(ref)
            rel = float(((lse[fin] - ref[fin]).abs()
                         / ref[fin].abs().clamp_min(1.0)).max()) \
                if fin.any() else 0.0
            if rel > LSE_TOL[dtype]:
                _fail(f"{what}: lse relative error {rel}")
            lse_err[f"{route} {dtype}"] = max(
                lse_err.get(f"{route} {dtype}", 0.0), rel)
        for case in FLASH_DV_GRAD_CASES:
            B, H, KH, Tq, Tk, D, causal, window, q_offset, bk, Dv = case
            q = rand(rng, (B, H, Tq, D), dtype)
            k, v = rand(rng, (B, KH, Tk, D), dtype), rand(rng, (B, KH, Tk, Dv),
                                                          dtype)
            w = rand(rng, (B, H, Tq, Dv), torch.float32)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = flash_attention.lse_launches
            out = flash_attention(*leaves, impl="kernel", block_k=bk, **kw)
            (out.float() * w).sum().backward()
            torch.cuda.synchronize()
            if flash_attention.lse_launches != before + 1:
                _fail(f"flash grads {case} {dtype}: the forward wrote no lse")
            ref = [t.double().requires_grad_(True) for t in (q, k, v)]
            (naive_fp64(*ref, **kw) * w.double()).sum().backward()
            for t, r, name in zip(leaves, ref, "qkv"):
                grad_err[str(dtype)] = max(
                    grad_err.get(str(dtype), 0.0),
                    close_or_fail(t.grad, r.grad, GRAD_TOL[dtype],
                                  f"flash d{name} {case} {dtype}"))
    served = flash_at(rng, 4, 16, 16, 512, 192, None, Dv=128)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    return dict(cases_max_abs_err=worst, lse_max_rel_err=lse_err,
                grads_max_abs_err=grad_err,
                tolerance={names[d]: t for d, t in TOL.items()},
                served=served)


def check_mla_small(cfg, rng, T=130):
    """One full-width MLA + MoE layer of ``cfg`` in fp32: the kernel path
    (flash's scalar route at D = 192, Dv = 128; the shuffle kernels) against
    the plain path (chunked attention, the dense dispatch mask) in prefill
    and a decode step, as ``check_model_small``; then the absorbed decode
    against the expanded one (both kernel paths, the same prefill) within
    1e-4."""
    err = check_model_small(cfg, rng, 1e-4, attn_impl="xla", moe_impl="xla",
                            n_layers=1, T=T)
    small = cfg.with_(n_layers=1, compute_dtype="float32",
                      kv_cache_dtype="float32")
    params = build_model(small).init(torch.Generator("cuda").manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, T + 1)))
    logits = {}
    for absorbed in (False, True):
        model = build_model(small, mla_absorbed=absorbed)
        _, cache = model.prefill(params, {"tokens": toks[:, :T]},
                                 max_len=T + 8)
        logits[absorbed], _ = model.decode_step(
            params, {"tokens": toks[:, T:]}, cache, T)
        torch.cuda.synchronize()
        del cache
    absorbed_err = close_or_fail(logits[True], logits[False], 1e-4,
                                 f"{cfg.name} absorbed vs expanded decode")
    return dict(max_abs_err=err, tolerance=1e-4,
                absorbed_vs_expanded_max_abs_err=absorbed_err,
                absorbed_tolerance=1e-4)


def check_flash_families(rng):
    """Flash at the served geometries of the enc-dec and VLM families:
    seamless-m4t-large-v2's encoder (B=4, H=KH=16, T=1024, D=64, bf16,
    non-causal: every key tile live for every q tile) and qwen2-vl-72b's
    prefill (B=4, 64 query heads over 8 kv heads of 128, T=512, bf16,
    causal), each on the wgmma route against the plain version (2e-2) and
    timed beside its bound, the plain version and SDPA; and an fp32 case of
    the same heads (B=1, T=300, off the tiles; the scalar route) at 3e-5.
    Returns ({path: timed shape}, {case: max abs err})."""
    worst = {}
    heads = {"seamless-m4t-large-v2 encoder": (16, 16, 64, False, 1024),
             "qwen2-vl-72b": (64, 8, 128, True, 512)}
    for name, (H, KH, D, causal, _) in heads.items():
        dtype = torch.float32
        q = rand(rng, (1, H, 300, D), dtype)
        k, v = rand(rng, (1, KH, 300, D), dtype), rand(rng, (1, KH, 300, D),
                                                       dtype)
        before = flash_attention.launches_by_route["scalar"]
        out = flash_attention(q, k, v, causal=causal, impl="kernel")
        torch.cuda.synchronize()
        if flash_attention.launches_by_route["scalar"] != before + 1:
            _fail(f"flash {name} fp32: not on the scalar route")
        worst[f"scalar float32 {name}"] = close_or_fail(
            out, attention_ref(q, k, v, causal=causal), TOL[dtype],
            f"flash {name} fp32")
    paths = {}
    for name, (H, KH, D, causal, T) in heads.items():
        paths[name] = flash_at(rng, 4, H, KH, T, D, None, causal=causal)
        if paths[name]["kernel_route"] != "wgmma":
            _fail(f"flash {name}: route {paths[name]['kernel_route']}")
        worst[f"wgmma bfloat16 {name}"] = paths[name]["max_abs_err"]
    return paths, worst


def grid_positions(B, n_text, grid, n_tail):
    """M-RoPE positions [B, 3, T] of a prompt that holds one image: n_text
    text tokens (t = h = w = 0..n_text-1), a gh x gw patch grid (t =
    n_text, h = n_text + row, w = n_text + column) and n_tail text tokens
    that go on from the grid's largest coordinate + 1."""
    gh, gw = grid
    text = torch.arange(n_text).expand(3, n_text)
    rows, cols = torch.meshgrid(torch.arange(gh), torch.arange(gw),
                                indexing="ij")
    patches = torch.stack([torch.full((gh * gw,), n_text),
                           n_text + rows.reshape(-1),
                           n_text + cols.reshape(-1)])
    start = n_text + max(gh, gw)
    tail = torch.arange(start, start + n_tail).expand(3, n_tail)
    pos = torch.cat([text, patches, tail], dim=1)
    return pos.expand(B, 3, pos.shape[1]).contiguous().to(DEV)


def check_encdec_small(cfg, rng, tol=1e-4, S=300, T=130):
    """One full-width encoder layer and one decoder layer (self, cross,
    FFN) of ``cfg`` in fp32: the kernel path (flash's scalar route,
    non-causal in the encoder, causal in the forward's decoder) against the
    plain path (``attn_impl="xla"``): the encoder memory over S frames, the
    forward's logits over T tokens, then on each path's own memory the
    cache, the prompt through one ``decode_step`` and one cached step."""
    small = cfg.with_(n_layers=1, n_encoder_layers=1,
                      compute_dtype="float32", kv_cache_dtype="float32")
    models = {"kernel": build_model(small),
              "plain": build_model(small, attn_impl="xla")}
    params = models["kernel"].init(torch.Generator("cuda").manual_seed(1))
    src = rand(rng, (2, S, small.d_model), torch.float32)
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, T + 1)))
    what = f"{cfg.name} 1+1-layer"
    out = {}
    for name, m in models.items():
        mem = m.encode(params, src)
        logits, _ = m.forward(params, {"src_embeds": src,
                                       "tokens": toks[:, :T]})
        cache = m.decode_cache_init(2, T + 8, memory=mem, params=params)
        prompt, cache = m.decode_step(params, {"tokens": toks[:, :T]},
                                      cache, 0)
        step, _ = m.decode_step(params, {"tokens": toks[:, T:]}, cache, T)
        torch.cuda.synchronize()
        out[name] = dict(encode=mem, forward=logits, prompt=prompt,
                         step=step)
        del cache
    return max(close_or_fail(out["kernel"][key], out["plain"][key], tol,
                             f"{what} {key} kernel vs plain")
               for key in ("encode", "forward", "prompt", "step"))


def check_vlm_small(cfg, rng, tol=1e-4, T=130):
    """One full-width qwen2-vl-72b layer in fp32 from embeddings at M-RoPE
    positions whose t, h and w differ (34 text tokens, an 8 x 8 patch grid,
    32 text tokens after it): the kernel path (flash's scalar route) against
    the plain path in prefill, and a decode step with its positions in the
    batch."""
    small = cfg.with_(n_layers=1, compute_dtype="float32",
                      kv_cache_dtype="float32")
    kern, plain = build_model(small), build_model(small, attn_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(1))
    pos = grid_positions(2, 34, (8, 8), T - 34 - 64)
    batch = {"embeds": rand(rng, (2, T, small.d_model), torch.float32),
             "positions": pos}
    lk, ck = kern.prefill(params, batch, max_len=T + 8)
    lp, cp = plain.prefill(params, batch, max_len=T + 8)
    torch.cuda.synchronize()
    what = f"{cfg.name} 1-layer"
    err = close_or_fail(lk, lp, tol, f"{what} prefill kernel vs plain")
    nxt = {"tokens": lp[:, -1:].argmax(dim=-1),
           "positions": (pos.amax(dim=(1, 2)) + 1)[:, None, None].expand(
               2, 3, 1)}
    del lk, lp
    dk, _ = kern.decode_step(params, nxt, ck, T)
    dp, _ = plain.decode_step(params, nxt, cp, T)
    torch.cuda.synchronize()
    return max(err, close_or_fail(dk, dp, tol,
                                  f"{what} decode kernel vs plain"))


def paged_inputs(rng, B, H, KH, D, P, page, lengths, dtype):
    q = rand(rng, (B, H, D), dtype)
    kv = rand(rng, (P, page, 2, KH, D), dtype)
    max_pages = max(-(-n // page) for n in lengths)
    bt = np.full((B, max_pages), -1, np.int32)
    for b, n in enumerate(lengths):
        npages = -(-n // page)
        bt[b, :npages] = rng.choice(P, size=npages, replace=False)
    return q, kv, bt, np.asarray(lengths, np.int32)


def check_paged(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in PAGED_CASES:
            B, H, KH, D, P, page, maxp = case
            lengths = []
            for _ in range(B):
                n = int(rng.integers(1, maxp + 1))
                lengths.append(int(rng.integers((n - 1) * page + 1, n * page + 1)))
            q, kv, bt, ln = paged_inputs(rng, B, H, KH, D, P, page, lengths,
                                         dtype)
            out = paged_attention(q, kv, bt, ln, impl="kernel")
            torch.cuda.synchronize()
            ref = paged_attention(q, kv, bt, ln, impl="xla")
            err = close_or_fail(out, ref, TOL[dtype], f"paged {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
        # long sequences: many chunks per split block
        q, kv, bt, ln = paged_inputs(rng, 2, 4, 1, 128, 600, 16, [7999, 3001],
                                     dtype)
        out = paged_attention(q, kv, bt, ln, impl="kernel")
        torch.cuda.synchronize()
        ref = paged_attention(q, kv, bt, ln, impl="xla")
        worst[f"long {dtype}"] = close_or_fail(out, ref, TOL[dtype],
                                               f"paged long {dtype}")
    # the serving path's decode read: qwen3-0.6b heads over an fp32 pool with
    # page 64, ragged lengths up to max_len 552, tables in random slot order
    B, H, KH, D, P, page = 4, 16, 8, 128, 40, 64
    lengths = [552, 471, 300, 65]
    slice_inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        slice_inputs[dtype] = paged_inputs(rng, B, H, KH, D, P, page, lengths,
                                           dtype)
    shapes = {name: paged_shape(*inputs)
              for name, inputs in paged_cases(slice_inputs).items()}
    for name, entry in shapes.items():
        worst[name] = entry["max_abs_err"]
    top = shapes["slice fp32"]
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:79",
                shape=top["shape"], tolerance=TOL[torch.float32],
                cases_max_abs_err=worst, max_abs_err=top["max_abs_err"],
                ms=top["kernel_ms"], kernel_ms=top["kernel_ms"],
                call_ms=top["call_ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=None, shapes=shapes)


def paged_long_inputs(B, H, KH, D, page, dtype, seed):
    """B sequences of lengths drawn from integers(2048, 4097) with the
    phase's seed (its own generator, so that the later kernels' inputs stay
    those of the earlier slices), each on its own pages of a pool of B * 64
    pages drawn on the card, tables in random page order."""
    lrng = np.random.default_rng(seed)
    lengths = [int(n) for n in lrng.integers(2048, 4097, size=B)]
    width = 4096 // page
    P = B * width
    gen = torch.Generator(DEV).manual_seed(seed)
    kv = torch.randn((P, page, 2, KH, D), generator=gen, device=DEV,
                     dtype=dtype)
    q = torch.randn((B, H, D), generator=gen, device=DEV, dtype=dtype)
    perm = lrng.permutation(P).astype(np.int32)
    bt = np.full((B, width), -1, np.int32)
    for b, n in enumerate(lengths):
        npages = -(-n // page)
        bt[b, :npages] = perm[b * width:b * width + npages]
    return q, kv, bt, np.asarray(lengths, np.int32)


def paged_cases(slice_inputs):
    """The paged kernel's timed shapes: qwen3-0.6b's served decode read
    (B=4, page 64, lengths 552/471/300/65) over an fp32 pool (the served
    one) and a bf16 one, a long bf16 batch at qwen3's geometry (B=32,
    lengths 2048-4096), glm4-9b's group (32 query heads over 2 kv heads)
    and recurrentgemma-9b's (16 over 1 of 256, the ring filled by
    ``cp.async``) at the same lengths; and the serving quickstart's geometry
    (examples/torch_serving_quickstart.py: H = KH = 2, D = 4, pages of 4
    rows, fp32, where the ring is filled by ``cp.async`` since a TMA box
    needs 8 rows) on random K/V and q, at the example's lengths and at
    longer ragged ones, from its own generator."""
    grng = np.random.default_rng(32)
    return {
        "slice fp32": slice_inputs[torch.float32],
        "slice bf16": slice_inputs[torch.bfloat16],
        "long bf16": paged_long_inputs(32, 16, 8, 128, 64, torch.bfloat16, 42),
        "glm4 group bf16": paged_long_inputs(32, 32, 2, 128, 64,
                                             torch.bfloat16, 42),
        "recurrentgemma group bf16": paged_long_inputs(32, 16, 1, 256, 64,
                                                       torch.bfloat16, 42),
        "serving quickstart fp32": paged_inputs(grng, 3, 2, 2, 4, 16, 4,
                                                [22, 18, 20], torch.float32),
        "serving quickstart long fp32": paged_inputs(
            grng, 3, 2, 2, 4, 64, 4, [45, 18, 130], torch.float32),
    }


def seq_rel_err(out, ref):
    """The largest relative (Frobenius) error of one sequence's output."""
    out, ref = out.float().flatten(1), ref.float().flatten(1)
    return float(((out - ref).norm(dim=1) / ref.norm(dim=1)).max())


# full-depth bf16 logits: per sequence, the kernel path's relative error to
# the plain path may pass that of a second plain path (no kernel) by this
DRIFT_TOL = 2e-2


def drift_check(out, ref, plain_out, what):
    """Logits of a full-depth bf16 model on the kernel path (``out``)
    against the plain path (``ref``). Elementwise 2e-2 is one call's
    tolerance: over 24-48 bf16 layers two plain paths with no kernel already
    differ by 1.4-1.9% relative and 0.09 absolute (``plain_rel_err``,
    ``plain_max_abs_err``). So per sequence, the relative (Frobenius)
    error of ``out`` may pass that of ``plain_out``, a second plain path,
    by at most DRIFT_TOL. Returns both errors, the largest absolute error
    and the share of positions with the same argmax."""
    err, floor = seq_rel_err(out, ref), seq_rel_err(plain_out, ref)
    if not torch.isfinite(out).all():
        _fail(f"{what}: non-finite logits")
    if err > floor + DRIFT_TOL:
        _fail(f"{what}: relative error {err} over the plain paths' {floor}"
              f" + {DRIFT_TOL}")
    return dict(rel_err=err, plain_rel_err=floor, rel_tolerance=DRIFT_TOL,
                max_abs_err=float((out.float() - ref.float()).abs().max()),
                plain_max_abs_err=float(
                    (plain_out.float() - ref.float()).abs().max()),
                argmax_agree=float((out.argmax(-1) == ref.argmax(-1))
                                   .float().mean()))


def paged_shape(q, kv, bt, ln):
    """The paged kernel at one shape: its error against the plain version,
    within TOL and, per sequence, within PAGED_REL_TOL, which the plain
    version with one chunk of keys dropped (the longest sequence's last 32,
    the smaller chunk of the two routes, or all its keys but one if it is
    shorter) must fail; kernel_ms, call_ms,
    plain_ms, the bound and, as a yardstick that the port never calls,
    dense SDPA on the same K/V already gathered into [B, KH, T, D] with a
    key mask (not the same function: the gather is not timed)."""
    B, H, D = q.shape
    P, page, _, KH, _ = kv.shape
    dtype = q.dtype
    lengths = [int(n) for n in ln]
    bt_d, ln_d = torch.as_tensor(bt, device=DEV), torch.as_tensor(ln, device=DEV)
    entry = dict(shape=f"B={B} H={H} KH={KH} D={D} page={page} "
                       f"{paged_kernel.ROUTES[dtype]} "
                       f"pool of {P} pages, lengths "
                       + (str(lengths) if B <= 4 else
                          f"{min(lengths)}-{max(lengths)} (sum "
                          f"{sum(lengths)})"),
                 tolerance=TOL[dtype], rel_tolerance=PAGED_REL_TOL[dtype])
    tokens = sum(lengths)                            # live K/V rows
    nbytes = (tokens * 2 * KH * D + 2 * q.numel()) * kv.element_size() \
        + bt.nbytes + ln.nbytes
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 4 * H * D * tokens,
                                                 dtype)
    got = paged_attention(q, kv, bt_d, ln_d, impl="kernel")
    torch.cuda.synchronize()
    ref = paged_attention(q, kv, bt_d, ln_d, impl="xla")
    entry["max_abs_err"] = close_or_fail(got, ref, TOL[dtype], f"paged "
                                         f"{entry['shape']}")
    entry["rel_err"] = seq_rel_err(got, ref)
    if entry["rel_err"] > PAGED_REL_TOL[dtype]:
        _fail(f"paged {entry['shape']}: a sequence's relative error "
              f"{entry['rel_err']} over {PAGED_REL_TOL[dtype]}")
    short = ln.copy()             # 32 keys: the fp32 route's chunk, half bf16's
    short[int(np.argmax(ln))] -= min(32, int(ln.max()) - 1)
    entry["dropped_chunk_rel_err"] = seq_rel_err(paged_attention(
        q, kv, bt_d, torch.as_tensor(short, device=DEV), impl="xla"), ref)
    if entry["dropped_chunk_rel_err"] <= PAGED_REL_TOL[dtype]:
        _fail(f"paged {entry['shape']}: the check passes a dropped chunk "
              f"({entry['dropped_chunk_rel_err']})")
    del got, ref

    def run():
        return paged_attention(q, kv, bt_d, ln_d, impl="kernel")

    entry["kernel_ms"] = entry["ms"] = time_ms(run)
    entry["call_ms"] = time_ms(run, spin=False)
    entry["plain_ms"] = time_ms(
        lambda: paged_attention(q, kv, bt_d, ln_d, impl="xla"),
        reps=5 if B > 4 else 20)
    # the yardstick: dense [B, KH, T, D] K and V, a key mask by length
    T = bt.shape[1] * page
    dense = kv[bt_d.clamp_min(0).long()]            # [B, pages, page, 2, KH, D]
    k = dense[..., 0, :, :].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    v = dense[..., 1, :, :].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    del dense
    mask = (torch.arange(T, device=DEV)[None, :] < ln_d[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry["yardstick"] = "dense SDPA, not the same function"
    entry["yardstick_ms"] = time_ms(
        lambda: sdpa(q4, k, v, attn_mask=mask, enable_gqa=True))
    return entry


def gla_inputs(rng, B, T, Dk, Dv, w0, dtype, rk_scale=1.0):
    """r, k, v, w (log decays <= 0), u as the reference's tests draw them,
    with the decays' scale set by ``w0``."""
    r = rand(rng, (B, T, Dk), torch.float32) * rk_scale
    k = rand(rng, (B, T, Dk), torch.float32) * rk_scale
    v = rand(rng, (B, T, Dv), torch.float32)
    w = -torch.exp(w0 + rand(rng, (B, T, Dk), torch.float32) * 0.5)
    u = rand(rng, (B, Dk), torch.float32)
    return [x.to(dtype) for x in (r, k, v, w, u)]


def gla_close(inputs, chunk, dtype, what):
    """Kernel against the chunked plain version: o and S_T. Returns the max
    abs error and the plain o."""
    route = scan_kernel.gla_route(dtype)
    before = gla_scan.launches_by_route[route]
    o, S = gla_scan(*inputs, impl="kernel", chunk=chunk)
    torch.cuda.synchronize()
    if gla_scan.launches_by_route[route] != before + 1:
        _fail(f"{what}: not on the {route} route")
    ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=chunk)
    if o.dtype != inputs[2].dtype or S.dtype != torch.float32:
        _fail(f"{what}: dtypes o {o.dtype}, S {S.dtype}")
    return max(close_or_fail(o, ro, GLA_TOL[dtype], f"{what} o"),
               close_or_fail(S, rS, GLA_TOL[dtype], f"{what} S")), ro


def rel_gap(out, exact):
    """The least tol for which ``out`` passes close_or_fail against
    ``exact``: max |out - exact| / (1 + |exact|)."""
    return float(((out.double() - exact).abs() / (1 + exact.abs())).max())


def gla_witness(inputs, chunk, what):
    """The kernel at unit-scale r and k, as the model feeds it: o reaches
    ~170 and its terms cancel, so no fixed tolerance is known a priori. The
    witness is the exact scan (``gla_scan_ref`` in fp64) and the gap to it
    of the chunked plain version, the same factorisation in fp32. In fp32
    (the FMA route) the kernel must come as close to the exact scan as twice
    that gap, in o and S. In bf16 (the tensor-core route, operands split in
    two bf16 parts) o, which is rounded to bf16, must come as close as twice
    the plain version's gap, and S within GLA's bf16 tolerance."""
    exact_o, exact_S = gla_scan_ref(*(x.double() for x in inputs))
    o, S = gla_scan(*inputs, impl="kernel", chunk=chunk)
    ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=chunk)
    torch.cuda.synchronize()
    reading = dict(route=scan_kernel.gla_route(inputs[0].dtype),
                   plain_vs_exact_o=rel_gap(ro, exact_o),
                   plain_vs_exact_S=rel_gap(rS, exact_S),
                   kernel_vs_exact_o=rel_gap(o, exact_o),
                   kernel_vs_exact_S=rel_gap(S, exact_S),
                   kernel_vs_plain=max(rel_gap(o, ro.double()),
                                       rel_gap(S, rS.double())),
                   exact_max_abs=float(exact_o.abs().max()))
    plain = max(reading["plain_vs_exact_o"], reading["plain_vs_exact_S"])
    if inputs[0].dtype == torch.float32:
        reading["tolerance"] = 2 * plain
        gaps = {"o and S": max(reading["kernel_vs_exact_o"],
                               reading["kernel_vs_exact_S"])}
        tols = {"o and S": reading["tolerance"]}
    else:
        reading["tolerance_o"] = 2 * reading["plain_vs_exact_o"]
        reading["tolerance_S"] = GLA_TOL[torch.bfloat16]
        gaps = {"o": reading["kernel_vs_exact_o"],
                "S": reading["kernel_vs_exact_S"]}
        tols = {"o": reading["tolerance_o"], "S": reading["tolerance_S"]}
    log("gla_witness", what, json.dumps(reading))
    if not (torch.isfinite(o).all() and torch.isfinite(S).all()):
        _fail(f"{what}: non-finite output")
    for key, gap in gaps.items():
        if gap > tols[key]:
            _fail(f"{what}: kernel {key} {gap} from the exact scan, over "
                  f"{tols[key]}")
    return max(gaps.values())


def gla_flops(B, T, D, chunk):
    """The chunked GLA forward's operations (Dk = Dv = D), products only."""
    strict = chunk * (chunk - 1) // 2        # A's strictly lower entries
    return B * (T // chunk) * (      # per (row, chunk):
        2 * chunk * D * D            # q_inter S
        + 2 * chunk * D * D          # the state update k_intra^T v
        + 2 * strict * D             # A = q_intra k_intra^T
        + 2 * strict * D             # A v
        + 5 * chunk * D)             # the bonus: sum r u k, times v


def check_gla(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in GLA_CASES:
            B, T, Dk, Dv, chunk, w0 = case
            err, _ = gla_close(gla_inputs(rng, B, T, Dk, Dv, w0, dtype), chunk,
                               dtype, f"gla {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # the served prefill: rwkv6-3b's 32 heads of 80 over 4 prompts of 512
    # tokens, chunk 64, the served decays (w0 = -2). In fp32 twice: with r and
    # k scaled by Dk^-1/2, so that o stays O(1), at the fixed tolerance; and
    # at unit scale against the exact scan, with the tolerance its witness
    # gives.
    B, T, D, chunk = 4 * 32, 512, 80, 64
    worst["slice fp32"], _ = gla_close(
        gla_inputs(rng, B, T, D, D, -2.0, torch.float32, rk_scale=D ** -0.5),
        chunk, torch.float32, "gla slice shape fp32")
    worst["slice fp32 unit scale, vs exact"] = gla_witness(
        gla_inputs(rng, B, T, D, D, -2.0, torch.float32), chunk,
        "slice shape fp32 unit scale")
    dtype = torch.bfloat16
    inputs = gla_inputs(rng, B, T, D, D, -2.0, dtype)
    err, ro = gla_close(inputs, chunk, dtype, "gla slice shape bf16")
    worst["slice bf16 unit scale, vs exact"] = gla_witness(
        inputs, chunk, "slice shape bf16 unit scale")

    def run():
        return gla_scan(*inputs, impl="kernel", chunk=chunk)

    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: gla_scan(*inputs, impl="xla_chunked",
                                        chunk=chunk))
    tv = scan_kernel.mma_dv_tile(B, D, D, chunk, torch.cuda
                                 .get_device_properties(0).multi_processor_count)
    lib = scan_kernel._lib()
    flops = gla_flops(B, T, D, chunk)
    nbytes = (sum(x.numel() for x in inputs) + B * T * D) \
        * inputs[0].element_size() + B * D * D * 4          # + o, S_T
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log("gla_work", json.dumps(dict(
        flops=flops, bytes=nbytes,
        fp32_fma_floor_ms=flops / PEAK_FLOPS[torch.float32] * 1e3)))
    return dict(name="gla_scan", route="cuda",
                source="src/repro_torch/csrc/linear_scan.cu",
                replaces="src/repro/kernels/linear_scan/kernel.py:134",
                shape=f"B*H={B} T={T} Dk=Dv={D} chunk={chunk} bf16",
                kernel_route=scan_kernel.gla_route(dtype),
                tiles=dict(dv_tile=tv, blocks=B * -(-D // tv),
                           smem_bytes=lib.gla_scan_mma_smem(chunk, D, tv)),
                max_abs_err=err, tolerance=GLA_TOL[dtype],
                ref_max_abs=float(ro.float().abs().max()),
                cases_max_abs_err=worst, ms=kernel_ms, kernel_ms=kernel_ms,
                call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def diag_inputs(rng, B, T, D, dtype, near_one=False):
    """a in (0, 1) and b as the reference's tests draw them, and an fp32
    h0. ``near_one``: a = exp(-U(0, 0.02)) instead, as RG-LRU's a is where
    its gate r is small, so that a 256-step segment's product of a's stays
    near 0.08 and the carry across segments decides the output."""
    if near_one:
        a = torch.exp(-0.02 * torch.from_numpy(rng.uniform(size=(B, T, D))))
        a = a.to(DEV, dtype)
    else:
        a = torch.sigmoid(rand(rng, (B, T, D), torch.float32)).to(dtype)
    return a, rand(rng, (B, T, D), dtype), rand(rng, (B, D), torch.float32)


def diag_close(a, b, h0, chunk, dtype, what):
    """Kernel against the sequential oracle: h and h_T, their dtypes, the
    route the launch took, and their bits: both routes walk each channel in
    order and round the multiply and the add apart, as the oracle does, so
    any difference fails."""
    route = scan_kernel.diag_route(a.shape[1])
    before = diag_scan.launches_by_route[route]
    h, hT = diag_scan(a, b, h0, impl="kernel", chunk=chunk)
    torch.cuda.synchronize()
    if diag_scan.launches_by_route[route] != before + 1:
        _fail(f"{what}: not on the {route} route")
    rh, rT = diag_scan(a, b, h0, impl="xla")
    if h.dtype != a.dtype or hT.dtype != a.dtype:
        _fail(f"{what}: dtypes h {h.dtype}, h_T {hT.dtype}")
    err = max(close_or_fail(h, rh, TOL[dtype], f"{what} h"),
              close_or_fail(hT, rT, TOL[dtype], f"{what} h_T"))
    if not (torch.equal(h, rh) and torch.equal(hT, rT)):
        _fail(f"{what}: the {route} route's bits differ from the plain "
              f"version's (max abs err {err})")
    return err


def check_diag(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in DIAG_CASES:
            B, T, D, chunk = case
            a, b, h0 = diag_inputs(rng, B, T, D, dtype)
            # h0 in both dtypes, each read as it is (T = 1 included: the
            # step route's bits with an fp32 and a bf16 h0)
            for init in (None, h0, h0.bfloat16()):
                err = diag_close(a, b, init, chunk, dtype,
                                 f"diag {case} {dtype} h0 "
                                 f"{None if init is None else init.dtype}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # the served path: recurrentgemma-9b's 4 prompts of 2100 tokens over
    # d_model = 4096 channels, in bf16 (the 24 superblock layers) and in
    # fp32 (the 2 rem layers, whose fp32 vectors promote), from the cache's
    # bf16 zero state; and one decode step (T = 1) from a state
    B, T, D = 4, 2100, 4096
    zero = torch.zeros((B, D), dtype=torch.bfloat16, device=DEV)
    # at the served width with a near 1: with sigmoid draws the product of
    # a's over a few hundred steps underflows to 0, and a kernel that lost
    # the carry from one stage of its ring to the next would still agree
    for dtype in (torch.float32, torch.bfloat16):
        a, b, h0 = diag_inputs(rng, B, T, D, dtype, near_one=True)
        worst[f"T={T} near one {dtype}"] = diag_close(
            a, b, h0, 256, dtype, f"diag served T={T} a near one {dtype}")
        del a, b
    served = {}
    work = {}
    for dtype, T_ in ((torch.bfloat16, T), (torch.float32, T),
                      (torch.bfloat16, 1), (torch.float32, 1)):
        a, b, _ = diag_inputs(rng, B, T_, D, dtype)
        init = zero if T_ > 1 else rand(rng, (B, D), dtype)
        err = diag_close(a, b, init, 256, dtype, f"diag served T={T_} {dtype}")

        def run():
            return diag_scan(a, b, init, impl="kernel")

        # a, b read and h written; h0 read and h_T written
        nbytes = 3 * a.numel() * a.element_size() \
            + B * D * (init.element_size() + a.element_size())
        bound_ms, bound_by = bound(nbytes, 2 * a.numel(), dtype)
        work[f"T={T_} {dtype}"] = dict(flops=2 * a.numel(), bytes=nbytes)
        served[f"T={T_} {dtype}"] = dict(
            kernel_route=scan_kernel.diag_route(T_),
            plan=scan_kernel.diag_plan_built(B, T_, D, dtype),
            h0_dtype=str(init.dtype), bits_equal_plain=True,
            max_abs_err=err, ms=time_ms(run), call_ms=time_ms(run, spin=False),
            plain_ms=time_ms(lambda: diag_scan(a, b, init, impl="xla"),
                             reps=5 if T_ > 1 else 20),
            bound_ms=bound_ms, bound_by=bound_by)
    # the floor of this timing for one launch: the step kernel on 8
    # channels, next to nothing to move (its own generator, so that the
    # later kernels' inputs stay those of the earlier slices)
    frng = np.random.default_rng(16)
    a, b, _ = diag_inputs(frng, 1, 1, 8, torch.bfloat16)
    init = rand(frng, (1, 8), torch.bfloat16)
    served[f"T=1 {torch.bfloat16}"]["launch_floor_ms"] = time_ms(
        lambda: diag_scan(a, b, init, impl="kernel"))
    log("diag_work", json.dumps(work))
    top = served[f"T={T} {torch.bfloat16}"]
    return dict(name="diag_scan", route="cuda",
                source="src/repro_torch/csrc/diag_scan.cu",
                replaces="src/repro/kernels/linear_scan/kernel.py:49",
                shape=f"B={B} T={T} D={D} bf16, h0 bf16 zeros",
                tolerance=TOL[torch.bfloat16], cases_max_abs_err=worst,
                kernel_ms=top["ms"], library_ms=None, served=served,
                **{k: top[k] for k in ("max_abs_err", "ms", "call_ms",
                                       "plain_ms", "bound_ms", "bound_by")})


# the diagonal scan's backward: T = 1, ragged widths, a T off the ring's
# stages; recurrentgemma-9b's training shape (4 x 512 tokens, d_model 4096)
DIAG_BWD_CASES = [  # B, T, D
    (2, 1, 16),
    (2, 37, 16),
    (2, 77, 33),
    (1, 100, 8),
]
HYBRID_TRAIN = (4, 512, 4096)
# rwkv6-3b's training shape: 8 x 512 tokens, 32 heads of 80 (B*H = 256),
# its wkv chunked at ``blocks.TRAIN_GLA_CHUNK`` (16) under grad
RWKV_TRAIN = (8 * 32, 512, 80)
# rows of the GLA's fp64 oracle (each row's scan is independent of the rest)
GLA_ORACLE_ROWS = 32


def diag_bwd_close(a, b, g, h0, gT, what):
    """The backward kernel against ``diag_scan_bwd_ref`` on the forward
    kernel's own h: da, db and dh0 bit for bit (both walk each channel from
    the last step down and round the multiply and the add apart). Returns
    (max abs err, h, h_{t-1})."""
    h, _ = scan_kernel.diag_scan_kernel(a, b, h0)
    da, db, dh0 = scan_kernel.diag_scan_bwd_kernel(a, h, g, h0, gT)
    torch.cuda.synchronize()
    first = (torch.zeros_like(h[:, 0], dtype=torch.float32) if h0 is None
             else h0.float())
    h_prev = torch.cat([first[:, None], h[:, :-1].float()], dim=1)
    ra, rb, r0 = diag_scan_bwd_ref(a, h_prev, g, gT)
    err = max(close_or_fail(da, ra, TOL[a.dtype], f"{what} da"),
              close_or_fail(db, rb, TOL[a.dtype], f"{what} db"))
    same = torch.equal(da, ra) and torch.equal(db, rb)
    if h0 is None:
        if dh0 is not None:
            _fail(f"{what}: a dh0 without h0")
    else:
        err = max(err, close_or_fail(dh0, r0, TOL[torch.float32],
                                     f"{what} dh0"))
        same = same and dh0.dtype == torch.float32 and torch.equal(dh0, r0)
    if not same:
        _fail(f"{what}: the backward's bits differ from the plain version's "
              f"(max abs err {err})")
    return err, h, h_prev


def check_diag_bwd(rng):
    """The diagonal scan's backward kernel (no TPU kernel's counterpart: the
    JAX package takes this gradient by autodiff of its sequential scan)
    against its plain version, bit for bit, and timed at recurrentgemma-9b's
    training shape in bf16 (the superblock's layers) and fp32 (the ``rem``
    layers) beside its bound and the plain version."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in DIAG_BWD_CASES:
            B, T, D = case
            a, b, h0 = diag_inputs(rng, B, T, D, dtype)
            g, gT = rand(rng, (B, T, D), dtype), rand(rng, (B, D), dtype)
            for init, cot in ((None, None), (h0, gT), (h0.bfloat16(), None)):
                err, _, _ = diag_bwd_close(
                    a, b, g, init, cot, f"diag bwd {case} {dtype} h0 "
                    f"{None if init is None else init.dtype} gT "
                    f"{cot is not None}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    B, T, D = HYBRID_TRAIN
    served = {}
    for dtype in (torch.bfloat16, torch.float32):
        a, b, _ = diag_inputs(rng, B, T, D, dtype, near_one=True)
        g = rand(rng, (B, T, D), dtype)
        err, h, h_prev = diag_bwd_close(a, b, g, None, None,
                                        f"diag bwd training shape {dtype}")
        # a, g and h read, da and db written; an add and two multiplies
        nbytes = 5 * a.numel() * a.element_size()
        bound_ms, bound_by = bound(nbytes, 3 * a.numel(), dtype)

        def run():
            return scan_kernel.diag_scan_bwd_kernel(a, h, g)

        served[str(dtype)] = dict(
            plan=scan_kernel.diag_bwd_plan_built(B, T, D, dtype),
            bits_equal_plain=True, max_abs_err=err, ms=time_ms(run),
            call_ms=time_ms(run, spin=False),
            plain_ms=time_ms(lambda: diag_scan_bwd_ref(a, h_prev, g), reps=3),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            flops=3 * a.numel())
        del a, b, g, h, h_prev
    top = served[str(torch.bfloat16)]
    return dict(name="diag_scan_bwd", route="cuda",
                source="src/repro_torch/csrc/diag_scan.cu",
                replaces="src/repro/kernels/linear_scan/kernel.py:49",
                replaces_note="no Pallas kernel: the gradient of that "
                "kernel's scan, which the JAX package takes by autodiff of "
                "its sequential scan (linear_scan/ref.py diag_scan_ref)",
                shape=f"B={B} T={T} D={D} bf16, no h0 (training)",
                tolerance="bits", cases_max_abs_err=worst,
                kernel_ms=top["ms"], library_ms=None, served=served,
                **{k: top[k] for k in ("max_abs_err", "ms", "call_ms",
                                       "plain_ms", "bound_ms", "bound_by")})


def check_scan_train(rng):
    """The recurrent families' training path through the scans' autograd
    Functions at their training shapes. ``_GLAScan`` at rwkv6-3b's, chunk
    ``TRAIN_GLA_CHUNK``: the kernel's o and S_T (the forward under grad,
    on the fp32 FMA route whatever the dtype) against the chunked plain
    version at GLA_TOL, and in bf16 at unit-scale r and k against the
    exact scan, as close as twice the plain version; its dr, dk, dv, dw,
    du, which come from the plain
    backward by recompute and not from the kernel, against fp64 autograd
    of the sequential scan on the first ``GLA_ORACLE_ROWS`` rows.
    ``_DiagScan``'s da, db (both kernels) at recurrentgemma-9b's against
    fp64 autograd of the plain version. Gradients at 3e-4 fp32 and 2e-2
    bf16; one launch (or backward call) each; and the GLA's plain backward
    timed in bf16 beside its bound and the forward kernel."""
    errs = {}
    R, T, D = RWKV_TRAIN
    n = GLA_ORACLE_ROWS
    for dtype in (torch.float32, torch.bfloat16):
        # r and k scaled by D^-1/2, so that o stays O(1), as in check_gla
        inputs = gla_inputs(rng, R, T, D, D, -2.0, dtype, rk_scale=D ** -0.5)
        go = rand(rng, (R, T, D), dtype)
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        before = gla_scan.launches_by_route["fma"], gla_scan.bwd_calls
        o, S = gla_scan(*leaves, impl="kernel", chunk=TRAIN_GLA_CHUNK)
        torch.autograd.backward(o, go)
        torch.cuda.synchronize()
        if (gla_scan.launches_by_route["fma"], gla_scan.bwd_calls) != (
                before[0] + 1, before[1] + 1) or o.dtype != dtype:
            _fail(f"scan_train gla {dtype}: not one fma launch and one "
                  f"plain backward, or o in {o.dtype}")
        ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=TRAIN_GLA_CHUNK)
        errs[f"gla forward {dtype}"] = max(
            close_or_fail(o.detach(), ro, GLA_TOL[dtype],
                          f"scan_train gla o {dtype}"),
            close_or_fail(S, rS, GLA_TOL[dtype], f"scan_train gla S {dtype}"))
        del ro, rS, S
        ref = [x[:n].double().requires_grad_(True) for x in inputs]
        ro, _ = gla_scan_ref(*ref)
        torch.autograd.backward(ro, go[:n].double())
        errs[f"gla {dtype}"] = max(
            close_or_fail(t.grad[:n], r.grad, GRAD_TOL[dtype],
                          f"scan_train gla d{name} {dtype}")
            for t, r, name in zip(leaves, ref, "rkvwu"))
        del leaves, ref, o, ro
    gla_in, gla_go = inputs, go
    # unit-scale r and k, as the model feeds the wkv: the Function's o
    # (bf16) as close to the exact scan as twice the chunked plain version
    unit = gla_inputs(rng, R, T, D, D, -2.0, torch.bfloat16)
    exact_o, _ = gla_scan_ref(*(x.double() for x in unit))
    o, _ = gla_scan(*(x.clone().requires_grad_(True) for x in unit),
                    impl="kernel", chunk=TRAIN_GLA_CHUNK)
    po, _ = gla_scan(*unit, impl="xla_chunked", chunk=TRAIN_GLA_CHUNK)
    gap, plain_gap = rel_gap(o.detach(), exact_o), rel_gap(po, exact_o)
    if not gap <= 2 * plain_gap:
        _fail(f"scan_train gla bf16 unit scale: o {gap} from the exact "
              f"scan, over twice the plain version's {plain_gap}")
    errs["gla forward bf16 unit scale, vs exact"] = gap
    errs["gla forward bf16 unit scale, plain vs exact"] = plain_gap
    del unit, exact_o, o, po
    B, Td, Dd = HYBRID_TRAIN
    for dtype in (torch.float32, torch.bfloat16):
        a, b, _ = diag_inputs(rng, B, Td, Dd, dtype, near_one=True)
        g = rand(rng, (B, Td, Dd), dtype)
        leaves = [x.clone().requires_grad_(True) for x in (a, b)]
        before = diag_scan.launches_by_route["ring"], diag_scan.bwd_launches
        h, _ = diag_scan(*leaves, impl="kernel")
        torch.autograd.backward(h, g)
        torch.cuda.synchronize()
        if (diag_scan.launches_by_route["ring"], diag_scan.bwd_launches) != (
                before[0] + 1, before[1] + 1):
            _fail(f"scan_train diag {dtype}: not one ring launch and one "
                  f"backward launch")
        ref = [x.double().requires_grad_(True) for x in (a, b)]
        rh, _ = diag_scan_ref(*ref)
        torch.autograd.backward(rh, g.double())
        errs[f"diag {dtype}"] = max(
            close_or_fail(t.grad, r.grad, GRAD_TOL[dtype],
                          f"scan_train diag d{name} {dtype}")
            for t, r, name in zip(leaves, ref, "ab"))
        del a, b, g, leaves, ref, h, rh

    def gla_bwd():
        xs = [x.detach().requires_grad_(True) for x in gla_in]
        o, _ = _gla_chunked(*xs, chunk=TRAIN_GLA_CHUNK)
        return torch.autograd.grad(o, xs, gla_go)

    train_leaves = [x.detach().requires_grad_(True) for x in gla_in]
    elem = gla_in[0].element_size()
    # read r, k, v, w, u and the cotangent of o; write dr, dk, dv, dw, du;
    # the recompute and the two products of the backward for each forward one
    nbytes = (5 * R * T * D + R * D) * elem + (4 * R * T * D + R * D) * elem
    flops = 3 * gla_flops(R, T, D, TRAIN_GLA_CHUNK)
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    return dict(grads_max_abs_err=errs,
                grads_tolerance={names[d]: t for d, t in GRAD_TOL.items()},
                gla_shape=f"B*H={R} T={T} Dk=Dv={D} chunk={TRAIN_GLA_CHUNK}",
                diag_shape=f"B={B} T={Td} D={Dd}",
                gla_oracle_rows=n,
                # the training forward (the fp32 casts and the fma
                # route) and, for comparison, the served route (mma)
                gla_forward_kernel_ms=time_ms(lambda: gla_scan(
                    *train_leaves, impl="kernel", chunk=TRAIN_GLA_CHUNK)),
                gla_forward_mma_ms=time_ms(lambda: gla_scan(
                    *gla_in, impl="kernel", chunk=TRAIN_GLA_CHUNK)),
                gla_backward_plain_ms=time_ms(gla_bwd, reps=5),
                gla_backward_bound_ms=bound_ms,
                gla_backward_bound_by=bound_by, gla_backward_bytes=nbytes,
                gla_backward_flops=flops)


def shuffle_inputs(rng, T, D, E, K, C, kind, dtype):
    """x [T, D], y [E, C, D] and fp32 gates [T, K] on the card, and int32
    expert ids and slots [T, K]. ``kind``: "slots" (K distinct experts a
    token, slots from ``compute_slots``, some past C), "drops" (as "slots",
    then ids of -1 and E and slots of -1 and C + 3 here and there) or
    "repeats" (ids and slots drawn at random: pairs share rows and sum)."""
    x, y = rand(rng, (T, D), dtype), rand(rng, (E, C, D), dtype)
    gates = torch.from_numpy(rng.random((T, K))).to(DEV, torch.float32)
    if kind == "repeats":
        eid = rng.integers(0, E, size=(T, K))
        slot = rng.integers(0, C, size=(T, K))
    else:
        eid = np.argsort(rng.random((T, E)), axis=1)[:, :K]
        slot = compute_slots(torch.from_numpy(eid), E, C).numpy()
        if kind == "drops":
            u, v = rng.random((T, K)), rng.random((T, K))
            eid = np.where(u < 0.1, -1, np.where(u < 0.15, E, eid))
            slot = np.where(v < 0.05, -1, np.where(v < 0.1, C + 3, slot))
    ids = [torch.from_numpy(a.astype(np.int32)).to(DEV) for a in (eid, slot)]
    return x, y, gates, ids[0], ids[1]


def shuffle_close(x, y, gates, eid, slot, E, C, what):
    """dispatch and combine (gates in fp32 and in the data's dtype) against
    their plain versions. Returns the max abs errors."""
    dtype = x.dtype
    out = dispatch(x, eid, slot, E, C, impl="kernel")
    torch.cuda.synchronize()
    if out.dtype != dtype:
        _fail(f"dispatch {what}: dtype {out.dtype}")
    d_err = close_or_fail(out, dispatch(x, eid, slot, E, C, impl="xla"),
                          SHUFFLE_TOL[dtype], f"dispatch {what}")
    c_err = 0.0
    for g in {gates, gates.to(dtype)}:
        out = combine(y, eid, slot, g, x.shape[0], impl="kernel")
        torch.cuda.synchronize()
        if out.dtype != dtype:
            _fail(f"combine {what}: dtype {out.dtype}")
        c_err = max(c_err, close_or_fail(
            out, combine(y, eid, slot, g, x.shape[0], impl="xla"),
            SHUFFLE_TOL[dtype], f"combine {what} gates {g.dtype}"))
    return d_err, c_err


def served_routing(rng, B, T, E, K, C):
    """grok-1-314b's routing as the MoE block hands it to the kernels: K
    distinct experts of E a token, row b's ids offset by b * E, slots over
    the B * E buffers from ``compute_slots``."""
    eid = np.argsort(rng.random((B, T, E)), axis=2)[..., :K]
    flat = torch.from_numpy(eid + E * np.arange(B)[:, None, None]).reshape(
        B * T, K)
    slot = compute_slots(flat, B * E, C)
    return flat.int().to(DEV), slot.to(DEV)


def gather_or_fail(x, eid, slot, R, C, what):
    """Under served routing every kept pair has a row of its own: dispatch
    must be the gather of the kept tokens' x at their rows, bit for bit,
    and 0.0 in every other row."""
    out = dispatch(x, eid, slot, R, C, impl="kernel")
    kept = (slot >= 0) & (slot < C)
    rows = (eid.long() * C + slot.long())[kept]
    if torch.unique(rows).numel() != rows.numel():
        _fail(f"dispatch {what}: served rows are not unique")
    expect = torch.zeros((R * C, x.shape[1]), dtype=x.dtype, device=DEV)
    expect[rows] = x.index_select(0, torch.nonzero(kept)[:, 0])
    if not torch.equal(out.reshape(R * C, -1), expect):
        _fail(f"dispatch {what}: not the gather of the kept tokens")


def in_token_order(x, eid, slot, E, C):
    """Each row's fp32 sum of x over its pairs, one after another in pair
    (so token) order as numpy's cumsum takes them, in x's dtype [E, C, D]."""
    xs = x.float().cpu().numpy()
    e = eid.reshape(-1).cpu().numpy()
    rows = e * C + slot.reshape(-1).cpu().numpy()
    out = np.zeros((E * C, xs.shape[1]), np.float32)
    for row in np.unique(rows):
        toks = np.nonzero(rows == row)[0] // eid.shape[1]
        out[row] = np.cumsum(xs[toks], axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(out.reshape(E, C, -1)).to(DEV, x.dtype)


def check_overflow(rng, dtype):
    """OVERFLOW_CASES on the walk route: bits equal the sequential sum in
    token order (normal draws), and the plain version within the reference's
    tolerance where x holds small integers (every fp32 partial sum exact,
    so any summation order gives the same value). Returns the max abs
    errors against the plain version."""
    errs = {}
    for kind, T, D, E, K, C in OVERFLOW_CASES:
        if kind == "one row":
            eid = torch.zeros((T, K), dtype=torch.int32, device=DEV)
            slot = eid.clone()
        else:
            eid, slot = (torch.from_numpy(rng.integers(0, n, size=(T, K))
                                          .astype(np.int32)).to(DEV)
                         for n in (E, C))
        if shuffle_kernel.dispatch_route(T * K) != "walk":
            _fail(f"overflow {kind}: not on the walk route")
        x = rand(rng, (T, D), dtype)
        out = dispatch(x, eid, slot, E, C, impl="kernel")
        if not torch.equal(out, in_token_order(x, eid, slot, E, C)):
            _fail(f"dispatch overflow {kind} {dtype}: not the sum in token "
                  f"order")
        xi = torch.from_numpy(rng.integers(-8, 9, size=(T, D))).to(DEV, dtype)
        errs[f"overflow {kind} {dtype}"] = close_or_fail(
            dispatch(xi, eid, slot, E, C, impl="kernel"),
            dispatch(xi, eid, slot, E, C, impl="xla"), SHUFFLE_TOL[dtype],
            f"dispatch overflow {kind} {dtype}")
    return errs


def note(worst, key, errs):
    """Keeps dispatch's and combine's worst errors ``errs`` by ``key``."""
    for name, err in zip(("dispatch", "combine"), errs):
        worst[name][key] = max(worst[name].get(key, 0.0), err)


def check_shuffle(rng):
    """The dispatch and combine kernels against their plain versions (and
    dispatch past its hit list), then at grok-1-314b's served prefill (4
    rows x 512 tokens, top-2 of 8 experts, C = 160, D = 6144, bf16) and
    decode (T = 1, C = 4): dispatch bit for bit the gather of the kept
    tokens, and timed."""
    worst = {"dispatch": {}, "combine": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SHUFFLE_CASES:
            for kind in ("slots", "drops", "repeats"):
                T, D, E, K, C = case
                note(worst, f"{kind} {dtype}", shuffle_close(
                    *shuffle_inputs(rng, T, D, E, K, C, kind, dtype), E, C,
                    f"{case} {kind} {dtype}"))
    # the reference's round trip: K = 1, no drops, gate 1 gives x back
    T, D, E, C = 32, 8, 4, 32
    x = rand(rng, (T, D), torch.float32)
    eid = torch.from_numpy(rng.integers(0, E, size=(T, 1))).to(DEV)
    slot = compute_slots(eid, E, C)
    back = combine(dispatch(x, eid, slot, E, C, impl="kernel"), eid, slot,
                   torch.ones((T, 1), device=DEV), T, impl="kernel")
    torch.cuda.synchronize()
    worst["combine"]["round trip"] = close_or_fail(back, x, 1e-6, "round trip")
    for dtype in (torch.float32, torch.bfloat16):
        worst["dispatch"].update(check_overflow(rng, dtype))
    B, E, K, D = 4, 8, 2, 6144
    entries = {"dispatch": {}, "combine": {}}
    work = {}
    for T, C in ((512, 160), (1, 4)):
        served_shuffle(rng, B, T, E, K, C, D, f"T={T}", worst, entries, work)
    # where dispatch's time goes: the prefill's routing at D = 8 (the same
    # grid and walk, one 16-byte piece a row: walk_ms), and a launch with
    # next to nothing to move (the direct route on one row of 8:
    # launch_floor_ms). Their own generator, so that the later phases'
    # inputs stay those of the earlier slices
    frng = np.random.default_rng(17)
    eid, slot = served_routing(frng, B, 512, E, K, 160)
    x8 = rand(frng, (B * 512, 8), torch.bfloat16)
    entries["dispatch"]["T=512"]["walk_ms"] = time_ms(
        lambda: dispatch(x8, eid, slot, B * E, 160, impl="kernel"))
    one = torch.zeros((1, 1), dtype=torch.int32, device=DEV)
    x1 = rand(frng, (1, 8), torch.bfloat16)
    entries["dispatch"]["T=1"]["launch_floor_ms"] = time_ms(
        lambda: dispatch(x1, one, one, 1, 1, impl="kernel"))
    log("shuffle_work", json.dumps(work))
    out = []
    for name, line in (("dispatch", 51), ("combine", 105)):
        top = entries[name]["T=512"]
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/shuffle_dispatch.cu",
            replaces=f"src/repro/kernels/shuffle_dispatch/kernel.py:{line}",
            shape=f"N={B}x512 tokens K={K} buffers={B}x{E} C=160 D={D} bf16",
            tolerance=SHUFFLE_TOL[torch.bfloat16],
            cases_max_abs_err=worst[name], kernel_ms=top["ms"],
            served=entries[name], **top))
    return out


def served_shuffle(rng, B, T, E, K, C, D, key, worst, entries, work):
    """dispatch and combine at one served MoE shape (B rows of T tokens,
    top-K of E experts a row, capacity C, width D): against their plain
    versions in fp32 and bf16 (errors into ``worst``), dispatch bit for bit
    the gather of the kept tokens, then timed in bf16 beside the bound, the
    plain version and a library call that computes the same function; into
    ``entries[name][key]`` and ``work[key]``."""
    eid, slot = served_routing(rng, B, T, E, K, C)
    N, R = B * T, B * E
    for dtype in (torch.float32, torch.bfloat16):
        x, y = rand(rng, (N, D), dtype), rand(rng, (R, C, D), dtype)
        gates = torch.from_numpy(rng.random((N, K))).to(DEV, dtype)
        note(worst, f"served {key} {dtype}", shuffle_close(
            x, y, gates.float(), eid, slot, R, C, f"served {key} {dtype}"))
        gather_or_fail(x, eid, slot, R, C, f"served {key} {dtype}")
    # timed in bf16, the served dtype, with bf16 gates as the MoE block
    # passes them
    kept = (slot >= 0) & (slot < C)
    tok = torch.nonzero(kept)[:, 0]
    rows = (eid.long() * C + slot.long())[kept]
    sel = torch.unique(rows)
    elem = x.element_size()
    ids = 2 * eid.numel() * 4
    n_kept = int(kept.sum())
    d_bytes = (int(torch.unique(tok).numel()) + R * C) * D * elem + ids
    c_bytes = (int(sel.numel()) + N) * D * elem + ids \
        + gates.numel() * elem
    work[key] = dict(
        tokens=N, buffers=R, capacity=C, kept_pairs=n_kept,
        dispatch_bytes=d_bytes, dispatch_flops=n_kept * D,
        combine_bytes=c_bytes, combine_flops=2 * n_kept * D)
    mg = torch.zeros((N, R * C), dtype=dtype, device=DEV)
    mg.index_put_((tok, rows), gates[kept], accumulate=True)
    mg = mg.reshape(N, R, C)
    flat_x = torch.zeros((R * C, D), dtype=dtype, device=DEV)
    runs = {
        "dispatch": (lambda: dispatch(x, eid, slot, R, C, impl="kernel"),
                     lambda: dispatch(x, eid, slot, R, C, impl="xla"),
                     lambda: flat_x.zero_().index_add_(
                         0, rows, x.index_select(0, tok)),
                     d_bytes, n_kept * D),
        "combine": (lambda: combine(y, eid, slot, gates, N, impl="kernel"),
                    lambda: combine(y, eid, slot, gates, N, impl="xla"),
                    lambda: torch.einsum("tec,ecd->td", mg, y),
                    c_bytes, 2 * n_kept * D),
    }
    for name, (kern, plain, lib, nbytes, flops) in runs.items():
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        entries[name][key] = dict(
            max_abs_err=worst[name][f"served {key} {dtype}"],
            ms=time_ms(kern), call_ms=time_ms(kern, spin=False),
            plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib),
            bound_ms=bound_ms, bound_by=bound_by)
    entries["dispatch"][key]["kernel_route"] = \
        shuffle_kernel.dispatch_route(N * K)


def check_shuffle_deepseek(rng):
    """dispatch and combine at deepseek-v2-lite-16b's served prefill (4 rows
    x 512 tokens, top-6 of 64 experts, C = 60, D = 2048: 12288 pairs over
    256 buffers) and decode (T = 1, C = 4: 24 pairs), as
    ``served_shuffle``; fails unless the prefill takes dispatch's walk route
    and the decode its direct route. Returns (entries, worst, work)."""
    cfg = get_config("deepseek-v2-lite-16b")
    worst = {"dispatch": {}, "combine": {}}
    entries = {"dispatch": {}, "combine": {}}
    work = {}
    B, E, K, D = 4, cfg.n_experts, cfg.top_k, cfg.d_model
    for T, route in ((512, "walk"), (1, "direct")):
        key = f"{cfg.name} T={T}"
        served_shuffle(rng, B, T, E, K, _capacity(cfg, T), D, key, worst,
                       entries, work)
        if entries["dispatch"][key]["kernel_route"] != route:
            _fail(f"dispatch {key}: route "
                  f"{entries['dispatch'][key]['kernel_route']}, not {route}")
    # the prefill's routing at D = 8: the same grid and walk over its 12288
    # pairs' ids, one 16-byte piece a row (walk_ms, as grok's)
    eid, slot = served_routing(rng, B, 512, E, K, _capacity(cfg, 512))
    x8 = rand(rng, (B * 512, 8), torch.bfloat16)
    entries["dispatch"][f"{cfg.name} T=512"]["walk_ms"] = time_ms(
        lambda: dispatch(x8, eid, slot, B * E, _capacity(cfg, 512),
                         impl="kernel"))
    return entries, worst, work


def moe_grads_close(x, y, gates, eid, slot, R, C, wd, wc, what):
    """``_Dispatch`` and ``_Combine`` on the kernels (each one's backward a
    launch of the other's kernel, dgates plain) against
    ``dispatch_bwd_ref`` / ``combine_bwd_ref`` on the same cotangents, at
    SHUFFLE_TOL; fails unless each Function made exactly one forward and
    one backward launch, dispatch's both on the walk. Returns the max abs
    error."""
    dtype = x.dtype
    leaves = [t.clone().requires_grad_(True) for t in (x, y, gates)]
    counts = (dispatch.launches_by_route["walk"], combine.launches,
              dispatch.bwd_launches, combine.bwd_launches, combine.bwd_calls)
    buf = dispatch(leaves[0], eid, slot, R, C, impl="kernel")
    out = combine(leaves[1], eid, slot, leaves[2], x.shape[0], impl="kernel")
    torch.autograd.backward([buf, out], [wd, wc])
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(
        (dispatch.launches_by_route["walk"], combine.launches,
         dispatch.bwd_launches, combine.bwd_launches, combine.bwd_calls),
        counts)]
    if moved != [2, 2, 1, 1, 1]:
        _fail(f"moe_train {what}: launches (walk, combine, dispatch bwd, "
              f"combine bwd, dgates calls) moved by {moved}, not "
              f"[2, 2, 1, 1, 1]")
    want = (dispatch_bwd_ref(wd, eid, slot),
            *combine_bwd_ref(wc, y, eid, slot, gates))
    err = 0.0
    for t, w, name in zip(leaves, want, ("dx", "dy", "dgates")):
        if t.grad.dtype != dtype:
            _fail(f"moe_train {what} {name}: dtype {t.grad.dtype}")
        err = max(err, close_or_fail(t.grad, w, SHUFFLE_TOL[dtype],
                                     f"moe_train {what} {name}"))
    return err


def check_moe_train(rng):
    """The MoE backward at deepseek-v2-lite-16b's training shape (8 rows of
    512 tokens, top-6 of 64 experts a row: N = 4096 tokens, 24576 pairs,
    512 buffers of C = 60, D = 2048): both Functions' gradients on the
    kernels against the plain backwards in fp32 and bf16, then, in bf16,
    the device ms of dispatch's forward (the walk over 24576 pairs), of
    combine as dispatch's backward (K = 6, unit gates), of dispatch as
    combine's backward (24576 rows of one pair, K = 1; the rows' build
    timed apart) and of the plain dgates, each beside its byte bound, its
    plain version and a library call (``index_add_`` and the gated-mask
    einsum, as the serving rows; none for dgates). A ``moe_train`` line."""
    cfg = get_config("deepseek-v2-lite-16b")
    B, T, E, K, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_experts, cfg.top_k, \
        cfg.d_model
    C = _capacity(cfg, T)
    eid, slot = served_routing(rng, B, T, E, K, C)
    N, R = B * T, B * E
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, y = rand(rng, (N, D), dtype), rand(rng, (R, C, D), dtype)
        gates = torch.from_numpy(rng.random((N, K))).to(DEV, dtype)
        # combine's cotangent at D^-1/2, so that dgates (a dot over D =
        # 2048) stays O(1): at unit scale two fp32 sums of its 2048 terms
        # differ by more than 1e-5 where they cancel
        wd = rand(rng, (R, C, D), dtype)
        wc = (rand(rng, (N, D), torch.float32) * D ** -0.5).to(dtype)
        errs[str(dtype)] = moe_grads_close(x, y, gates, eid, slot, R, C,
                                           wd, wc, str(dtype))
        if dtype == torch.float32:
            del x, y, gates, wd, wc
    kept = (slot >= 0) & (slot < C)
    tok, kk = torch.nonzero(kept, as_tuple=True)
    rows = (eid.long() * C + slot.long())[tok, kk]
    n_kept, elem, ids = int(kept.sum()), x.element_size(), 2 * eid.numel() * 4
    ones = torch.ones((N, K), dtype=torch.float32, device=DEV)
    wrows = (wc[:, None, :] * gates[..., None]).to(dtype).reshape(N * K, D)
    e1, s1 = eid.reshape(N * K, 1), slot.reshape(N * K, 1)
    mg = torch.zeros((N, R * C), dtype=dtype, device=DEV)
    mg.index_put_((tok, rows), torch.ones_like(gates[kept]), accumulate=True)
    mg = mg.reshape(N, R, C)
    flat = torch.zeros((R * C, D), dtype=dtype, device=DEV)
    pair = tok * K + kk                                  # flat pair index
    n_tok = int(torch.unique(tok).numel())
    runs = {
        # x's kept tokens read, every buffer row written
        "dispatch_forward": (
            lambda: dispatch(x, eid, slot, R, C, impl="kernel"),
            lambda: dispatch(x, eid, slot, R, C, impl="xla"),
            lambda: flat.zero_().index_add_(0, rows, x.index_select(0, tok)),
            (n_tok + R * C) * D * elem + ids, n_kept * D),
        # dx = combine of dbuf with unit gates: the kept rows read, dx
        # written
        "combine_as_dispatch_backward": (
            lambda: combine(wd, eid, slot, ones, N, impl="kernel"),
            lambda: dispatch_bwd_ref(wd, eid, slot),
            lambda: torch.einsum("tec,ecd->td", mg, wd),
            (n_kept + N) * D * elem + ids + ones.numel() * 4,
            n_kept * D),
        # dy = dispatch of the gate-weighted rows: the kept rows read, every
        # buffer row written
        "dispatch_as_combine_backward": (
            lambda: dispatch(wrows, e1, s1, R, C, impl="kernel"),
            lambda: combine_bwd_ref(wc, y, eid, slot, gates)[0],
            lambda: flat.zero_().index_add_(0, rows,
                                            wrows.index_select(0, pair)),
            (n_kept + R * C) * D * elem + ids, n_kept * D),
        # dgates: the kept y rows and dout read, [N, K] written
        "dgates_plain": (
            lambda: combine_dgates(wc, y, eid, slot),
            lambda: combine_bwd_ref(wc, y, eid, slot, gates)[1],
            None, (n_kept + N) * D * elem + ids + N * K * 4,
            2 * n_kept * D),
    }
    out = dict(shape=f"N={B}x{T} tokens K={K} buffers={B}x{E} C={C} D={D}",
               pairs=N * K, kept_pairs=n_kept,
               route=shuffle_kernel.dispatch_route(N * K),
               grads_max_abs_err=errs,
               grads_tolerance={"float32": SHUFFLE_TOL[torch.float32],
                                "bfloat16": SHUFFLE_TOL[torch.bfloat16]},
               rows_build_ms=time_ms(lambda: (
                   wc[:, None, :] * gates[..., None]).to(dtype)))
    for name, (kern, plain, lib, nbytes, flops) in runs.items():
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        out[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                         library_ms=None if lib is None else time_ms(lib),
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
    return out


def check_model_small(cfg, rng, tol, n_layers=2, T=130, **impls):
    """The LM's kernel path against its plain path on a small input:
    ``n_layers`` full-width layers in fp32, prefill logits over ``T`` tokens
    and, for the hybrid and MoE families, one decode step. ``impls``: the
    plain path's impls."""
    small = cfg.with_(n_layers=n_layers, compute_dtype="float32",
                      kv_cache_dtype="float32")
    kern = build_model(small)
    plain = build_model(small, **impls)
    params = kern.init(torch.Generator("cuda").manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, T)))
    lk, ck = kern.prefill(params, {"tokens": toks}, max_len=T + 8)
    lp, cp = plain.prefill(params, {"tokens": toks}, max_len=T + 8)
    torch.cuda.synchronize()
    what = f"{cfg.name} {n_layers}-layer"
    err = close_or_fail(lk, lp, tol, f"{what} prefill kernel vs plain")
    if cfg.family in ("hybrid", "moe"):
        nxt = lp[:, -1:].argmax(dim=-1)
        del lk, lp
        dk, _ = kern.decode_step(params, {"tokens": nxt}, ck, T)
        dp, _ = plain.decode_step(params, {"tokens": nxt}, cp, T)
        torch.cuda.synchronize()
        err = max(err, close_or_fail(dk, dp, tol,
                                     f"{what} decode kernel vs plain"))
    return err


# -- phase 4: serve ---------------------------------------------------------------
def serve(cfg, prompts, expect, hbm_pages=None, max_len=552, params=None,
          routes=None):
    """``expect``: {counted wrapper: launches per batch} that the path must
    make exactly; ``routes``: {counted wrapper: {route: launches per
    batch}}, the same for its routes. With ``hbm_pages`` the pool is too
    small for a batch and must offload; without, it is ServeLoop's default.
    ``params``: the model's params (else ServeLoop draws its own)."""
    loop = ServeLoop(cfg, batch_slots=4, max_len=max_len,
                     hbm_pages=hbm_pages, params=params)
    reqs = [Request(i, p, max_new_tokens=32) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    out = loop.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if len(out) != len(prompts):
        _fail(f"served {len(out)} of {len(prompts)} requests")
    for rid, toks in out.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab for t in toks):
            _fail(f"request {rid}: {len(toks)} tokens, ids {toks[:4]}...")
    st = loop.stats
    if hbm_pages is not None and st["offloads"] <= 0:
        _fail("the page pool never offloaded")
    n_prefills = -(-len(prompts) // 4)
    for kernel, per_batch in expect.items():
        want = per_batch * n_prefills
        if kernel.launches != want:
            _fail(f"{kernel.__name__} kernel launched {kernel.launches} "
                  f"times, want {want}")
    if flash_attention in expect and (flash_attention.launches_by_route["wgmma"]
                                      != flash_attention.launches):
        _fail(f"flash_attention launches by route "
              f"{flash_attention.launches_by_route}: not all on wgmma")
    for kernel, per_route in (routes or {}).items():
        want = {r: n * n_prefills for r, n in per_route.items()}
        got = {r: n for r, n in kernel.launches_by_route.items() if n or r in want}
        if got != want:
            _fail(f"{kernel.__name__} launches by route {got}, want {want}")
    report = dict(arch=cfg.name, requests=len(out), wall_s=wall_s,
                  prefill_ms_per_batch=st["prefill_s"] / n_prefills * 1e3,
                  decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                  decode_tok_per_s_whole_run=st["decode_tok_per_s"],
                  prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                  pager_s=st["pager_s"],
                  offloads=st["offloads"], fetches=st["fetches"],
                  offload_bytes=st["offload_bytes"],
                  peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("serve", json.dumps(report))
    return loop


# -- phase 5: the KV page pool read in place ---------------------------------------
def kv_pool(loop, cfg, prompts, rng):
    L, KH, D, page = cfg.n_layers, cfg.kv_heads, cfg.resolved_head_dim, cfg.page_size
    H = cfg.n_heads
    lengths = [512, 461, 300, 130]                   # 8 + 8 + 5 + 3 pages
    _, cache = loop.model.prefill(
        loop.params_c, {"tokens": torch.from_numpy(np.stack(prompts[:4]))})
    dense_k, dense_v = cache["k"].float(), cache["v"].float()  # [L, B, KH, T, D]
    # fp32 as ServeLoop builds it; 20 slots < 24 pages written
    pool = PagedKVCache(num_layers=L, hbm_pages=20, page_size=page,
                        kv_heads=KH, head_dim=D, dtype=np.float32)
    written = {}
    for s, n in enumerate(lengths):
        pool.start_sequence(s)
        pool.ensure_capacity(s, n)
        pool.advance(s, n)
        for i in range(pool.num_pages(s)):
            sl = slice(i * page, (i + 1) * page)
            slab = torch.stack([cache["k"][:, s, :, sl].transpose(1, 2),
                                cache["v"][:, s, :, sl].transpose(1, 2)], dim=2)
            pool.write_page(s, i, slab)              # bf16 widens to fp32 exactly
            written[(s, i)] = slab.float().cpu().numpy()
    gen = torch.Generator("cuda").manual_seed(2)

    def attend(seqs):
        # one batch's pages fit the pool together: a restore inside
        # block_table may evict a page of another table (exclude_set is
        # ignored, as in the reference)
        max_pages = max(pool.num_pages(s) for s in seqs)
        tables = np.stack([pool.block_table(s, max_pages) for s in seqs])
        lens = np.asarray([pool.seq_length(s) for s in seqs], np.int32)
        q = torch.randn((len(seqs), H, D), generator=gen, device=DEV)
        worst = 0.0
        for layer in range(L):
            out = paged_attention(q, pool.kv[layer], tables, lens, impl="kernel")
            torch.cuda.synchronize()
            plain = paged_attention(q, pool.kv[layer], tables, lens, impl="xla")
            worst = max(worst, close_or_fail(out, plain, POOL_TOL,
                                             f"pool layer {layer} vs plain"))
            for j, s in enumerate(seqs):
                n = lengths[s]
                dense = attention_ref(q[j][None, :, None],
                                      dense_k[layer, s][None, :, :n],
                                      dense_v[layer, s][None, :, :n],
                                      causal=False)[0, :, 0]
                worst = max(worst, close_or_fail(
                    out[j], dense, POOL_TOL, f"pool layer {layer} seq {s} vs dense"))
        return worst

    worst = max(attend([0, 3]), attend([1, 2]), attend([0, 3]))
    st = pool.stats
    if st["offloads"] <= 0 or st["fetches"] <= 0:
        _fail(f"pool did not evict and restore: {st}")
    for (s, i), slab in written.items():
        if pool.read_page(s, i).tobytes() != slab.tobytes():
            _fail(f"read_page({s}, {i}) differs from what was written")
    log("kv_pool", json.dumps(dict(max_abs_err=worst, tolerance=POOL_TOL, **st)))


# -- phase 13: the serving tier at qwen3-0.6b's KV geometry -------------------------
TIER_POOL_PAGES = 32       # a node's device pool: 32 slabs (fp32: 14.68 MB)
TIER_SESSIONS = 16
TIER_PROMPTS = (448, 960)  # prompt tokens: 7 to 15 pages of 64
TIER_HOST_SLABS = 8        # a shard's host budget, in slabs: level 3 fires
TIER_DECODE, TIER_FAILOVER_DECODE = 16, 4
# attend against its plain version and dense fp64: the reference's pool
# tolerance over an fp32 pool, its bf16 tolerance over a bf16 one
TIER_TOL = {torch.float32: POOL_TOL, torch.bfloat16: 2e-2}


def tier_batches(tier):
    """Per-shard batches of sessions whose pages fit the shard's pool
    together: a restore inside one table may evict a page that another
    table of the same batch points at (exclude_set is ignored, as in the
    reference)."""
    by_node = {}
    for s, sess in sorted(tier.sessions.items()):
        by_node.setdefault(sess.node, []).append(s)
    batches = []
    for _node, seqs in sorted(by_node.items()):
        cur, used = [], 0
        for s in seqs:
            n = tier._pages_for(tier.sessions[s].length)
            if cur and used + n > tier.hbm_pages_per_node:
                batches.append(cur)
                cur, used = [], 0
            cur.append(s)
            used += n
        batches.append(cur)
    return batches


def tier_dense(tier, s):
    """fp64 softmax attention of session s's q over its K/V as the oracle
    (``expected_slabs``, not the pool) has them, each value as the tier's
    dtype rounds it: [L, KH, D]."""
    n = tier.sessions[s].length
    kv = host_to_tensor(np.concatenate(tier.expected_slabs(s), axis=1)
                        [:, :n], tier.dtype).to(DEV, torch.float64)
    k, v = kv[:, :, 0], kv[:, :, 1]                   # [L, n, KH, D]
    q = torch.full((tier.kv_heads, tier.head_dim), float(host_to_tensor(
        host_array(token_value(s, n), tier.dtype), tier.dtype)),
        dtype=torch.float64, device=DEV)
    p = torch.softmax(torch.einsum("hd,lthd->lht", q, k)
                      * tier.head_dim ** -0.5, dim=-1)
    return torch.einsum("lht,lthd->lhd", p, v).cpu()


def tier_attend(tier, want):
    """``attend(impl="kernel")`` at every layer over every per-shard batch,
    held to ``attend(impl="xla")`` and, where the batch's pages fit the
    pool, to dense fp64 attention over the oracle's K/V, at TIER_TOL (a
    session longer than the pool has its own pages evict one another while
    its table is built, so kernel and plain version read the same stale
    slots). ``want["paged"]`` gains the launches each call must make: one
    a shard, counted from ``tier.sessions``. Returns the largest error and
    the sessions held to the dense answer."""
    worst, dense_checked = 0.0, []
    tol = TIER_TOL[tier.dtype]
    for batch in tier_batches(tier):
        fits = sum(tier._pages_for(tier.sessions[s].length)
                   for s in batch) <= tier.hbm_pages_per_node
        dense = {s: tier_dense(tier, s) for s in batch} if fits else {}
        dense_checked += sorted(dense)
        for layer in range(tier.num_layers):
            want["paged"] += len({tier.sessions[s].node for s in batch})
            ker = tier.attend(batch, layer, impl="kernel")
            plain = tier.attend(batch, layer, impl="xla")
            for s in batch:
                got = host_to_tensor(ker[s], tier.dtype)
                worst = max(worst, close_or_fail(
                    got, host_to_tensor(plain[s], tier.dtype), tol,
                    f"tier layer {layer} seq {s} vs plain"))
                if s in dense:
                    worst = max(worst, close_or_fail(
                        got, dense[s][layer], tol,
                        f"tier layer {layer} seq {s} vs dense"))
    return worst, dense_checked


def tier_settle(tier):
    """Wait until no level-3 copy is in flight on any shard."""
    for shard in tier._shards.values():
        while shard.store._inflight:
            tier.cluster.transfer.drain(timeout=60.0)
            shard.store._reap()


def tier_counters(tier):
    """The tier's stats, each shard's pager (pool) and spill (store)
    counters, and each live node's replication: its replica and level-3
    blobs and the bytes its pool holds for them."""
    nodes = {}
    for nid, rep in tier.cluster.pressure_report().items():
        if nid not in tier.cluster.nodes:     # -1: the cluster's own manager
            continue
        sets = tier.cluster.nodes[nid].pool.paging.sets
        nodes[nid] = dict(
            replica_blobs=sum(n.startswith("kvrep/") for n in sets),
            spill_blobs=sum(n.startswith("kvspill/") for n in sets),
            resident_bytes=rep["resident"], spilled_bytes=rep["spilled"],
            reserved_bytes=rep["reserved"], refused=rep["refused"],
            forced=rep["forced"])
    return dict(tier=dict(tier.stats), nodes=nodes, shards={
        node: dict(pool=dict(sh.cache.stats), store=dict(sh.store.stats),
                   host_bytes=sh.store.host_bytes,
                   resident_pages=sh.cache.resident_pages())
        for node, sh in sorted(tier._shards.items())})


def tier_verify(tier, what):
    for s in sorted(tier.sessions):
        if not tier.verify(s):
            _fail(f"tier {what}: session {s} differs from the oracle")


def tier_inproc(cfg, want, dtype=torch.float32):
    """qwen3-0.6b's KV in a pool of ``dtype`` (fp32, the tier's own, or
    bf16, the configs' ``kv_cache_dtype``) on a four-node inproc cluster: admit TIER_SESSIONS
    prompts, decode, attend and verify, kill one session's primary, decode
    (failover), attend and verify again. The host budget is TIER_HOST_SLABS
    slabs of the dtype's size. Returns the report, the live tier and its
    cluster (for the timed launch)."""
    rng = np.random.default_rng(1300)
    prompts = {s: int(n) for s, n in enumerate(
        rng.integers(TIER_PROMPTS[0], TIER_PROMPTS[1] + 1, TIER_SESSIONS))}
    geometry = dict(num_layers=cfg.n_layers, page_tokens=cfg.page_size,
                    kv_heads=cfg.kv_heads, head_dim=cfg.resolved_head_dim)
    slab_nbytes = int(np.prod(list(geometry.values()))) * 2 * \
        torch.empty((), dtype=dtype).element_size()
    cluster = Cluster(4, node_capacity=3 << 30, page_size=1 << 20,
                      replication_factor=1, admission=True)
    tier = ServingTier(cluster, hbm_pages_per_node=TIER_POOL_PAGES,
                       host_budget_bytes=TIER_HOST_SLABS * slab_nbytes,
                       dtype=dtype, device="cuda", **geometry)
    if tier.slab_nbytes != slab_nbytes or tier.dtype != dtype:
        _fail(f"tier: {tier.dtype} slabs of {tier.slab_nbytes} bytes, not "
              f"{dtype} of {slab_nbytes}")
    report = dict(dtype=paged_kernel.ROUTES[dtype], tolerance=TIER_TOL[dtype],
                  sessions=TIER_SESSIONS, prompts=prompts,
                  slab_mb=tier.slab_nbytes / 1e6,
                  pool_gb=4 * TIER_POOL_PAGES * tier.slab_nbytes / 1e9,
                  host_budget_mb=tier.host_budget_bytes / 1e6)
    t0 = time.perf_counter()
    plan = tier.admit(prompts)
    report["diversions"] = {s: list(d) for s, d in plan.diversions.items()}
    report["admit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tier.decode(sorted(prompts), steps=TIER_DECODE)
    report["decode_s"] = time.perf_counter() - t0
    tier_settle(tier)
    report["after_decode"] = tier_counters(tier)
    stores = [sh.store.stats for sh in tier._shards.values()]
    pools = [sh.cache.stats for sh in tier._shards.values()]
    if not (sum(p["offloads"] for p in pools) > 0
            and sum(st["host_puts"] for st in stores) > 0
            and sum(st["remote_spills"] for st in stores) > 0):
        _fail(f"tier: spills did not reach level 3: {report['after_decode']}")
    t0 = time.perf_counter()
    report["max_abs_err"], dense_checked = tier_attend(tier, want)
    report["attend_s"] = time.perf_counter() - t0
    if sorted(dense_checked) != sorted(prompts):
        _fail(f"tier: only sessions {dense_checked} held to the dense answer")
    t0 = time.perf_counter()
    tier_verify(tier, "after decode")
    report["verify_s"] = time.perf_counter() - t0
    victim = tier.sessions[0].node
    cluster.kill_node(victim)
    report["killed_node"] = victim
    tier.decode(sorted(prompts), steps=TIER_FAILOVER_DECODE)
    if tier.stats["failovers"] < 1:
        _fail(f"tier: no failover after node {victim} died: {tier.stats}")
    err, dense_checked = tier_attend(tier, want)
    report["max_abs_err"] = max(report["max_abs_err"], err)
    if sorted(dense_checked) != sorted(prompts):
        _fail(f"tier: only sessions {dense_checked} held to the dense answer "
              f"after the failover")
    tier_verify(tier, "after failover")
    tier_settle(tier)
    report["after_failover"] = tier_counters(tier)
    return report, tier, cluster


def tier_proc(want):
    """The tier on the card over a four-node proc cluster, its node
    processes forked after CUDA is up: admit, decode, a SIGKILL of a
    session's primary mid-decode, failover, verify, attend. Fails unless
    close() leaves no child and no shared-memory segment, and no envelope
    value was refused as non-JSON."""
    before = pickle_fallbacks()
    cluster = Cluster(4, backend="proc", node_capacity=8 << 20,
                      page_size=1 << 14, replication_factor=1, admission=True)
    try:
        tier = ServingTier(cluster, hbm_pages_per_node=3,
                           host_budget_bytes=1024, device="cuda")
        tier.admit({1: 10, 2: 6})
        tier.decode([1, 2], steps=4)
        victim = tier.sessions[1].node
        tier.add_fault_hook("mid_decode", lambda: cluster.kill_node(victim))
        tier.decode([1, 2], steps=6)
        if tier.stats["failovers"] < 1:
            _fail(f"proc tier: no failover after SIGKILL: {tier.stats}")
        tier_verify(tier, "proc")
        worst, dense_checked = tier_attend(tier, want)
        stats = dict(tier.stats)
        tier.close()
    finally:
        cleanup = cluster.close()
    if not cleanup.ok:
        _fail(f"proc tier: close() left {cleanup}")
    if pickle_fallbacks() != before:
        _fail("proc tier: an rpc value was refused as non-JSON")
    return dict(killed_node=victim, max_abs_err=worst, stats=stats,
                dense_checked=dense_checked, close_ok=cleanup.ok)


def tier_timed(tier):
    """One attend launch at layer 0 over the largest per-shard batch, timed
    and checked as phase 3 times its shapes (``paged_shape``): the tier's
    block tables and lengths over a copy of the layer's pool filled with
    seeded random K/V, and a random q. (The oracle's K/V, one value a token
    the same in every head and column, cannot tell a dropped chunk, a head
    mix-up or a column mix-up in bf16.)"""
    batch = max(tier_batches(tier), key=lambda b: sum(
        tier.sessions[s].length for s in b))
    shard = tier._shard(tier.sessions[batch[0]].node)
    max_pages = max(shard.cache.num_pages(s) for s in batch)
    bt = np.stack([shard.cache.block_table(s, max_pages) for s in batch])
    ln = np.array([tier.sessions[s].length for s in batch], np.int32)
    pool = shard.cache.kv[0]
    gen = torch.Generator(device=DEV).manual_seed(1301)
    kv = torch.randn(pool.shape, generator=gen, device=DEV).to(pool.dtype)
    q = torch.randn((len(batch), tier.kv_heads, tier.head_dim),
                    generator=gen, device=DEV).to(pool.dtype)
    return paged_shape(q, kv, bt, ln)


# the port's own kernels: every __global__ function of csrc/*.cu
OUR_KERNELS = re.compile(r"\(anonymous namespace\)::(%s)\b" % "|".join(sorted(
    {name for src in _build.SOURCES for name in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        (_build.CSRC / f"{src}.cu").read_text())})))


def profile_fns(arch, fns):
    """Where each warm call of ``fns`` ({name: fn}) spends its time: host
    wall ms without and with torch.profiler, device busy ms (sum of kernel
    times in the profiled run), the device's idle share of the profiled
    wall time, the top kernels and the port's own kernels. Each fn runs
    once cold first and returns a boolean tensor that must hold (finite
    logits). Logs a ``profile`` line."""
    from torch.profiler import ProfilerActivity, profile
    report = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ok = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        ours = [e for e in kernels if OUR_KERNELS.search(e.key)]
        report[name] = dict(
            wall_ms=plain_wall * 1e3, profiled_wall_ms=wall * 1e3,
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / (wall * 1e3),
            kernel_launches=sum(e.count for e in kernels),
            top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                 for e in top],
            ours=[[OUR_KERNELS.search(e.key).group(1),
                   e.self_device_time_total / 1e3, e.count] for e in ours])
        if not bool(ok):
            _fail(f"{arch} {name}: non-finite logits")
    log("profile", arch, json.dumps(report))
    return report


def profile_steps(loop, prompts):
    """Where a warm prefill (the served batch: 4 x 512 tokens) and one warm
    decode step spend their time (``profile_fns``). Runs after the launch
    counts are read. Returns the prefill's first tokens."""
    model, params = loop.model, loop.params_c
    toks = torch.from_numpy(np.stack(prompts[:4]))
    state = {}

    def prefill():
        logits, state["cache"] = model.prefill(params, {"tokens": toks},
                                               max_len=loop.max_len)
        state["last"] = logits[:, -1].argmax(dim=-1)[:, None]
        return torch.isfinite(logits[:, -1]).all()

    def decode():
        logits, _ = model.decode_step(params, {"tokens": state["last"]},
                                      state["cache"], toks.shape[1])
        logits[:, 0].argmax(dim=-1)
        return torch.isfinite(logits).all()

    profile_fns(loop.cfg.name, {"prefill": prefill, "decode_step": decode})
    return state["last"][:, 0].cpu()


# -- phase 14: the durable tier ------------------------------------------------------
DURABLE_FSYNC = "group"            # one fsync a MiB of log: each 1 MiB page
DURABLE_PAGE = 1 << 20
DURABLE_NODE_CAPACITY = 1 << 30    # under one layout of qwen3-0.6b (1.5 GB)
DURABLE_PROC_RECORDS = 4 << 20     # 64 MiB of (key, val) pairs, one replica
DURABLE_JOIN_ROWS = 500_000        # each side of each join
PAIR = np.dtype([("key", np.int64), ("val", np.float64)])
JOIN_BUILD = np.dtype([("key", np.int64), ("rid", np.int64),
                       ("bval", np.float64)])
JOIN_PROBE = np.dtype([("key", np.int64), ("rid", np.int64),
                       ("pval", np.float64)])


def leaves_of(tree):
    out = []
    tree_map(out.append, tree)
    return out


def log_facts(log_):
    return dict(file_bytes=log_.file_bytes(), live_bytes=log_.live_bytes(),
                amplification=log_.amplification(),
                fsync_count=log_.fsync_count, compactions=log_.compactions)


def expected_blob_nodes(num_shards=4, nodes=4):
    """Where ``CheckpointManager._put_blob`` puts step 1's blobs under the
    prefix ``ckpt``: ``crc32(name) % len(alive)``."""
    names = [f"ckpt/step_00000001/{lay}/shard_{i}.npz"
             for lay in ("row", "col") for i in range(num_shards)]
    names += ["ckpt/step_00000001/manifest.json", "ckpt/latest"]
    return {n: zlib.crc32(n.encode()) % nodes for n in names}


def durable_checkpoint(cfg, params, prompts, first, max_len, root):
    """Checkpoint the served params through a four-node durable pool; kill
    and warm-revive node 0 (the row layout and ``latest``), restore the row
    layout from its replayed log and prefill phase 4's first batch with it;
    kill node 0 again, revive it cold and restore through the col layout."""
    leaves = leaves_of(params)
    rep = dict(params=sum(t.numel() for t in leaves),
               param_bytes=sum(t.numel() * t.element_size() for t in leaves),
               leaves=len(leaves), dtypes={str(k): v for k, v in Counter(
                   t.dtype for t in leaves).items()},
               fsync=DURABLE_FSYNC, page_size=DURABLE_PAGE,
               node_capacity=DURABLE_NODE_CAPACITY)
    log("durable_params", json.dumps(rep))
    cluster = Cluster(4, node_capacity=DURABLE_NODE_CAPACITY,
                      page_size=DURABLE_PAGE, replication_factor=1,
                      pagelog_dir=os.path.join(root, "ckpt"),
                      pagelog_fsync=DURABLE_FSYNC)
    mgr = CheckpointManager(cluster=cluster, layouts=("row", "col"),
                            num_shards=4, page_size=DURABLE_PAGE)
    t0 = time.perf_counter()
    mgr.save(1, params)
    rep["save_s"] = time.perf_counter() - t0
    where = {n: node for n, (node, _) in cluster.durable_blobs.items()}
    if where != expected_blob_nodes():
        _fail(f"durable: blobs placed {where}, not {expected_blob_nodes()}")
    logs = {n: cluster.nodes[n].memory.pagelog for n in cluster.nodes}
    rep["layout_bytes"] = {lay: sum(logs[node].set_bytes(n)
                                    for n, node in where.items()
                                    if f"/{lay}/" in n)
                           for lay in ("row", "col")}
    rep["pools"] = {lay: ("hold it" if b <= DURABLE_NODE_CAPACITY else
                          "page it through the log")
                    for lay, b in rep["layout_bytes"].items()}
    rep["after_save"] = {n: log_facts(lg) for n, lg in logs.items()}

    cluster.kill_node(0)
    fenced = cluster.revive_node(0)
    if fenced:
        _fail(f"durable: warm revival fenced {fenced}")
    net0 = cluster.net_bytes
    t0 = time.perf_counter()
    if mgr.latest_step() != 1:
        _fail(f"durable: latest_step() is {mgr.latest_step()} after the "
              f"warm revival")
    back = mgr.restore(params, layout="row")
    rep["warm_restore_s"] = time.perf_counter() - t0
    rep["warm_net_bytes"] = cluster.net_bytes - net0
    fetched = cluster.nodes[0].memory.stats["log_fetch_bytes"]
    rep["warm_log_fetch_bytes"] = fetched
    if rep["warm_net_bytes"] or fetched < rep["layout_bytes"]["row"]:
        _fail(f"durable: warm restore moved {rep['warm_net_bytes']} network "
              f"bytes and read {fetched} of node 0's log")
    restored = params_from_numpy(back, device="cuda")
    del back
    for i, (a, b) in enumerate(zip(leaves, leaves_of(restored))):
        if a.dtype != b.dtype or not torch.equal(a, b):
            _fail(f"durable: warm-restored leaf {i} differs")
    toks = torch.from_numpy(np.stack(prompts[:4]))
    logits, _ = build_model(cfg).prefill(restored, {"tokens": toks},
                                         max_len=max_len)
    got = logits[:, -1].argmax(dim=-1).cpu()
    del logits, restored
    if not torch.equal(got, first):
        _fail(f"durable: first tokens {got.tolist()} with the restored "
              f"params, {first.tolist()} with phase 4's")
    rep["first_tokens"] = got.tolist()

    cluster.kill_node(0)
    cluster.revive_node(0, warm=False)
    for what, call in (("latest_step", mgr.latest_step),
                       ("restore", lambda: mgr.restore(params))):
        try:
            call()
        except OSError as e:        # the reference's answer on the CPU
            rep[f"cold_{what}"] = str(e)
        else:
            _fail(f"durable: {what} answered after node 0's disk was wiped")
    net0 = cluster.net_bytes
    t0 = time.perf_counter()
    back = mgr.restore(params, step=1)
    rep["cold_restore_s"] = time.perf_counter() - t0
    rep["cold_net_bytes"] = cluster.net_bytes - net0
    for i, (a, b) in enumerate(zip(leaves, leaves_of(back))):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            _fail(f"durable: cold-restored leaf {i} differs")
    del back
    rep["logs"] = {n: log_facts(cluster.nodes[n].memory.pagelog)
                   for n in cluster.nodes}
    for n in cluster.nodes:
        cluster.nodes[n].memory.pagelog.close()
    cluster.shutdown()
    return rep


def durable_proc(root):
    """A four-node proc cluster (forked after CUDA is up) with the durable
    tier: one sharded set of DURABLE_PROC_RECORDS pairs and a replica;
    SIGKILL node 2 and recover it warm from its log, then node 3 cold (its
    log wiped) from the replica; a clean close()."""
    rng = np.random.default_rng(1400)
    recs = np.empty(DURABLE_PROC_RECORDS, PAIR)
    recs["key"] = rng.integers(0, 1 << 40, len(recs))
    recs["val"] = rng.random(len(recs))
    before = pickle_fallbacks()
    cluster = Cluster(4, backend="proc", node_capacity=512 << 20,
                      page_size=DURABLE_PAGE, replication_factor=1,
                      pagelog_dir=os.path.join(root, "proc"),
                      pagelog_fsync=DURABLE_FSYNC)
    rep = dict(records=len(recs), bytes=recs.nbytes)
    try:
        t0 = time.perf_counter()
        sset = cluster.create_sharded_set("pts", recs,
                                          key_fn=lambda r: r["key"])
        rep["write_s"] = time.perf_counter() - t0
        want = cluster.read_sharded(sset)
        cluster.kill_node(2)
        net0 = cluster.net_bytes
        t0 = time.perf_counter()
        warm = cluster.recover_node(2)
        rep["warm_recover_s"] = time.perf_counter() - t0
        rep["warm_net_bytes"] = cluster.net_bytes - net0
        if not (warm.ok and warm.sources == {"pts:2": "pagelog"}
                and warm.bytes_transferred == 0
                and rep["warm_net_bytes"] == 0):
            _fail(f"durable proc: warm recovery {warm}, "
                  f"{rep['warm_net_bytes']} network bytes")
        if cluster.read_sharded(sset).tobytes() != want.tobytes():
            _fail("durable proc: records differ after the warm recovery")
        cluster.kill_node(3)
        shutil.rmtree(cluster._node_pagelog_dir(3))
        t0 = time.perf_counter()
        cold = cluster.recover_node(3)
        rep["cold_recover_s"] = time.perf_counter() - t0
        if not (cold.ok and cold.sources["pts:3"].startswith("replica@")
                and cold.bytes_transferred > 0):
            _fail(f"durable proc: cold recovery {cold}")
        if cluster.read_sharded(sset).tobytes() != want.tobytes():
            _fail("durable proc: records differ after the cold recovery")
        rep["sources"] = {"warm": warm.sources, "cold": cold.sources}
        rep["bytes_transferred"] = {"warm": warm.bytes_transferred,
                                    "cold": cold.bytes_transferred}
        rep["logs"] = cluster.pagelog_report()
    finally:
        cleanup = cluster.close()
    if not cleanup.ok:
        _fail(f"durable proc: close() left {cleanup}")
    if pickle_fallbacks() != before:
        _fail("durable proc: an rpc value was refused as non-JSON")
    rep["close_ok"] = cleanup.ok
    return rep


def join_oracle(build, probe):
    """Sort-merge join in numpy, in ``canonical_join_sort`` order."""
    b = build[np.argsort(build["key"], kind="stable")]
    lo = np.searchsorted(b["key"], probe["key"], "left")
    n = np.searchsorted(b["key"], probe["key"], "right") - lo
    pi = np.repeat(np.arange(len(probe)), n)
    bi = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    out = np.empty(len(pi), join_output_dtype(JOIN_BUILD, JOIN_PROBE,
                                              "key", "key"))
    out["key"] = probe["key"][pi]
    out["b_rid"], out["b_bval"] = b["rid"][bi], b["bval"][bi]
    out["p_rid"], out["p_pval"] = probe["rid"][pi], probe["pval"][pi]
    return canonical_join_sort(out)


def durable_join(root):
    """ClusterJoin over the durable tier: a co-partitioned pair (no bytes
    move) and a pair whose probe side is partitioned on another field (it
    moves), each held byte for byte to the numpy oracle."""
    rng = np.random.default_rng(1401)
    n = DURABLE_JOIN_ROWS
    sides = []
    for dtype, field in ((JOIN_BUILD, "bval"), (JOIN_PROBE, "pval")):
        recs = np.empty(n, dtype)
        recs["key"] = rng.integers(0, n, n)
        recs["rid"] = np.arange(n)
        recs[field] = rng.random(n)
        sides.append(recs)
    build, probe = sides
    cluster = Cluster(4, node_capacity=DURABLE_NODE_CAPACITY,
                      page_size=DURABLE_PAGE, replication_factor=1,
                      pagelog_dir=os.path.join(root, "join"),
                      pagelog_fsync=DURABLE_FSYNC)
    t0 = time.perf_counter()
    b = cluster.create_sharded_set("b", build, key_fn=lambda r: r["key"],
                                   partition_key="key")
    p_key = cluster.create_sharded_set("p", probe, key_fn=lambda r: r["key"],
                                       partition_key="key")
    p_rid = cluster.create_sharded_set("p_rid", probe,
                                       key_fn=lambda r: r["rid"],
                                       partition_key="rid")
    rep = dict(rows=n, stage_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = join_oracle(build, probe)
    rep["oracle_s"] = time.perf_counter() - t0
    for name, probe_set, sides_moved in (("co", p_key, ()),
                                         ("one_side", p_rid, ("probe",))):
        net0 = cluster.net_bytes
        out, jr = ClusterJoin(cluster, b, probe_set, "key",
                              page_size=DURABLE_PAGE).execute()
        if jr.plan.shuffle_sides != sides_moved:
            _fail(f"durable join {name}: plan moves {jr.plan.shuffle_sides}")
        if out.dtype != want.dtype or out.tobytes() != want.tobytes():
            _fail(f"durable join {name}: output differs from the oracle")
        moved = cluster.net_bytes - net0
        if (moved == 0) != (name == "co"):
            _fail(f"durable join {name}: {moved} network bytes")
        rep[name] = dict(output_rows=jr.output_rows, seconds=jr.seconds,
                         net_bytes=moved, shuffled_bytes=jr.shuffled_bytes)
    rep["logs"] = {n_: log_facts(cluster.nodes[n_].memory.pagelog)
                   for n_ in cluster.nodes}
    for n_ in cluster.nodes:
        cluster.nodes[n_].memory.pagelog.close()
    cluster.shutdown()
    return rep


def durable_tier(cfg, params, prompts, first, max_len):
    """Phase 14: the checkpoint, the proc recovery and the join over the
    durable tier, then the port's fsck of every node's log; the temporary
    directories go at the end."""
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        t0 = time.perf_counter()
        rep = dict(checkpoint=durable_checkpoint(cfg, params, prompts,
                                                 first, max_len, root))
        rep["checkpoint"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["proc"] = durable_proc(root)
        rep["proc"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["join"] = durable_join(root)
        rep["join"]["seconds"] = time.perf_counter() - t0
        dirs = sorted(os.path.join(d, n) for d in (
            os.path.join(root, k) for k in ("ckpt", "proc", "join"))
            for n in os.listdir(d))
        rep["fsck"] = {}
        for d in dirs:
            check = fsck(d)
            if not check["exists"]:             # a node nothing was put on
                rep["fsck"][os.path.relpath(d, root)] = "no log"
                continue
            if not check["clean"] or check["stale_compact_tmp"]:
                _fail(f"durable: fsck of {os.path.relpath(d, root)}: {check}")
            rep["fsck"][os.path.relpath(d, root)] = dict(
                records=check["records"], file_bytes=check["file_bytes"],
                live_sets=len(check["live_sets"]),
                amplification=check["amplification"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rep


# -- phase 15: train ---------------------------------------------------------------
TRAIN_STEPS = 12
TRAIN_BATCH, TRAIN_SEQ = TRAIN_SHAPE[0], TRAIN_SHAPE[3]
# four batches of sequences, each seen three times (as tests/test_system.py's
# loss test repeats its 32 sequences), so that the loss has something to fall
# on: fresh uniform tokens only pull it towards ln(vocab)
TRAIN_SEQUENCES = 32
# the crash and restart run at full width and a cut depth: one layout of the
# full-depth fp32 state (params and both AdamW moments) is ~9 GB
CRASH_LAYERS = 2
# rwkv6-3b's profiled step runs at full width and this cut depth: at all 32
# layers it is ~108 k launches, which took the profiler 108-137 s
RWKV_PROFILE_LAYERS = 4


def state_leaves(state):
    """Every tensor of a TrainState, in a fixed order."""
    return [state.opt.step] + [t for tree in (state.params, state.opt.m,
                                              state.opt.v)
                               for t in leaves_of(tree)]


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def train_batch(cfg, seed, batch=TRAIN_BATCH, params=None):
    """``batch`` x 512 tokens from ``seed``, with their labels, completed
    as ``run_training`` completes a batch at step 0: the enc-dec's frames,
    the VLM's embeddings gathered from ``params`` at the broadcast M-RoPE
    positions."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, TRAIN_SEQ), dtype=np.int32)
    labels = np.concatenate(
        [toks[:, 1:], np.full((batch, 1), -100, np.int32)], axis=1)
    return complete_batch(cfg, {"tokens": toks, "labels": labels}, params, 0,
                          seed, DEV)


def train_routes(cfg, key="attn_impl", plain="xla", batch=TRAIN_BATCH,
                 params=None, held=("loss", "grad_norm"), positions=None):
    """One training step's loss and gradient norm from the same params
    (``params``, else drawn from seed 7) and batch with ``key`` (attention's
    forward, or the scans; a tuple of such impl keys sets each) on the
    kernel and on the plain path ``plain``: those named in ``held`` within
    2e-2 (relative). ``positions``: the M-RoPE positions of the batch, in
    place of the broadcast ones."""
    if params is None:
        params = build_model(cfg, device=DEV).init(
            torch.Generator(DEV).manual_seed(7))
    flat = leaves_of(params)
    tb = train_batch(cfg, 8, batch, params)
    if positions is not None:
        tb["positions"] = positions
    out = {}
    keys = (key,) if isinstance(key, str) else key
    for impl in ("kernel", plain):
        model = build_model(cfg, device=DEV, **{k: impl for k in keys})
        leaves = [p.detach().requires_grad_(True) for p in flat]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), params), tb)
        grads = leaf_grads(loss, leaves)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        out[impl] = {"loss": float(loss), "grad_norm": float(gnorm)}
        del loss, grads, leaves, gnorm
        gc.collect()
    for name in held:
        a, b = out["kernel"][name], out[plain][name]
        if not (np.isfinite(a) and abs(a - b) <= 2e-2 * abs(b)):
            _fail(f"{cfg.name} train step {name}: kernel {a} vs plain {b}")
    return out


def train_profile(cfg, state, batch, plain_bwd=None, kernel_names=None):
    """Where one warm step's device time goes (torch.profiler): the forward,
    each backward node of ``plain_bwd`` ({output key: autograd node name};
    by default attention's plain backward, the ``_FlashAttention`` nodes),
    the rest of the backward (the remat recompute included) and AdamW, with
    the host wall time and the device's idle share, of the profiled step's
    wall time and of the same step's unprofiled wall time (the profiler's
    own cost widens the first). The step is the train step's three parts,
    each in its own profiler range. ``kernel_names`` ({output key: name
    part}): the device ms and launches of the kernels whose names hold that
    part, over the whole step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    plain_bwd = plain_bwd or {
        "attention_backward_plain_ms": "_FlashAttentionBackward"}
    model = build_model(cfg, device=DEV)
    flat = leaves_of(state.params)

    def run():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), state.params)
        with record_function("train/forward"):
            loss = model.loss(params, batch)
        with record_function("train/backward"):
            grads = leaf_grads(loss, leaves)
        del params, leaves
        with record_function("train/optimizer"):
            # as run_training's step: each gradient freed as its leaf is
            # updated, the state's tensors updated in place
            adamw_apply(state.params, grads, state.opt)
        return loss.detach()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(loss)):
        _fail("train profile: non-finite loss")
    events = prof.key_averages()
    # the device side of the ranges is listed too (their span on the GPU's
    # timeline, gaps included): kernels only
    ranges = ("train/forward", "train/backward", "train/optimizer")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def range_ms(pred):
        """Device ms under the host ranges whose name ``pred`` accepts (the
        widest of them: a node's evaluation holds its apply)."""
        return max([e.device_time_total / 1e3 for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and pred(e.key)] or [0.0])

    fwd = range_ms(lambda k: k == "train/forward")
    opt = range_ms(lambda k: k == "train/optimizer")
    parts = {key: range_ms(lambda k, node=node: node in k)
             for key, node in plain_bwd.items()}
    bwd = busy_ms - fwd - opt          # the engine's thread runs it
    for key, part in (kernel_names or {}).items():
        named = [e for e in kernels if part in e.key]
        parts[key] = dict(
            ms=sum(e.self_device_time_total for e in named) / 1e3,
            launches=sum(e.count for e in named))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=plain_wall * 1e3, profiled_wall_ms=wall * 1e3,
                device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / (wall * 1e3),
                idle_share_unprofiled=1 - busy_ms / (plain_wall * 1e3),
                forward_ms=fwd, backward_ms=bwd, **parts,
                backward_rest_ms=bwd - sum(parts[k] for k in plain_bwd),
                optimizer_ms=opt,
                kernel_launches=sum(e.count for e in kernels),
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in top])


def train_restart(cfg, root):
    """``tests/test_system.py``'s crash and restart at full width and
    ``CRASH_LAYERS`` layers: a run that checkpoints at step 2 (async) and
    crashes there, the step-2 checkpoint restored bit-identical to the
    crashed run's state on the card, and a second run that restores from
    step 2, trains step 3 and saves it."""
    ccfg = cfg.with_(n_layers=CRASH_LAYERS)
    kw = dict(steps=3, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              ckpt_dir=root, ckpt_every=2, seed=6, log_every=100,
              device=DEV)
    crash = None
    t0 = time.perf_counter()
    try:
        run_training(ccfg, fail_at_step=2, **kw)
    except SimulatedFailure as e:        # the crash this part simulates
        crash = e
    if crash is None:
        _fail("train restart: fail_at_step=2 did not crash the run")
    crash_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved = state_to(CheckpointManager(root, layouts=("row", "col"),
                                       num_shards=4).restore(crash.state,
                                                             step=2), DEV)
    restore_s = time.perf_counter() - t0
    a, b = state_leaves(crash.state), state_leaves(saved)
    if len(a) != len(b) or not all(same_bits(x, y) for x, y in zip(a, b)):
        _fail("train restart: the step-2 checkpoint is not the crashed "
              "run's state bit for bit")
    state_gb = sum(t.numel() * t.element_size() for t in a) / 1e9
    del crash, saved, a, b
    gc.collect()
    t0 = time.perf_counter()
    res = run_training(ccfg, **kw)
    resume_s = time.perf_counter() - t0
    if res.restored_from != 2 or res.steps != 3 or len(res.losses) != 1 \
            or not np.isfinite(res.losses[0]):
        _fail(f"train restart: restored from {res.restored_from}, "
              f"{res.steps} steps, losses {res.losses}")
    return dict(layers=CRASH_LAYERS, state_gb=state_gb,
                restored_from=res.restored_from, bit_identical=True,
                crash_run_s=crash_s, restore_s=restore_s,
                resumed_run_s=resume_s, resumed_loss=res.losses[0])


def train_run(cfg, batch=TRAIN_BATCH, sequences=TRAIN_SEQUENCES):
    """``cfg`` (fp32 params, bf16 compute, remat per layer, fp32 AdamW
    moments) trains ``TRAIN_STEPS`` steps of ``batch`` x 512 tokens
    (``sequences`` sequences, written through the pool and read back by
    ``BatchLoader``); the losses must be finite and fall (the mean of the
    last 4 under that of the first 4)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_training(cfg, steps=TRAIN_STEPS, batch_size=batch,
                       seq_len=TRAIN_SEQ, num_sequences=sequences,
                       seed=5, log_every=4, device=DEV)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(res.losses) != TRAIN_STEPS or not all(
            np.isfinite(l) for l in res.losses + res.grad_norms):
        _fail(f"train {cfg.name}: losses {res.losses}, grad norms "
              f"{res.grad_norms}")
    if not np.mean(res.losses[-4:]) < np.mean(res.losses[:4]):
        _fail(f"train {cfg.name}: the loss did not fall: {res.losses}")
    warm_s = float(np.median(res.step_seconds[1:]))
    n_params = sum(t.numel() for t in leaves_of(res.state.params))
    return res, dict(
        arch=cfg.name, layers=cfg.n_layers, params=n_params,
        steps=res.steps, batch=batch, seq_len=TRAIN_SEQ,
        remat=cfg.remat, compute=cfg.compute_dtype,
        moments=cfg.opt_state_dtype, losses=res.losses,
        grad_norms=res.grad_norms, first_step_ms=res.step_seconds[0] * 1e3,
        ms_per_step=warm_s * 1e3,
        tokens_per_s=batch * TRAIN_SEQ / warm_s,
        tokens_per_s_whole_run=res.tokens_per_s, wall_s=wall_s,
        peak_device_gb=peak / 1e9)


# -- phase 18: seamless-m4t-large-v2 through its own entry points -----------------
SEAMLESS_FRAMES = 1024       # source frames a request (the stubbed frontend)
SEAMLESS_PROMPT = 128        # decoder prompt tokens (the reference's dry run)
NEW_TOKENS = 32


def serve_encdec(cfg, params, n_requests=8, batch=4):
    """Serve ``n_requests`` requests in static batches of ``batch`` through
    ``EncDecLM``'s entry points, as the reference's dry run lowers them:
    ``encode`` the frames, ``decode_cache_init(memory=...)``, the prompt as
    one ``decode_step`` at pos 0, then NEW_TOKENS greedy one-token steps.
    Then one teacher-forced ``forward`` over the first batch (its prompt and
    the first NEW_TOKENS - 1 generated tokens), whose logits at the prompt's
    positions are held to the cached path's (``drift_check``, the second
    plain path the forward with ``attn_impl="xla"``). Returns the report and
    a closure that profiles a warm encode and decode step."""
    model = build_model(cfg)
    max_len = SEAMLESS_PROMPT + NEW_TOKENS
    gen = torch.Generator("cuda").manual_seed(70)
    # frames drawn in bulk on the card; prompts from the seed
    frames = torch.randn((n_requests, SEAMLESS_FRAMES, cfg.d_model),
                         generator=gen, device=DEV, dtype=torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(700).integers(
        0, cfg.vocab, (n_requests, SEAMLESS_PROMPT))).to(DEV)
    encode_ms, decode_s, tokens, first = [], 0.0, [], None
    for b in range(0, n_requests, batch):
        src, toks = frames[b:b + batch], prompts[b:b + batch]
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        memory = model.encode(params, src)
        end.record()
        cache = model.decode_cache_init(batch, max_len, memory=memory,
                                        params=params)
        logits, cache = model.decode_step(params, {"tokens": toks}, cache, 0)
        last = logits[:, -1].argmax(dim=-1)
        if first is None:                 # the first batch's prompt logits
            first = logits
        del logits, memory
        torch.cuda.synchronize()
        encode_ms.append(start.elapsed_time(end))
        out = []
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = model.decode_step(
                params, {"tokens": last[:, None]}, cache,
                SEAMLESS_PROMPT + step)
            last = logits[:, 0].argmax(dim=-1)
            out.append(last.cpu())                       # syncs, as serving
        decode_s += time.perf_counter() - t0
        if not torch.isfinite(logits).all():
            _fail(f"{cfg.name}: non-finite decode logits")
        out = torch.stack(out, dim=1)
        if out.shape != (batch, NEW_TOKENS) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            _fail(f"{cfg.name}: tokens {out.shape} {out[:, :4]}")
        tokens.append(out)
        del cache
    teacher = torch.cat([prompts[:batch], tokens[0][:, :-1].to(DEV)], dim=1)
    logits, _ = model.forward(params, {"src_embeds": frames[:batch],
                                       "tokens": teacher})
    plain, _ = build_model(cfg, attn_impl="xla").forward(
        params, {"src_embeds": frames[:batch], "tokens": prompts[:batch]})
    torch.cuda.synchronize()
    forward = drift_check(logits[:, :SEAMLESS_PROMPT], first, plain,
                          f"{cfg.name} forward vs the cached prompt")
    del logits, first, plain
    steps = n_requests // batch * NEW_TOKENS
    report = dict(
        requests=n_requests, frames=SEAMLESS_FRAMES,
        prompt=SEAMLESS_PROMPT, new_tokens=NEW_TOKENS,
        encode_ms_per_batch=encode_ms,
        decode_step_ms=decode_s / steps * 1e3,
        decode_tok_per_s=n_requests * NEW_TOKENS / decode_s,
        forward_vs_cached=forward)

    def profile():
        """A warm encode and a warm decode step (``profile_fns``), over the
        first batch; run after the launch counts are read."""
        src, toks = frames[:batch], prompts[:batch]
        cache = model.decode_cache_init(batch, max_len, memory=model.encode(
            params, src), params=params)
        model.decode_step(params, {"tokens": toks}, cache, 0)

        def encode():
            return torch.isfinite(model.encode(params, src)).all()

        def step():
            logits, _ = model.decode_step(params, {"tokens": toks[:, -1:]},
                                          cache, SEAMLESS_PROMPT)
            logits[:, 0].argmax(dim=-1)
            return torch.isfinite(logits).all()

        return profile_fns(cfg.name, {"encode": encode, "decode_step": step})

    return report, profile


# -- phase 19: qwen2-vl-72b from embeddings at image-grid positions ----------------
def vlm_embeds(loop, n_steps=8):
    """One ``LM.prefill`` of 4 x 512 embeddings (the stubbed vision
    frontend's output, drawn on the card) at M-RoPE positions of one image
    a prompt (64 text tokens, a 16 x 16 patch grid, 192 text tokens), its
    last logits held to the same prefill on the plain path (``drift_check``,
    the second plain path the naive attention), then ``n_steps`` greedy
    decode steps with their positions in the batch."""
    cfg, model, params = loop.cfg, loop.model, loop.params_c
    B, T = 4, 512
    pos = grid_positions(B, 64, (16, 16), 192)
    embeds = torch.randn((B, T, cfg.d_model), device=DEV,
                         generator=torch.Generator("cuda").manual_seed(90),
                         dtype=torch.bfloat16)
    batch = {"embeds": embeds, "positions": pos}
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=T + n_steps)
    first = logits[:, -1].clone()
    del logits
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    plain = {}
    for impl in ("xla", "naive"):
        logits, _ = build_model(cfg, attn_impl=impl).prefill(
            params, batch, max_len=T + n_steps)
        plain[impl] = logits[:, -1].clone()
        del logits
    check = drift_check(first, plain["xla"], plain["naive"],
                        f"{cfg.name} embeds prefill kernel vs plain")
    del plain
    last = first.argmax(dim=-1)
    nxt = pos.amax(dim=(1, 2)) + 1
    t0 = time.perf_counter()
    for step in range(n_steps):
        p = (nxt + step)[:, None, None].expand(B, 3, 1)
        logits, cache = model.decode_step(
            params, {"tokens": last[:, None], "positions": p}, cache,
            T + step)
        last = logits[:, 0].argmax(dim=-1)
        last.cpu()
    decode_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        _fail(f"{cfg.name}: non-finite decode logits after embeds")
    return dict(prefill_ms=prefill_s * 1e3,
                decode_step_ms=decode_s / n_steps * 1e3,
                first_logits=check,
                positions="64 text, 16 x 16 patch grid, 192 text")


# -- phase 23: train the MoE families -------------------------------------------
# deepseek-v2-lite-16b at full width and 4 of its 27 layers: 2.76 B fp32
# params, 44.1 GB with their gradients and two fp32 moments (6 layers are
# 62.9 GB and leave too little for the compute copy and the 102400-wide
# logits)
MOE_TRAIN_LAYERS = 4


def train_moe(mcfg, counted):
    """Phase 23 on ``mcfg``, the counts zeroed just before: ``train_run``,
    the exact launches of the path (fails on any other), a profiled warm
    step, and the kernel route against the plain one from the trained
    params. Returns the ``train_moe`` line's dict."""
    train_res, train = train_run(mcfg)
    path = f"{mcfg.name}/train"
    L, S = mcfg.n_layers, TRAIN_STEPS
    # a layer a step: flash on the forward and its remat recompute;
    # dispatch and combine there too, and each once as the other's backward
    want = {"flash": 2 * L * S, "flash_wgmma": 2 * L * S,
            "flash_lse": 2 * L * S, "dispatch": 3 * L * S,
            "dispatch_walk": 3 * L * S, "combine": 3 * L * S,
            "dispatch_bwd": L * S, "combine_bwd": L * S,
            "dgates_calls": L * S}
    got = {"flash": flash_attention.launches,
           "flash_wgmma": flash_attention.launches_by_route["wgmma"],
           "flash_lse": flash_attention.lse_launches,
           "dispatch": dispatch.launches,
           "dispatch_walk": dispatch.launches_by_route["walk"],
           "combine": combine.launches,
           "dispatch_bwd": dispatch.bwd_launches,
           "combine_bwd": combine.bwd_launches,
           "dgates_calls": combine.bwd_calls}
    if got != want:
        _fail(f"{path}: launches {got}, not {want}")
    others = {fn.__name__: fn.launches for fn in counted
              if fn not in (flash_attention, dispatch, combine)
              and fn.launches}
    if others or diag_scan.bwd_launches or gla_scan.bwd_calls:
        _fail(f"{path}: other kernels launched: {others}, diag backward "
              f"{diag_scan.bwd_launches}, GLA backward calls "
              f"{gla_scan.bwd_calls}")
    # the path's counts, read before the profile and the route check
    # launch more
    train["launches"] = got
    train["launches_a_step"] = {k: v // S for k, v in got.items()}
    train["routes"] = {"flash_attention": dict(
        flash_attention.launches_by_route, with_lse=got["flash_lse"]),
        "dispatch": dict(dispatch.launches_by_route,
                         as_combine_backward=got["combine_bwd"])}
    t_part = time.perf_counter()
    train["profile"] = train_profile(
        mcfg, train_res.state, train_batch(mcfg, 9),
        {"attention_backward_plain_ms": "_FlashAttentionBackward",
         "dispatch_backward_ms": "_DispatchBackward",
         "combine_backward_ms": "_CombineBackward"},
        {"dispatch_kernels": "dispatch_", "combine_kernels": "combine_",
         "flash_kernels": "flash"})
    train["profile_s"] = time.perf_counter() - t_part
    params = train_res.state.params
    del train_res
    free_cache()
    # from the trained params, as phase 21: the kernels' route against the
    # plain one (the dense dispatch mask, the chunked attention), the loss
    # in bf16 compute and the loss and grad norm in fp32 compute
    t_part = time.perf_counter()
    routes = ("attn_impl", "moe_impl")
    train["kernel_vs_plain"] = train_routes(mcfg, routes, "xla",
                                            params=params, held=("loss",))
    free_cache()
    train["kernel_vs_plain_fp32"] = train_routes(
        mcfg.with_(compute_dtype="float32"), routes, "xla", params=params)
    train["routes_s"] = time.perf_counter() - t_part
    del params
    free_cache()
    return train


# -- phases 24-25: train the enc-dec and the VLM ---------------------------------
# qwen2-vl-72b at full width and 2 of its 80 layers: 4.25 B fp32 params,
# 51.0 GB with their fp32 gradients and bf16 moments (80 layers are 72.7 B),
# in batches of 4 x 512 (its 152064-wide logits are 1.25 GB an fp32 copy)
VLM_TRAIN_LAYERS = 2
VLM_TRAIN_BATCH = 4


def train_family(cfg, counted, batch, sequences, positions=None):
    """Phases 24-25 on ``cfg`` (the enc-dec or the VLM), the counts zeroed
    just before: the port's own ``count_params``, ``train_run``, exactly 2
    flash launches a self-attention layer a step (the forward and its remat
    recompute), all on wgmma with lse, the encoder's non-causal, and no
    other kernel; a profiled warm step; the kernel route against the plain
    (chunked) one from the trained params, the loss in bf16 compute and the
    loss and grad norm in fp32 compute, at ``positions`` where given.
    Returns the line's dict."""
    counted_params = count_params(cfg)
    log(f"{cfg.name}: {counted_params} params (count_params), "
        f"{cfg.n_encoder_layers} + {cfg.n_layers} layers")
    train_res, train = train_run(cfg, batch=batch, sequences=sequences)
    path = f"{cfg.name}/train"
    if train["params"] != counted_params:
        _fail(f"{path}: {train['params']} params trained, count_params "
              f"{counted_params}")
    n = 2 * (cfg.n_encoder_layers + cfg.n_layers) * TRAIN_STEPS
    want = {"flash": n, "flash_wgmma": n, "flash_lse": n,
            "flash_noncausal": 2 * cfg.n_encoder_layers * TRAIN_STEPS}
    got = {"flash": flash_attention.launches,
           "flash_wgmma": flash_attention.launches_by_route["wgmma"],
           "flash_lse": flash_attention.lse_launches,
           "flash_noncausal": flash_attention.noncausal_launches}
    if got != want:
        _fail(f"{path}: launches {got}, not {want}")
    others = {fn.__name__: fn.launches for fn in counted
              if fn is not flash_attention and fn.launches}
    if others or diag_scan.bwd_launches or gla_scan.bwd_calls \
            or dispatch.bwd_launches or combine.bwd_launches:
        _fail(f"{path}: other kernels launched: {others}")
    # the path's counts, read before the profile and the route check
    # launch more
    train.update(params_counted=counted_params, launches=got,
                 launches_a_step={k: v // TRAIN_STEPS for k, v in got.items()},
                 routes=dict(flash_attention.launches_by_route,
                             with_lse=got["flash_lse"],
                             noncausal=got["flash_noncausal"]))
    t_part = time.perf_counter()
    state = train_res.state
    train["profile"] = train_profile(
        cfg, state, train_batch(cfg, 9, batch, state.params),
        kernel_names={"flash_kernels": "flash"})
    train["profile_s"] = time.perf_counter() - t_part
    params = state.params
    del train_res, state
    free_cache()
    t_part = time.perf_counter()
    train["kernel_vs_plain"] = train_routes(cfg, batch=batch, params=params,
                                            held=("loss",),
                                            positions=positions)
    free_cache()
    train["kernel_vs_plain_fp32"] = train_routes(
        cfg.with_(compute_dtype="float32"), batch=batch, params=params,
        positions=positions)
    train["routes_s"] = time.perf_counter() - t_part
    del params
    free_cache()
    return train


def free_cache():
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 26-28: the sharding layer at world size 1 -----------------------------
SHARDED_STEPS = 3


def nccl_mesh():
    """A 1 x 1 ("data", "model") ``DeviceMesh`` over an NCCL group of world
    size 1, its store a ``FileStore`` in a temporary directory (no
    network). Returns (mesh, the directory); ``end_group`` takes both
    down."""
    root = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"), device_type="cuda"), root


def end_group(root):
    dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)


def train_sharded(cfg, phase15, zero_counts, counted):
    """Phase 26: ``run_training`` with ``mesh=`` (a 1 x 1 NCCL mesh, the
    config's fsdp_tp preset): the params, moments and batches DTensors,
    each step under ``use_rules``, from phase 15's initial params (drawn
    again from its seed) on its first ``SHARDED_STEPS`` batches. Each loss
    within 1e-4 max(|loss|, 1) of phase 15's at that step; exactly 2 flash
    launches a layer a step, all wgmma with lse; a profiled warm step for
    the step ms and the idle share beside phase 15's."""
    mesh, root = nccl_mesh()
    try:
        zero_counts()
        res = run_training(cfg, steps=SHARDED_STEPS, batch_size=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, num_sequences=TRAIN_SEQUENCES,
                           seed=5, log_every=4, device=DEV, mesh=mesh)
        want = 2 * cfg.n_layers * SHARDED_STEPS
        got = dict(flash=flash_attention.launches,
                   wgmma=flash_attention.launches_by_route["wgmma"],
                   lse=flash_attention.lse_launches)
        others = {fn.__name__: fn.launches for fn in counted
                  if fn is not flash_attention and fn.launches}
        if got != dict(flash=want, wgmma=want, lse=want) or others:
            _fail(f"{cfg.name}/train_sharded: flash {got}, not {want} on "
                  f"wgmma with lse; other kernels {others}")
        ref = phase15["losses"][:SHARDED_STEPS]
        gaps = [abs(a - b) for a, b in zip(res.losses, ref)]
        if len(res.losses) != SHARDED_STEPS or not all(
                g <= 1e-4 * max(abs(b), 1.0) for g, b in zip(gaps, ref)):
            _fail(f"{cfg.name}/train_sharded: losses {res.losses}, phase "
                  f"15's {ref}")
        routes = dict(flash_attention.launches_by_route, with_lse=got["lse"])
        rules = sharding_rules(cfg, mesh)
        with use_rules(rules, mesh):
            batch = train_batch(cfg, 9)
            prof = train_profile(cfg, res.state,
                                 distribute(batch, mesh,
                                            batch_shardings(batch, mesh)))
        warm_ms = float(np.median(res.step_seconds[1:])) * 1e3
        del res.state
    finally:
        end_group(root)
    return dict(
        mesh="1x1 (data, model), nccl, world size 1", preset=cfg.parallelism,
        steps=SHARDED_STEPS, losses=res.losses, phase15_losses=ref,
        max_loss_gap=max(gaps), bit_identical=res.losses == ref,
        launches=got["flash"], routes=routes, ms_per_step=warm_ms,
        phase15_ms_per_step=phase15["ms_per_step"],
        dtensor_host_ms=warm_ms - phase15["ms_per_step"],
        idle_share=prof["idle_share_unprofiled"],
        phase15_idle_share=phase15["idle_share"], profile=prof)


def first_batch(cfg, params):
    """The first batch ``run_training`` (seed 5, ``TRAIN_SEQUENCES``
    sequences of ``TRAIN_SEQ``, batches of ``TRAIN_BATCH``) trains on."""
    ds = synthetic_token_dataset(BufferPool(256 << 20), "train_tokens",
                                 vocab=cfg.vocab,
                                 num_sequences=TRAIN_SEQUENCES,
                                 seq_len=TRAIN_SEQ, seed=5)
    batch = next(iter(BatchLoader(ds, batch_size=TRAIN_BATCH)))
    return complete_batch(cfg, batch, params, 0, 5, DEV)


def moe_shardmap_mesh(mcfg, zero_counts, counted):
    """Phase 27: ``mcfg`` (phase 23's cut) with
    ``moe_strategy="expert_parallel_shardmap"``; the loss of phase 23's
    first batch from phase 23's initial params through the mesh branch of
    ``moe_shardmap_apply`` (a 1 x 1 NCCL mesh) against the same params'
    loss with no mesh, within 1e-4 max(|loss|, 1); a layer exactly one
    flash (wgmma), one dispatch and one combine launch."""
    scfg = mcfg.with_(moe_strategy="expert_parallel_shardmap")
    model = build_model(scfg, device=DEV)
    params = model.init(torch.Generator(DEV).manual_seed(5))
    batch = first_batch(scfg, params)
    with torch.no_grad():
        plain = float(model.loss(params, batch))
    L = scfg.n_layers
    want = {flash_attention: L, dispatch: L, combine: L}
    mesh, root = nccl_mesh()
    try:
        rules = sharding_rules(scfg, mesh)
        dparams = distribute(params, mesh,
                             param_shardings(model, scfg, mesh, rules))
        with use_rules(rules, mesh), torch.no_grad():
            dbatch = distribute(batch, mesh, batch_shardings(batch, mesh))
            zero_counts()
            t0 = time.perf_counter()
            loss = float(model.loss(dparams, dbatch).full_tensor())
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
        got = {fn: fn.launches for fn in counted}
        routes = dict(flash=dict(flash_attention.launches_by_route),
                      dispatch=dict(dispatch.launches_by_route))
    finally:
        end_group(root)
    if any(got[fn] != want.get(fn, 0) for fn in counted) or \
            routes["flash"]["wgmma"] != L:
        _fail(f"{scfg.name}/shardmap: launches "
              f"{ {fn.__name__: n for fn, n in got.items()} } {routes}, not "
              f"{L} flash (wgmma), dispatch and combine")
    if not abs(loss - plain) <= 1e-4 * max(abs(plain), 1.0):
        _fail(f"{scfg.name}/shardmap: mesh loss {loss}, no-mesh {plain}")
    del params, dparams
    return dict(layers=L, mesh="1x1 (data, model), nccl, world size 1",
                loss=loss, no_mesh_loss=plain, gap=abs(loss - plain),
                launches={fn.__name__: got[fn] for fn in want},
                routes=routes, forward_s=mesh_s)


def reckoned_train_args(cfg, shape=(16, 16), batch=256, seq=4096):
    """A train cell's per-device argument bytes reckoned from the port's
    ``sharding_rules`` and ``param_axes`` alone: each param's shard in
    fp32, two moments' in ``opt_state_dtype``, the int32 step, and the
    int32 tokens and labels split over "data"."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=shape)
    sizes = dict(zip(mesh.mesh_dim_names, shape))
    rules = sharding_rules(cfg, mesh)
    model = _on_meta(cfg)

    def walk(p, ax):
        if isinstance(p, dict):
            return sum(walk(p[k], ax[k]) for k in p)
        if isinstance(p, list):
            return sum(walk(a, b) for a, b in zip(p, ax))
        if p is None:
            return 0
        n = p.numel()
        for entry in spec_for(ax, rules, mesh):
            for a in (() if entry is None else (entry,) if isinstance(
                    entry, str) else entry):
                n //= sizes[a]
        return n
    local = walk(model.init(None), model.param_axes())
    moment = torch.tensor([], dtype=torch_dtype(cfg.opt_state_dtype))
    return (local * 4 + 2 * local * moment.element_size() + 4
            + 2 * batch // sizes["data"] * seq * 4)


def dryrun_cell(cfg):
    """Phase 28: ``python -m repro_torch.launch.dryrun`` for ``cfg``'s
    train_4k cell at 16 x 16 in a subprocess (its own fake process group
    of 256 ranks, no GPU): rc 0, and the record's argument bytes equal to
    ``reckoned_train_args``."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cfg.name, "--shape", "train_4k", "--force", "--tag", "chip"],
        env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        _fail(f"dry-run {cfg.name} train_4k: rc {out.returncode}\n"
              f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    path = os.path.join(os.path.dirname(src), "results", "dryrun_torch",
                        f"{cfg.name}_train_4k_16x16_chip.json")
    with open(path) as f:
        rec = json.load(f)
    want = reckoned_train_args(cfg)
    if rec["memory"]["argument_bytes"] != want:
        _fail(f"dry-run {cfg.name} train_4k: argument bytes "
              f"{rec['memory']['argument_bytes']}, reckoned {want}")
    return dict(record=rec, reckoned_argument_bytes=want,
                ok_line=[l for l in out.stdout.splitlines()
                         if l.startswith("OK")], subprocess_s=seconds)



# -- phase 29: the repo's entry points on the port ---------------------------------
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
# k-means at a data size its users would call real: 10 M points of 10 fp32
# dims (400 MB) and their norms (40 MB) through a 256 MB pool, so that every
# iteration's scan reads spilled pages back; the paper's k-means data is
# larger (§9.2.1), cut here for the script's time limit
KMEANS_ARGS = ["--points", "10000000", "--pool-mb", "256"]
KMEANS_TOL = 1e-5
# the cluster quickstart's counts and bytes, as the port's example gives
# them on the CPU (tests/test_torch_examples_cluster.py holds its printed
# lines equal to the JAX example's)
CLUSTER_FIGURES = dict(
    shard_records={"0": 49999, "1": 50108, "2": 50220, "3": 49673},
    groups=5000, shuffle_net_bytes=6400000, joined_rows=60000,
    join_net_bytes=0, join_reserved_hwm_bytes=361032, columnar_groups=5000,
    shards_recovered=2, replicas_rebuilt=2, recovery_bytes=3210496,
    proc_drained_records=200000, orphan_processes=0, leaked_segments=0)
SERVE_PAGED_BATCHES = 4          # 12 requests in 3 slots
QUICKSTART_STEPS = 10
TRAIN_100M_STEPS = 40


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_main(mod, argv):
    """``mod.main(argv)`` on the card, in this process so that its launches
    are counted; the lines it printed are logged after it, prefixed with
    its name (its JSON line only if it failed). Returns (its dict, its
    seconds)."""
    name = os.path.basename(mod.__file__)
    buf = io.StringIO()
    done = False
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = mod.main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        done = True
    finally:
        lines = buf.getvalue().splitlines()
        for line in (lines[:-1] if done else lines):
            log(f"example {name} |", line)
    return res, time.perf_counter() - t0


def check_example_path(path, counted, want, flash_route=None, lse=None):
    """Exactly ``want`` ({wrapper name: launches}) on the path and no other
    kernel; every flash launch on ``flash_route``, ``lse`` of them with
    the rows' lse. Returns the path's launches by route."""
    got = {fn.__name__: fn.launches for fn in counted if fn.launches}
    if got != want:
        _fail(f"{path}: launches {got}, not {want}")
    routes = {}
    if flash_attention.launches:
        routes["flash_attention"] = dict(flash_attention.launches_by_route,
                                         with_lse=flash_attention.lse_launches)
        if (flash_attention.launches_by_route[flash_route]
                != flash_attention.launches
                or flash_attention.lse_launches != lse):
            _fail(f"{path}: flash launches {routes['flash_attention']}, not "
                  f"all on {flash_route} with {lse} writing lse")
    if paged_attention.launches:
        routes["paged_attention"] = dict(paged_attention.launches_by_route)
    return routes


def kmeans_example(counted, zero_counts):
    """k-means over the pool (``examples/torch_kmeans_pangea.py``) at
    ``KMEANS_ARGS``: no kernel of the port (its products are plain torch,
    as the reference's are XLA), every point assigned, each iteration
    split into the pool scan with the host-to-device copy and
    ``assign_update``'s device ms; the last step's centroids against an
    fp64 recomputation from its own assignments (``KMEANS_TOL``), its
    assignments against fp64 distances, and ``assign_update`` timed against
    its bound."""
    mod = load_example("torch_kmeans_pangea")
    update, last = mod.assign_update, {}

    def recording(points, norms, centroids):
        out = update(points, norms, centroids)
        last.update(points=points, norms=norms, centroids=centroids, out=out)
        return out

    mod.assign_update = recording
    zero_counts()
    res, seconds = example_main(mod, KMEANS_ARGS)
    routes = check_example_path("examples/kmeans", counted, {})
    n = res["points"]
    if sum(res["cluster_sizes"]) != n or len(res["iters"]) != 5:
        _fail(f"k-means: sizes {res['cluster_sizes']}, {len(res['iters'])} "
              f"iterations")
    pts, norms, c_in = last["points"], last["norms"], last["centroids"]
    cents, assign = last["out"]
    if not torch.isfinite(cents).all():
        _fail("k-means: non-finite centroids")
    k = cents.shape[0]
    sums = torch.zeros((k, pts.shape[1]), dtype=torch.float64,
                       device=DEV).index_add_(0, assign, pts.double())
    counts = torch.bincount(assign, minlength=k).double()
    c64 = sums / counts.clamp(min=1)[:, None]
    err = float((cents.double() - c64).abs().max())
    if err > KMEANS_TOL:
        _fail(f"k-means: centroids {err} from fp64 over {KMEANS_TOL}")
    # the assignments against fp64 distances to the same centroids: a
    # point may flip only where two centroids are within rounding of it
    c_in64 = c_in.double()
    d64 = (norms.double()[:, None] - 2 * pts.double() @ c_in64.T
           + (c_in64 ** 2).sum(-1)[None, :])
    best = d64.argmin(dim=1)
    flips = assign != best
    n_flips = int(flips.sum())
    gap = float((d64.gather(1, assign[:, None])
                 - d64.gather(1, best[:, None]))[flips].max()) \
        if n_flips else 0.0
    if gap > 1e-3:
        _fail(f"k-means: an assignment {gap} farther than the nearest")
    del d64, best, flips, sums
    ms = time_ms(lambda: update(pts, norms, c_in))
    nbytes = (pts.nbytes + norms.nbytes + c_in.nbytes + cents.nbytes
              + assign.nbytes)
    flops = 4 * n * k * pts.shape[1] + 4 * n * k
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    pinned = torch.empty(pts.numel() + norms.numel(), dtype=torch.float32,
                         pin_memory=True)
    h2d_ms = time_ms(lambda: pinned.to(DEV), reps=5)
    del pinned, last
    its = res["iters"]
    return dict(
        res, routes=routes, seconds=seconds,
        iter_s_median=float(np.median([i["seconds"] for i in its])),
        scan_s_median=float(np.median([i["scan_s"] for i in its])),
        assign_ms_median=float(np.median([i["assign_ms"] for i in its])),
        assign_ms_timed=ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        h2d_ms=h2d_ms, centroids_fp64_err=err, tolerance=KMEANS_TOL,
        assign_flips_fp64=n_flips, assign_flip_max_gap=gap)


def examples_phase(counted, zero_counts):
    """Phase 29: each ``examples/torch_*.py`` through its ``main`` on the
    card, launch counts zeroed just before each and read just after. One
    ``example`` line each and an ``examples`` line with the launches by
    route of every path."""
    out = {}
    out["kmeans"] = kmeans_example(counted, zero_counts)
    free_cache()

    mod = load_example("torch_cluster_quickstart")
    zero_counts()
    res, seconds = example_main(mod, [])
    routes = check_example_path("examples/cluster_quickstart", counted, {})
    for key, want in CLUSTER_FIGURES.items():
        if res[key] != want:
            _fail(f"cluster quickstart: {key} {res[key]}, not {want}")
    out["cluster_quickstart"] = dict(res, routes=routes, seconds=seconds)

    mod = load_example("torch_serving_quickstart")
    zero_counts()
    res, seconds = example_main(mod, [])
    shards = len(res["attend_shards"])     # one launch a shard
    routes = check_example_path("examples/serving_quickstart", counted,
                                {"paged_attention": shards})
    if paged_attention.launches_by_route["fp32"] != shards:
        _fail(f"serving quickstart: paged launches "
              f"{paged_attention.launches_by_route}, not {shards} on fp32")
    if res["attend_max_abs_err"] > mod.PAGED_TOL or res["failovers"] < 1:
        _fail(f"serving quickstart: attend {res['attend_max_abs_err']}, "
              f"{res['failovers']} failovers")
    out["serving_quickstart"] = dict(res, routes=routes, seconds=seconds)
    free_cache()

    mod = load_example("torch_serve_paged")
    cfg = smoke_config("glm4-9b")
    zero_counts()
    res, seconds = example_main(mod, [])
    want = cfg.n_layers * SERVE_PAGED_BATCHES      # prefill only
    routes = check_example_path("examples/serve_paged", counted,
                                {"flash_attention": want}, "wgmma", 0)
    toks = [t for g in res["generated"].values() for t in g]
    if (res["requests"] != 12 or len(toks) != 96 or res["offloads"] <= 0
            or not all(0 <= t < cfg.vocab for t in toks)):
        _fail(f"serve_paged: {res}")
    out["serve_paged"] = dict(res, routes=routes, seconds=seconds)
    free_cache()

    mod = load_example("torch_quickstart")
    cfg = smoke_config("qwen3-0.6b")
    zero_counts()
    res, seconds = example_main(mod, [])
    # a layer a training step (no remat in the smoke config), then the
    # prefill's one a layer; the decode is plain
    lse = cfg.n_layers * QUICKSTART_STEPS
    routes = check_example_path("examples/quickstart", counted,
                                {"flash_attention": lse + cfg.n_layers},
                                "wgmma", lse)
    if (res["restored_step"] != QUICKSTART_STEPS
            or not np.isfinite(res["losses"]).all()
            or not all(0 <= t < cfg.vocab for t in res["generated"])):
        _fail(f"quickstart: {res}")
    out["quickstart"] = dict(res, routes=routes, seconds=seconds)
    free_cache()

    mod = load_example("torch_train_100m")
    cfg = mod.config_100m()
    zero_counts()
    res, seconds = example_main(mod, ["--steps", str(TRAIN_100M_STEPS),
                                      "--simulate-failure"])
    # fp32 compute, no remat: one flash launch a layer a step, on the
    # scalar route with lse, over the 20 steps before the crash and the 20
    # after the restart
    want = cfg.n_layers * TRAIN_100M_STEPS
    routes = check_example_path("examples/train_100m", counted,
                                {"flash_attention": want}, "scalar", want)
    half = TRAIN_100M_STEPS // 2
    if (res["crashed_at"] != half or res["restored_from"] != half
            or res["steps"] != TRAIN_100M_STEPS
            or len(res["losses"]) != half
            or not np.isfinite(res["losses"]).all()):
        _fail(f"train_100m: {res}")
    out["train_100m"] = dict(res, routes=routes, seconds=seconds)
    free_cache()
    for name, rec in out.items():
        log("example", name, json.dumps(rec))
    return {name: dict(seconds=rec["seconds"], launches_by_route=rec["routes"])
            for name, rec in out.items()}


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Seconds since the last lap, kept for the ``elapsed`` line."""
        nonlocal t0
        now = time.perf_counter()
        phase_s[name] = now - t0
        t0 = now

    built = _build.build()
    lap("build")
    log("build", json.dumps(dict(seconds=phase_s["build"], per_source=built)))
    _DISASSEMBLY.update(start_disassembly(
        ("flash_attention", "paged_attention", "linear_scan", "diag_scan",
         "shuffle_dispatch")))
    rng = np.random.default_rng(42)
    kernels = [check_flash(rng), check_paged(rng), check_gla(rng),
               check_diag(rng), *check_shuffle(rng)]
    # the training path's checks draw from their own generator, so that the
    # later phases' inputs stay those of the earlier slices
    kernels[0]["train"] = check_flash_train(np.random.default_rng(16))
    # train_100m's fp32 shape (phase 29's path), from its own generator
    kernels[0]["train"]["train_100m shape"] = check_flash_train_100m(
        np.random.default_rng(31))
    log("flash_train", json.dumps(kernels[0]["train"]))
    # MLA's heads (Dv != D) and deepseek-v2-lite-16b's MoE routing, each
    # from its own generator for the same reason
    kernels[0]["dv"] = check_flash_dv(np.random.default_rng(22))
    kernels[0]["paths"]["deepseek-v2-lite-16b"] = kernels[0]["dv"].pop(
        "served")
    log("flash_dv", json.dumps(kernels[0]["dv"]))
    ds_entries, ds_worst, ds_work = check_shuffle_deepseek(
        np.random.default_rng(23))
    for name in ("dispatch", "combine"):
        entry = next(k for k in kernels if k["name"] == name)
        entry["served"].update(ds_entries[name])
        entry["cases_max_abs_err"].update(ds_worst[name])
    log("shuffle_work", json.dumps(ds_work))
    # the MoE families' training path: dispatch and combine under grad at
    # deepseek-v2-lite-16b's training shape (its own generator)
    moe_train = check_moe_train(np.random.default_rng(30))
    log("moe_train", json.dumps(moe_train))
    for name in ("dispatch", "combine"):
        next(k for k in kernels if k["name"] == name)["train"] = moe_train
    # the enc-dec and VLM families' flash geometries (their own generator)
    fam_paths, fam_worst = check_flash_families(np.random.default_rng(25))
    kernels[0]["paths"].update(fam_paths)
    kernels[0]["cases_max_abs_err"].update(fam_worst)
    log("flash_families", json.dumps(dict(paths=fam_paths,
                                          max_abs_err=fam_worst)))
    # the recurrent families' training path (each its own generator)
    kernels.append(check_diag_bwd(np.random.default_rng(28)))
    log("diag_bwd", json.dumps({k: v for k, v in kernels[-1].items()
                                if k in ("shape", "cases_max_abs_err",
                                         "served")}))
    scan_train = check_scan_train(np.random.default_rng(29))
    log("scan_train", json.dumps(scan_train))
    next(k for k in kernels if k["name"] == "gla_scan")["train"] = scan_train
    lap("kernels")
    flash_build = flash_build_facts()
    log("flash_build", json.dumps(flash_build))
    scan_build = scan_build_facts()
    log("scan_build", json.dumps(scan_build))
    shuffle_build = shuffle_build_facts()
    log("shuffle_build", json.dumps(shuffle_build))
    paged_build = paged_build_facts()
    log("paged_build", json.dumps(paged_build))
    lap("build facts")
    cfg = get_config("qwen3-0.6b")
    rcfg = get_config("rwkv6-3b")
    gcfg = get_config("recurrentgemma-9b")
    # grok-1-314b at full width and 4 of its 64 layers: 316.5 B params
    # (633 GB in bf16) do not fit one card
    kcfg = get_config("grok-1-314b").with_(n_layers=4)
    for c, tol, kw in ((cfg, 1e-4, dict(attn_impl="xla")),
                       (rcfg, 2e-4, dict(scan_impl="xla_chunked")),
                       (gcfg, 1e-4, dict(attn_impl="xla", scan_impl="xla",
                                         n_layers=4, T=2100)),
                       (kcfg, 1e-4, dict(attn_impl="xla", moe_impl="xla",
                                         n_layers=1))):
        # fp32 sums of a few layers taken in another order; GLA's own
        # tolerance for the scan. recurrentgemma-9b: one superblock (rec,
        # rec, attn) and one rem layer, past the window. grok-1-314b: one
        # layer (26 GB in fp32 with the embeddings)
        log("model_small", c.name, json.dumps(dict(
            max_abs_err=check_model_small(c, rng, tol, **kw),
            tolerance=tol)))
    # deepseek-v2-lite-16b: one MLA + MoE layer (its own generator)
    dcfg = get_config("deepseek-v2-lite-16b")
    log("model_small", dcfg.name, json.dumps(check_mla_small(
        dcfg, np.random.default_rng(24))))
    # seamless-m4t-large-v2: one encoder and one decoder layer; qwen2-vl-72b:
    # one layer at image-grid positions (each its own generator)
    scfg = get_config("seamless-m4t-large-v2")
    vcfg = get_config("qwen2-vl-72b").with_(n_layers=24)
    for c, check, seed in ((scfg, check_encdec_small, 26),
                           (vcfg, check_vlm_small, 27)):
        log("model_small", c.name, json.dumps(dict(
            max_abs_err=check(c, np.random.default_rng(seed)),
            tolerance=1e-4)))
        free_cache()
    lap("model_small")
    free_cache()
    counted = (flash_attention, paged_attention, gla_scan, diag_scan,
               dispatch, combine)

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        flash_attention.lse_launches = 0
        flash_attention.noncausal_launches = 0
        diag_scan.bwd_launches = 0
        gla_scan.bwd_calls = 0
        for fn in (dispatch, combine):
            fn.bwd_launches = fn.bwd_calls = 0
        for fn in (flash_attention, gla_scan, diag_scan, dispatch,
                   paged_attention):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)

    def free():
        free_cache()
        torch.cuda.reset_peak_memory_stats()

    def check_path(path, want):
        """Exactly ``want`` ({counted wrapper: launches}) on the path, every
        flash launch on the wgmma route, and no other kernel."""
        for fn in counted:
            if fn.launches != want.get(fn, 0):
                _fail(f"{fn.__name__}: {fn.launches} launches on the {path}"
                      f" path, not {want.get(fn, 0)}")
        if flash_attention.launches_by_route["wgmma"] != \
                flash_attention.launches:
            _fail(f"flash_attention launches by route "
                  f"{flash_attention.launches_by_route} on the {path} path: "
                  f"not all on wgmma")

    prompts = [np.random.default_rng(100 + i).integers(0, cfg.vocab, 512,
                                                       dtype=np.int32)
               for i in range(8)]
    zero_counts()
    loop = serve(cfg, prompts, {flash_attention: cfg.n_layers}, hbm_pages=18)
    kv_pool(loop, cfg, prompts, rng)
    if paged_attention.launches != 3 * cfg.n_layers:   # 3 attended batches
        _fail(f"paged_attention: {paged_attention.launches} launches on the "
              f"{cfg.name} path, not {3 * cfg.n_layers}")
    launches = {"flash_attention": {cfg.name: flash_attention.launches},
                "paged_attention": {cfg.name: paged_attention.launches}}
    flash_routes = {cfg.name: dict(flash_attention.launches_by_route)}
    # phase 14 checkpoints these params and must give these first tokens
    qfirst = profile_steps(loop, prompts)
    qparams, qmax_len = loop.params_c, loop.max_len
    del loop
    free()
    lap("qwen3-0.6b")

    rprompts = [np.random.default_rng(200 + i).integers(0, rcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    zero_counts()
    rloop = serve(rcfg, rprompts, {gla_scan: rcfg.n_layers},
                  routes={gla_scan: {"mma": rcfg.n_layers}})
    launches["gla_scan"] = {rcfg.name: gla_scan.launches}
    scan_routes = {"gla_scan": {rcfg.name: dict(gla_scan.launches_by_route)}}
    profile_steps(rloop, rprompts)
    del rloop
    free()
    lap("rwkv6-3b")

    # recurrentgemma-9b: 10.4 B params, 41.8 GB in fp32. Cast to bf16 once
    # and free the fp32 tree before serving (ServeLoop's own cast then keeps
    # the same tensors), so 21 GB stay resident.
    gmodel = build_model(gcfg)
    gparams = gmodel._compute_cast(gmodel.init(
        torch.Generator("cuda").manual_seed(3)))
    free()
    gprompts = [np.random.default_rng(300 + i).integers(0, gcfg.vocab, 2100,
                                                        dtype=np.int32)
                for i in range(8)]
    n_rec = sum(k == "rec" for k in gcfg.block_pattern) * (
        gcfg.n_layers // len(gcfg.block_pattern)) \
        + gcfg.n_layers % len(gcfg.block_pattern)            # 24 + 2
    n_attn = gcfg.n_layers - n_rec                           # 12
    zero_counts()
    gloop = serve(gcfg, gprompts,
                  {diag_scan: n_rec * (1 + 32), flash_attention: n_attn},
                  max_len=2140, params=gparams,
                  routes={diag_scan: {"ring": n_rec, "step": n_rec * 32}})
    launches["diag_scan"] = {gcfg.name: diag_scan.launches}
    scan_routes["diag_scan"] = {gcfg.name: dict(diag_scan.launches_by_route)}
    launches["flash_attention"][gcfg.name] = flash_attention.launches
    flash_routes[gcfg.name] = dict(flash_attention.launches_by_route)
    del gparams
    profile_steps(gloop, gprompts)
    del gloop
    free()
    lap("recurrentgemma-9b")

    # grok-1-314b, 4 layers: 21.3 B params drawn straight in bf16 (42.6 GB;
    # one expert weight alone would be 25.8 GB in fp32)
    kmodel = build_model(kcfg)
    kparams = kmodel.init(torch.Generator("cuda").manual_seed(4),
                          dtype=torch.bfloat16)
    del kmodel
    kprompts = [np.random.default_rng(400 + i).integers(0, kcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    per_batch = kcfg.n_layers * (1 + 32)     # prefill and 32 decode steps
    zero_counts()
    # dispatch: the walk in prefill (2048 pairs a batch row), the direct
    # route in decode (8 pairs)
    kloop = serve(kcfg, kprompts, {dispatch: per_batch, combine: per_batch,
                                   flash_attention: kcfg.n_layers},
                  params=kparams,
                  routes={dispatch: {"walk": kcfg.n_layers,
                                     "direct": kcfg.n_layers * 32}})
    launches["dispatch"] = {kcfg.name: dispatch.launches}
    shuffle_routes = {kcfg.name: dict(dispatch.launches_by_route)}
    launches["combine"] = {kcfg.name: combine.launches}
    launches["flash_attention"][kcfg.name] = flash_attention.launches
    flash_routes[kcfg.name] = dict(flash_attention.launches_by_route)
    del kparams
    profile_steps(kloop, kprompts)
    del kloop
    free()
    lap("grok-1-314b")

    def check_tier_route(path, dtype, n):
        """Every paged launch of the path on the pool dtype's route."""
        route = paged_kernel.ROUTES[dtype]
        if paged_attention.launches_by_route[route] != n:
            _fail(f"paged_attention launches by route "
                  f"{paged_attention.launches_by_route} on the {path} path: "
                  f"not all {n} on {route}")
        paged_routes[path] = dict(paged_attention.launches_by_route)

    paged_routes = {}
    zero_counts()
    want = {"paged": 0}
    tier_report, tier, tier_cluster = tier_inproc(cfg, want)
    tier_report["proc"] = tier_proc(want)
    path = f"{cfg.name}/ServingTier"
    check_path(path, {paged_attention: want["paged"]})
    check_tier_route(path, torch.float32, want["paged"])
    launches["paged_attention"][path] = paged_attention.launches
    tier_shape = tier_timed(tier)
    tier.close()
    tier_cluster.shutdown()
    del tier
    free()
    lap("serving tier")
    tier_report["seconds"] = phase_s["serving tier"]
    # the inproc part again at the configs' kv_cache_dtype, bf16
    zero_counts()
    want = {"paged": 0}
    report, tier, tier_cluster = tier_inproc(cfg, want, torch.bfloat16)
    path = f"{cfg.name}/ServingTier/bf16"
    check_path(path, {paged_attention: want["paged"]})
    check_tier_route(path, torch.bfloat16, want["paged"])
    launches["paged_attention"][path] = paged_attention.launches
    tier_shape_bf16 = tier_timed(tier)
    tier.close()
    tier_cluster.shutdown()
    del tier
    free()
    lap("serving tier bf16")
    report["seconds"] = phase_s["serving tier bf16"]
    tier_report["bf16"] = report
    log("serving_tier", json.dumps(tier_report))

    zero_counts()
    durable = durable_tier(cfg, qparams, prompts, qfirst, qmax_len)
    path = f"{cfg.name}/durable"
    check_path(path, {flash_attention: cfg.n_layers})
    launches["flash_attention"][path] = flash_attention.launches
    flash_routes[path] = dict(flash_attention.launches_by_route)
    del qparams
    free()
    lap("durable tier")
    durable["seconds"] = phase_s["durable tier"]
    log("durable_tier", json.dumps(durable))

    zero_counts()
    train_res, train = train_run(cfg)
    path = f"{cfg.name}/train"
    want = 2 * cfg.n_layers * TRAIN_STEPS      # each forward and its remat
    if (flash_attention.launches != want
            or flash_attention.launches_by_route["wgmma"] != want
            or flash_attention.lse_launches != want):
        _fail(f"flash_attention: {flash_attention.launches} launches "
              f"({flash_attention.launches_by_route}, "
              f"{flash_attention.lse_launches} with lse) on the {path} path, "
              f"not {want} on wgmma with lse")
    others = {fn.__name__: fn.launches for fn in counted
              if fn is not flash_attention and fn.launches}
    if others:
        _fail(f"{path}: other kernels launched: {others}")
    launches["flash_attention"][path] = flash_attention.launches
    flash_routes[path] = dict(flash_attention.launches_by_route,
                              with_lse=flash_attention.lse_launches)
    train["profile"] = train_profile(cfg, train_res.state,
                                     train_batch(cfg, 9))
    del train_res
    free()
    train["kernel_vs_plain"] = train_routes(cfg)
    free()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train["restart"] = train_restart(cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    lap("train")
    train["seconds"] = phase_s["train"]
    train["card"] = smi
    log("train", json.dumps(train))
    # phase 26 trains the same run sharded, and is held to these
    phase15 = dict(losses=train["losses"], ms_per_step=train["ms_per_step"],
                   idle_share=train["profile"]["idle_share_unprofiled"])

    # deepseek-v2-lite-16b at full width and full depth: 16.2 B params drawn
    # straight in bf16 (32.4 GB; in fp32 beside their cast they would not
    # fit the card)
    dparams = build_model(dcfg).init(torch.Generator("cuda").manual_seed(5),
                                     dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in leaves_of(dparams))
    dprompts = [np.random.default_rng(600 + i).integers(0, dcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    per_batch = dcfg.n_layers * (1 + 32)     # prefill and 32 decode steps
    zero_counts()
    # every layer: flash in prefill (D = 192, Dv = 128, on wgmma); dispatch
    # on the walk in prefill (12288 pairs a batch) and on the direct route
    # in decode (24 pairs), combine in both
    dloop = serve(dcfg, dprompts, {dispatch: per_batch, combine: per_batch,
                                   flash_attention: dcfg.n_layers},
                  params=dparams,
                  routes={dispatch: {"walk": dcfg.n_layers,
                                     "direct": dcfg.n_layers * 32},
                          flash_attention: {"wgmma": dcfg.n_layers}})
    check_path(dcfg.name, {flash_attention: 2 * dcfg.n_layers,
                           dispatch: 2 * per_batch, combine: 2 * per_batch})
    for name, fn in (("flash_attention", flash_attention),
                     ("dispatch", dispatch), ("combine", combine)):
        launches[name][dcfg.name] = fn.launches
    shuffle_routes[dcfg.name] = dict(dispatch.launches_by_route)
    flash_routes[dcfg.name] = dict(flash_attention.launches_by_route)
    del dparams
    profile_steps(dloop, dprompts)
    del dloop
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free()
    lap(dcfg.name)
    log("deepseek", json.dumps(dict(
        arch=dcfg.name, params=n_params, peak_device_gb=peak_gb,
        seconds=phase_s[dcfg.name], card=smi)))

    # seamless-m4t-large-v2 at full width and depth (24 + 24 layers, 2.04 B
    # params drawn in bf16): its encoder on flash non-causal at D = 64, its
    # decoder's forward on flash causal; cross-attention and the cached
    # decode plain, as the reference runs them
    sparams = build_model(scfg).init(torch.Generator("cuda").manual_seed(7),
                                     dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in leaves_of(sparams))
    zero_counts()
    seamless, seamless_profile = serve_encdec(scfg, sparams)
    want = 2 * scfg.n_encoder_layers + scfg.n_encoder_layers + scfg.n_layers
    check_path(scfg.name, {flash_attention: want})
    launches["flash_attention"][scfg.name] = flash_attention.launches
    flash_routes[scfg.name] = dict(flash_attention.launches_by_route)
    seamless["profile"] = seamless_profile()
    del sparams, seamless_profile
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free()
    lap(scfg.name)
    log("seamless", json.dumps(dict(
        arch=scfg.name, params=n_params, peak_device_gb=peak_gb,
        seconds=phase_s[scfg.name], card=smi, **seamless)))

    # qwen2-vl-72b at full width and 24 of its 80 layers (23.6 B params
    # drawn in bf16; 80 layers are ~140 GB): ServeLoop from token prompts,
    # then a prefill from embeddings at image-grid positions
    vparams = build_model(vcfg).init(torch.Generator("cuda").manual_seed(8),
                                     dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in leaves_of(vparams))
    vprompts = [np.random.default_rng(800 + i).integers(0, vcfg.vocab, 512,
                                                        dtype=np.int32)
                for i in range(8)]
    zero_counts()
    vloop = serve(vcfg, vprompts, {flash_attention: vcfg.n_layers},
                  params=vparams,
                  routes={flash_attention: {"wgmma": vcfg.n_layers}})
    del vparams
    embeds = vlm_embeds(vloop)
    check_path(vcfg.name, {flash_attention: 3 * vcfg.n_layers})
    launches["flash_attention"][vcfg.name] = flash_attention.launches
    flash_routes[vcfg.name] = dict(flash_attention.launches_by_route)
    profile_steps(vloop, vprompts)
    del vloop
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free()
    lap(vcfg.name)
    log("qwen2vl", json.dumps(dict(
        arch=vcfg.name, layers=vcfg.n_layers, params=n_params,
        peak_device_gb=peak_gb, seconds=phase_s[vcfg.name], card=smi,
        embeds=embeds)))
    # rwkv6-3b trains at full width and depth: 3.07 B fp32 params, 49 GB
    # with their gradients and two fp32 moments; its wkv chunked at 16
    zero_counts()
    train_res, train = train_run(rcfg)
    path = f"{rcfg.name}/train"
    want = 2 * rcfg.n_layers * TRAIN_STEPS      # each forward and its remat
    if (gla_scan.launches != want or gla_scan.launches_by_route["fma"] != want
            or gla_scan.bwd_calls != rcfg.n_layers * TRAIN_STEPS):
        _fail(f"gla_scan: {gla_scan.launches} launches "
              f"({gla_scan.launches_by_route}), {gla_scan.bwd_calls} plain "
              f"backward calls on the {path} path, not {want} on fma and "
              f"{rcfg.n_layers * TRAIN_STEPS}")
    others = {fn.__name__: fn.launches for fn in counted
              if fn is not gla_scan and fn.launches}
    if others or diag_scan.bwd_launches:
        _fail(f"{path}: other kernels launched: {others}, diag backward "
              f"{diag_scan.bwd_launches}")
    launches["gla_scan"][path] = gla_scan.launches
    scan_routes["gla_scan"][path] = dict(gla_scan.launches_by_route,
                                         bwd_calls=gla_scan.bwd_calls)
    # from the trained params: at the random init the full-depth gradient
    # is ill-conditioned, and paths that differ only in rounding, the two
    # plain ones included, give grad norms orders apart. In bf16 compute
    # the loss is held; the grad norm is not fixed to 2e-2 by any path
    # there (the chunked plain path and the sequential oracle 31% apart, o
    # perturbed by half a bf16 ulp 13%; tools/rwkv_gla_chunk.py
    # --trained), so it is held in fp32 compute, where the paths agree to
    # 1e-6 and the kernel runs the same fp32 route as in training
    params = train_res.state.params
    del train_res
    free()
    t_part = time.perf_counter()
    train["kernel_vs_plain"] = train_routes(rcfg, "scan_impl", "xla_chunked",
                                            params=params, held=("loss",))
    free()
    train["kernel_vs_plain_fp32"] = train_routes(
        rcfg.with_(compute_dtype="float32"), "scan_impl", "xla_chunked",
        params=params)
    train["routes_s"] = time.perf_counter() - t_part
    del params
    free()
    # the profiled step: full width, RWKV_PROFILE_LAYERS layers, from init
    pcfg = rcfg.with_(n_layers=RWKV_PROFILE_LAYERS)
    pstate = make_train_state(build_model(pcfg, device=DEV).init(
        torch.Generator(DEV).manual_seed(9)), pcfg.opt_state_dtype)
    t_part = time.perf_counter()
    train["profile"] = dict(layers=pcfg.n_layers, **train_profile(
        pcfg, pstate, train_batch(pcfg, 9),
        {"gla_backward_plain_ms": "_GLAScanBackward"}))
    train["profile_s"] = time.perf_counter() - t_part
    del pstate
    free()
    lap(path)
    train.update(seconds=phase_s[path], card=smi)
    log("train_rwkv", json.dumps(train))

    # recurrentgemma-9b at full width and 5 of its 38 layers (one superblock
    # and the two rem layers: 3.22 B fp32 params, 51.6 GB with gradients and
    # moments; 38 layers would be 167 GB), batches of 4 x 512 (its 256000-
    # wide logits cost ~10 GB more at 8)
    hcfg = gcfg.with_(n_layers=5)
    n_super, n_rem = divmod(hcfg.n_layers, len(hcfg.block_pattern))
    rec_super = sum(k == "rec" for k in hcfg.block_pattern) * n_super
    attn_super = n_super * len(hcfg.block_pattern) - rec_super
    hbatch = 4
    zero_counts()
    train_res, train = train_run(hcfg, batch=hbatch, sequences=4 * hbatch)
    path = f"{hcfg.name}/train"
    # the superblock's scans run twice (the forward and its remat), the rem
    # layers' once; one backward launch each; flash twice a superblock
    want = {"diag": (2 * rec_super + n_rem) * TRAIN_STEPS,
            "diag_bwd": (rec_super + n_rem) * TRAIN_STEPS,
            "flash": 2 * attn_super * TRAIN_STEPS}
    got = {"diag": diag_scan.launches, "diag_bwd": diag_scan.bwd_launches,
           "flash": flash_attention.launches}
    if (got != want or diag_scan.launches_by_route["ring"] != want["diag"]
            or flash_attention.launches_by_route["wgmma"] != want["flash"]
            or flash_attention.lse_launches != want["flash"]):
        _fail(f"{path}: launches {got} (diag {diag_scan.launches_by_route}, "
              f"flash {flash_attention.launches_by_route}, "
              f"{flash_attention.lse_launches} with lse), not {want}, all "
              f"on ring and wgmma with lse")
    others = {fn.__name__: fn.launches for fn in counted
              if fn not in (diag_scan, flash_attention) and fn.launches}
    if others or gla_scan.bwd_calls:
        _fail(f"{path}: other kernels launched: {others}, GLA backward "
              f"calls {gla_scan.bwd_calls}")
    launches["diag_scan"][path] = diag_scan.launches
    launches["diag_scan_bwd"] = {path: diag_scan.bwd_launches}
    launches["flash_attention"][path] = flash_attention.launches
    scan_routes["diag_scan"][path] = dict(diag_scan.launches_by_route)
    flash_routes[path] = dict(flash_attention.launches_by_route,
                              with_lse=flash_attention.lse_launches)
    t_part = time.perf_counter()
    train["profile"] = train_profile(
        hcfg, train_res.state, train_batch(hcfg, 9, hbatch),
        {"attention_backward_plain_ms": "_FlashAttentionBackward",
         "diag_backward_kernel_ms": "_DiagScanBackward"})
    train["profile_s"] = time.perf_counter() - t_part
    params = train_res.state.params
    del train_res
    free()
    train["kernel_vs_plain"] = train_routes(hcfg, "scan_impl", "xla", hbatch,
                                            params=params)
    del params
    free()
    lap(path)
    train.update(seconds=phase_s[path], card=smi,
                 cut=f"{hcfg.n_layers} of {gcfg.n_layers} layers, batch "
                 f"{hbatch}")
    log("train_hybrid", json.dumps(train))

    # deepseek-v2-lite-16b trains at full width and 4 of its 27 layers
    mcfg = dcfg.with_(n_layers=MOE_TRAIN_LAYERS)
    path = f"{mcfg.name}/train"
    zero_counts()
    train = train_moe(mcfg, counted)
    for name, key in (("flash_attention", "flash"), ("dispatch", "dispatch"),
                      ("combine", "combine")):
        launches[name][path] = train["launches"][key]
    flash_routes[path] = train["routes"]["flash_attention"]
    shuffle_routes[path] = train["routes"]["dispatch"]
    lap(path)
    train.update(seconds=phase_s[path], card=smi,
                 cut=f"{mcfg.n_layers} of {dcfg.n_layers} layers")
    log("train_moe", json.dumps(train))

    # seamless-m4t-large-v2 trains at full width and depth (24 + 24 layers,
    # 2.03 B fp32 params, 32.6 GB with gradients and fp32 moments)
    path = f"{scfg.name}/train"
    zero_counts()
    train = train_family(scfg, counted, TRAIN_BATCH, TRAIN_SEQUENCES)
    launches["flash_attention"][path] = train["launches"]["flash"]
    flash_routes[path] = train["routes"]
    lap(path)
    train.update(seconds=phase_s[path], card=smi)
    log("train_encdec", json.dumps(train))

    # qwen2-vl-72b trains at full width and 2 of its 80 layers, bf16 moments;
    # the route step at image-grid positions (t, h and w apart)
    tcfg = get_config("qwen2-vl-72b").with_(n_layers=VLM_TRAIN_LAYERS)
    path = f"{tcfg.name}/train"
    zero_counts()
    train = train_family(tcfg, counted, VLM_TRAIN_BATCH, 4 * VLM_TRAIN_BATCH,
                         positions=grid_positions(VLM_TRAIN_BATCH, 64,
                                                  (16, 16), 192))
    launches["flash_attention"][path] = train["launches"]["flash"]
    flash_routes[path] = train["routes"]
    lap(path)
    train.update(seconds=phase_s[path], card=smi,
                 cut=f"{tcfg.n_layers} of {get_config(tcfg.name).n_layers} "
                 f"layers, batch {VLM_TRAIN_BATCH}")
    log("train_vlm", json.dumps(train))

    # phase 29, before the sharding phases: the cluster quickstart forks its
    # proc-backend nodes before any process group is up
    examples = examples_phase(counted, zero_counts)
    free()
    lap("examples")
    examples = dict(paths=examples, seconds=phase_s["examples"], card=smi)
    log("examples", json.dumps(examples))

    # the sharding layer: NCCL groups of world size 1, each taken down
    # before the next phase (the cluster phases above forked their nodes
    # before any group was up)
    path = f"{cfg.name}/train_sharded"
    sharded = train_sharded(cfg, phase15, zero_counts, counted)
    launches["flash_attention"][path] = sharded["launches"]
    flash_routes[path] = sharded["routes"]
    free()
    lap(path)
    sharded.update(seconds=phase_s[path], card=smi)
    log("train_sharded", json.dumps(sharded))

    mcfg = dcfg.with_(n_layers=MOE_TRAIN_LAYERS)
    path = f"{mcfg.name}/shardmap"
    shardmap = moe_shardmap_mesh(mcfg, zero_counts, counted)
    for name in ("flash_attention", "dispatch", "combine"):
        launches[name][path] = shardmap["launches"][name]
    flash_routes[path] = shardmap["routes"]["flash"]
    shuffle_routes[path] = shardmap["routes"]["dispatch"]
    free()
    lap(path)
    shardmap.update(seconds=phase_s[path], card=smi,
                    cut=f"{mcfg.n_layers} of {dcfg.n_layers} layers")
    log("shardmap", json.dumps(shardmap))

    dry = dryrun_cell(cfg)
    lap("dryrun")
    dry.update(seconds=phase_s["dryrun"], card=smi)
    log("dryrun", json.dumps(dry))

    next(k for k in kernels if k["name"] == "flash_attention").update(
        launches_by_route=flash_routes, build=flash_build)
    for name, lib in (("gla_scan", "linear_scan"), ("diag_scan", "diag_scan")):
        next(k for k in kernels if k["name"] == name).update(
            launches_by_route=scan_routes[name], build=scan_build[lib])
    next(k for k in kernels if k["name"] == "diag_scan_bwd").update(
        build={f: v for f, v in scan_build["diag_scan"].items()
               if "bwd" in f})
    next(k for k in kernels if k["name"] == "dispatch").update(
        launches_by_route=shuffle_routes,
        build={f: v for f, v in shuffle_build.items() if "dispatch" in f})
    next(k for k in kernels if k["name"] == "combine").update(
        build={f: v for f, v in shuffle_build.items() if "combine" in f})
    next(k for k in kernels if k["name"] == "paged_attention").update(
        build=paged_build, serving_tier=tier_shape,
        serving_tier_bf16=tier_shape_bf16, launches_by_route=paged_routes)
    for k in kernels:
        k["launches_by_path"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]].values())
        if min(launches[k["name"]].values()) <= 0:
            _fail(f"{k['name']} was never launched on a main path: "
                  f"{launches[k['name']]}")
    log("elapsed", json.dumps(dict(seconds=time.perf_counter() - t_start,
                                   phases=phase_s)))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
