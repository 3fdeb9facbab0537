"""Smoke run of the PyTorch port on one H100: build, check, drive, time.

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, bitwise,
   at the sweep shapes of the kernel tests plus edge cases: ``bucketize``
   at T = 1, T not a power of two, rows past 48 KB and past the shared-
   memory budget, INT32_MAX values, a view at an offset, threshold rows
   in any order (compare-counted); ``lb_lookup`` with codes outside
   [0, V), which add 0, and its predict modes (argmax, argmin, ovo_vote,
   raw) on raw features in and outside [0, V) with a wrapping bias, at K
   up to 16 (past the register chunk of 8), LUTs in opted-in shared
   memory and past 227 KB; ``bnn_popcount_matmul``'s modes (packed or
   feature input x counts, sign words or scores) at W 1-4 and 10, N 48
   and 33, 600,001 rows;
3. main path: ``plant`` rf, encode-based, size L on unsw (not gate-sized,
   so ``torch_predict("auto")`` runs ``bucketize`` + ``ternary_match``)
   and predict 2^20 flows; labels equal the plain path on the card, and on
   the first 65,536 flows the numpy reference and the native forest;
4. fused path: the same for rf size M (gate-sized, so ``fused_eb``);
5. per-kernel times (CUDA events around one call, median, which include
   the host's launch overhead; and the profiler's device time) beside the
   plain version's, the least time the card could take, and for
   ``bucketize`` one ``torch.searchsorted`` call as the library yardstick;
   flows/s of both predict paths;
6. LB path: ``plant`` svm, nb, kmeans, pca and ae, lookup-based, size L
   on unsw and predict 2^20 flows through ``auto``: one ``lb_lookup``
   launch per predict (clamp, gather, bias and the decision fused), and
   one device kernel on the profiler; labels (pca/ae: int32 sums bitwise,
   float outputs within 1e-5) equal the plain path on the card, and on
   the first 65,536 flows the numpy reference; each predict timed, and
   the launch plan (grid, blocks an SM, shared memory) printed;
7. DM path: bnn direct-map size L, trained on the card: two
   ``bnn_popcount_matmul`` launches per predict (layer 1 packs the
   features and its signs, layer 2 writes the scores), labels equal the
   plain path, the numpy reference and the native model; dt and rf
   direct-map size L walk their trees in plain torch on the card, labels
   equal numpy and native.  Then ``lb_lookup`` (kmeans-LB L: the sums
   mode on the clamped codes, with ``F.embedding_bag`` as library
   yardstick, and the predict's own fused argmin launch on the raw
   features, a row each) and ``bnn_popcount_matmul`` (BNN-L layer 1,
   counts mode, with a bf16 ``torch.matmul`` of the ±1 matrices) are timed
   like phase 5, and the BNN predict's two fused launches beside their
   bounds (the ``fused`` list of the kernel's JSON row);
8. ``paged_attention``: the kernel against its plain version over a grid
   (C 1 and 8, page 8 and 16, H/KV 12/2 and 4/4, bf16 and int8 pools,
   window 0 and 13, table entries past the pool, and a row at position -1
   that sees no key) within one bf16 ulp of the output's largest
   magnitude, and the dense cache's ring (one layer [4, 1024, 2, 128] as
   4 pages of 1,024 positions, bf16 and int8, window 0 and 13, positions
   past the wrap) within one bf16 ulp, below the wrap bitwise the launch
   without the ring; its rows bitwise invariant to the batch (a slot
   alone vs in a batch of 16), the chunk (C = 8 vs C = 1 calls), the
   physical page order and other values in the rows past each slot's
   position; timed at the serve decode shape (16 slots, 64 pages of 16,
   bf16) with every position weighed and with 256 of 1,024 visible, at
   the device batcher's shape (C = 8: each slot's 8 rows at [p, p + 8),
   p in phase 9's prompt range), and the ring at the dense step's shape
   (16 slots of 1,024 cells, C = 1, positions past the wrap), each beside
   its plain version and a gather + ``F.scaled_dot_product_attention``
   yardstick.
   ``linear``: for each of a qwen2-1.5b step's eight products (wq, wk, wv,
   wo, w_gate, w_up, w_down, the float32 head) and M in {1, 16, 48, 64,
   128, 256}, every row bitwise equal at offsets 0 and 7 and computed
   alone; within ``linear_limit`` of its plain version (2 K 2^-24
   sum|x||w| plus one bf16 ulp of a bf16 output, fixed before any run);
   the step's two groups (``linear_group`` of wq/wk/wv and of
   w_gate/w_up) at the same M, each member bitwise its lone launch; each
   product and group timed at M = 16 and 128, L2-cold (rotating over
   copies of its weights past 120 MB), beside cuBLAS (``x @ w``, a
   group's members one after another) and its byte bound, and summed
   into a step's products at C = 8 and C = 1;
9. serve: qwen2-1.5b at full width and depth, weights random-init from
   ``--seed`` (default 0), through ``ServeEngine`` + ``ContinuousBatcher``
   over the paged cache (16 slots, cache 1024, page 16) with an rf-S
   admission gate on unsw features: 32 requests, prompt lengths drawn in
   [16, 256] from the seed, 32 tokens each.  ``paged_attention`` launches
   equal steps x 28, ``linear`` steps x (4 x 28 + 1), ``fused_eb``
   launched at admission, served + dropped
   = submitted; tokens/s and ms per step; a torch.profiler window for the
   device's busy and idle share;
10. serve parity, on limits fixed before any run: (a) the same workload
   through the ``"torch"`` backend on the model's first 4 layers at full
   width (``cut_depth``), capturing the attention inputs of all 4 layers
   at steps 0, 64, 128 and 192: the kernel on each within one bf16 ulp of
   the plain output's largest magnitude; (b) the served
   streams teacher-forced through the kernel path and the plain path over
   at least 512 generated positions: at each, ``max|logits_kernel -
   logits_plain| <= 0.03 * max|logits_plain|`` (delta), and a greedy flip
   only where the plain top-2 margin is within 2 delta (the flips and the
   greedy agreement rate are printed, not gated); (c) ``share_prefix``
   streams bitwise equal to unshared ones; (d) one ``kv_int8`` run; (c)
   and (d) on the model's first 4 layers at full width (``cut_depth``);
11. the device batcher: phase 9's workload through
   ``DeviceContinuousBatcher`` (the fused step, one CUDA graph per shape
   key, replayed ``sync_every`` times a host round trip): (a) sync_every
   16, prefill_chunk 8, graph on: served + dropped = submitted, the
   gate-reject set = the gate's numpy verdicts, drops only gate-reject or
   quarantined, ``pool.ref`` back to the prefix holds; (b) prefill_chunk
   1: done, dropped, drop reasons and every stream bitwise equal to phase
   9's host batcher; (c) graph vs eager and sync_every 1 vs 16, bitwise;
   (d) chunk 8 vs 1: every stream and drop bitwise, and each of layer 0's
   products gives a row the same bits in a [128, K] as in a [16, K]
   operand; (e) rounds of the eager and the replayed step under
   ``torch.cuda.set_sync_debug_mode("error")``; (f) the profiler's
   kernels over one round and its gate call: ``paged_attention`` = steps
   run x 28, ``linear`` = steps run x (4 x 28 + 1), ``fused_eb`` =
   (steps run + 1) x the gate's tables, no other kernel of the repo; a
   count over these fails at once, a short one (the profiler can drop
   records) profiles a fresh round, up to three, and passes only on an
   exact match, every try's counts printed.
   Tokens/s and ms a step,
   graph and eager, beside phase 9's, the steps with work, run and wasted,
   and the device's idle share of a replayed step;
12. speculative decoding: phase 9's workload through the device batcher
   with ``spec_k`` 3 and a bigram draft trained on a pilot wave (phase
   11's streams of the first 16 requests): every greedy stream and drop
   bitwise phase 11's, at least one draft accepted, a round without a
   synchronising call; drafted, accepted, acceptance rate and tokens/s of
   a warm wave beside phase 11's;
13. ``obs`` and faults: a traced run (Tracer + Metrics) whose streams and
   drops are bitwise the untraced run's, every lifecycle valid, TTFT and
   decode ms a token (p50, p99) printed; a fault-plan run (a corrupted
   token in slot 3 at drain 1, every free page held at drain 2 for two
   drains): exactly that request quarantined, every other stream phase
   11's, ``pool.ref`` back to its prefix holds;
14. the dense ring cache: phase 9's model and gate with
   ``ServeConfig(max_batch=16, cache_len=1024)`` (no ``page_size``),
   phase 9's 32 requests with their first prompt token only, 32 tokens
   each: (a) the host batcher == the device batcher (sync_every 16, graph
   on), bitwise, every stream, drop and reason; served + dropped =
   submitted; the global position = the steps with work; (b) paged ==
   dense bitwise on the card, on the model's first 4 layers at full width
   (``cut_depth``): ``generate`` on the dense engine against
   ``step_paged`` one token a step on a paged engine (page 16, cache
   1024), 16 slots x 64 generated positions; (c) the wrap, also on the
   first 4 layers: cache 128, the first 16
   requests with 336 tokens each, so the global position passes 2.5 x
   128; the kernel on the attention inputs of all 4 layers at positions
   200 and 330 within one bf16 ulp of its plain version, host == device
   batcher bitwise; (d) a round of the eager and the replayed dense step under
   ``set_sync_debug_mode("error")``; (e) launch counts, fixed before the
   first run from the JAX package's step: the host batcher's wrappers
   count ``paged_attention`` = steps x 28, ``linear`` = steps x 113 and
   ``fused_eb`` = the gate's tables x (32 + steps): ``submit`` gates each
   request once (``ServeEngine.admit``) and every step runs the gate fused
   (``ServeEngine.step`` with the slots' features, its labels advisory);
   the profiler over one round of the device batcher and its gate call
   sees ``paged_attention`` = 16 x 28, ``linear`` = 16 x 113 and
   ``fused_eb`` = 17 x the tables (the pregate call and the in-step gate
   of every step, as in phase 11), exact under (f)'s retry rule.  Tokens/s,
   ms a step and device ms a step by kernel class for both dense batchers,
   beside phase 11's paged numbers;
15. the trainer: (a) ``repro_torch.launch.train`` at its defaults
   (qwen2-1.5b at full width and depth, float32 masters from ``--seed``,
   20 steps of 8 x 64 tokens in 2 microbatches, lr 1e-3, ``"full"``
   remat): 20 finite losses whose last five's mean is below the first
   five's, the host wrappers' ``linear`` launches exactly 20 x 2 x (2 x 4
   x 28 + 1) = 9,000 (each layer's four products in the forward and in
   its recomputation, the head once; the backward's products are
   ``torch.matmul``) and no other kernel of the repo; (b) 4 layers at full
   width, 3 steps through the kernel and through ``linear_ref``: each
   step's loss within 2e-3 relative, each gradient leaf at step 0 within
   0.03 x max|g_plain|; (c) ``linear``'s backward for the eight weight
   shapes at M = 256 and 512: ``dx`` and ``dw`` bitwise autograd's through
   the plain product; (d) in child processes with deterministic
   algorithms (the launcher on xlstm-125m at full width, one macro of its
   12 layers, 8 steps of 8 x 32 tokens: a checkpoint of about 1 GB): a run
   stopped by SIGTERM after its step-3 line saves and stops, ``--resume auto`` gives the uninterrupted
   run's losses bitwise from the resumed step, both runs' final
   checkpoints equal in every leaf and the preempted one restores onto
   the card bitwise; (e) printed, not gated: ms a step (median of steps
   5-19), tokens/s, device ms a step by class (``linear`` forward, the
   backward's matmuls, attention, optimizer and elementwise, other), idle
   share, peak memory, the model-FLOP share of the bf16 peak, and
   ``linear``'s forward at M = 256 beside cuBLAS and its bound (the
   ``linear`` JSON row's ``train``);
16. the mesh-less router (``serve.router.ShardedServe``): phase 9's model,
   gate, ServeConfig and 32 requests, each shard a device batcher as
   phase 11's: (a) one shard: every stream, drop and reason bitwise
   phase 11's batcher; (b) two shards: FIFO within each, each shard's
   streams and drops bitwise a lone device batcher fed its requests in
   their order; (c) ``ShardCrash(shard=1, at_drain=1)``, two retries,
   shards taking 16-step turns: the crash logged first with work moved,
   every request terminal once, every stream and drop bitwise (a)'s; (d)
   a ``SlowShard`` (30 s, virtual) at every drain of shard 1 with
   ``straggler_strikes`` 2: shard 1 evicted, shard 0 never, streams
   (a)'s; (e) one routed round, eager (the wrappers count every launch):
   ``fused_eb`` = the gate's tables x (1 gate call + the steps run; the
   shards' pregate is off, their in-step gate on), ``paged_attention`` =
   steps x 28, ``linear`` = steps x 113, nothing else; tokens/s and ms a
   step of a warm wave with one and two shards; the launcher's
   ``--continuous --router --page-size 16`` in a child process beside
   (c)-(e);
17. MoE, after every earlier model is freed: qwen2-moe-a2.7b at its
   published width (d 2048, 16/16 heads, hd 128, 60 experts padded to
   64, top-4, expert d_ff 1408, 4 shared experts as one MLP of 5,632,
   vocab 151,936), its depth cut to 4 of its 24 layers (phases 17-20 cut
   each model's depth to ``SERVE_DEPTH``, to keep the run well inside its
   time limit), random weights from ``--seed``, phase
   9's ServeConfig, gate and traffic: the host batcher's wrapper launches
   exactly steps x (``paged_attention`` 4, ``linear`` 4 x 6 + 1,
   ``moe_down_combine`` 4) (f); ``linear`` timed at the MoE products
   (router N = 64, the experts' gate/up group N = 90,112, the shared
   experts' N = 5,632 and their down); (b) ``moe_down_combine`` bitwise
   its plain version on layer 0's ``w_down`` at M = 1, 7, 16, 128, 200
   and 256 with tied and zero combine weights, on skewed routing (every
   row's top expert one expert, every row on experts 0-3, one row an
   expert, 256 rows on one expert), on every layer's inputs of step 48
   of an eager device-batcher wave (each layer's routing and device time
   printed, with the busiest expert of every step of the wave), and on
   layer 0's inputs captured from a C = 8 chunk of 16 sequences, where it
   is timed beside the plain version, ``torch.einsum`` of the down
   product plus the weighted sum, the bound of what those inputs need
   and the same flops on the float32 lanes; (a) the device batcher
   (sync_every 16, prefill_chunk 8, graph): served + dropped = submitted;
   (e) the host batcher == the device batcher at prefill_chunk 1,
   bitwise; (c) chunk 8 == chunk 1 bitwise, every product of layer 0
   (and ``moe_down_combine``) row-invariant, and 4 served streams
   teacher-forced at C = 8 and C = 1 bitwise on the model's first 4
   layers at full width; (d) the same 4 streams
   teacher-forced: with the plain ``moe_down_combine`` in the kernel
   path, every logit bitwise; with the plain attention too, routed as the
   kernel path (every token routed otherwise a near tie), the attention
   kernel within one bf16 ulp of the plain output on every call's
   inputs, and the logits' distance in 0.03 max|plain| printed (random
   MoE layers grow one ulp of attention to about that, so phase 10's
   gate does not hold end to end); (e)
   the paged device batcher == the dense one on 16 single-token prompts,
   bitwise; (f) the profiler's kernels over one round, exact (phase 11's
   rule, with ``moe_down_combine`` 16 x 4); tokens/s, ms a step, device
   ms a step by class, idle share and peak memory;
18. the recurrent families, after every earlier model is freed: (a)
   recurrentgemma-9b at its published width (pattern rglru, rglru, attn,
   d 4,096, 16 heads on 1 KV head of hd 256, window 2,048, d_ff 12,288
   GELU, vocab 256,000), its depth cut to 14 of its 38 layers (4 macros
   and the 2-layer tail: 10 RG-LRU and 4 windowed attention layers),
   random weights from
   ``--seed``, over the dense state (phase 14's ``DENSE`` config): its
   products' shapes through phase 8's ``linear`` checks; ``generate()``
   (16 prompts of 4 tokens, 64 generated, the gate fused) with the
   wrappers' launches exactly steps x (4 ``paged_attention``, 67
   ``linear``) + the gate's tables; phase 9's 32 requests (first prompt
   token) through the host batcher and the device batcher (CUDA graph):
   bitwise, launches exact (phase 14 (e)'s rule), graph == eager bitwise,
   a round without a synchronising call; the host batcher's streams
   teacher-forced from a fresh state through the kernel path, the plain
   path, each half alone, a witness (the plain products' float32 sums in
   the other operand order) and a control (every recurrent state dropped
   at every step): the kernel path and the witness within phase 17's
   gate of the plain path (6 deltas a position, 2 on average; phase 9's
   one delta printed: the witness itself broke it on the random 38-layer
   model), the control past it; the profiler over a round
   (exact), tokens/s, ms and device ms a step by kernel class, idle, the
   share of the weights' byte bound, and an eager
   step's device time with the recurrences told apart (the RG-LRU's
   decode under a ``record_function`` range set by this script); (b) the
   ring past its wrap on the model's first macro (rglru, rglru, attn) at
   full width: cache 128 under the window of 2,048, phase 14 (c)'s check
   (the kernel on the attention layer's captured inputs within one bf16
   ulp, host == device bitwise); (c) ``paged_attention``
   at this model's step (16 slots x 1,024 ring cells, C = 1, hd 256,
   16:1 heads, past the wrap) within one bf16 ulp, timed beside gather +
   SDPA and its bound, and the published 38-layer step's 179 ``linear``
   launches L2-cold at M = 16 beside cuBLAS (two new JSON rows); (d) xlstm-125m (12 layers,
   mLSTM and sLSTM alternating, d 768, 4 heads of 192, vocab 50,304
   padded to 50,432) through the same checks but the ring's (31
   ``linear`` launches a step: the mLSTM's q/k/gates and v/gate groups
   and w_out, the sLSTM's w_gates and w_out, the head); (e)
   ``repro_torch.launch.train`` on xlstm-125m at ``examples/
   train_lm.py``'s settings (8 x 128 tokens, 2 microbatches, lr 3e-3, a
   checkpoint) for 20 steps at full width, its depth cut to 2 layers (one
   macro): the loss improves, ``linear`` launched exactly
   20 x 2 x (2 x 5 + 1) times and nothing else, the checkpoint's keys
   the JAX package's ``_flatten`` keys of the same tree (built from the
   JAX init functions' leaf names); at 2 layers (one macro, full width,
   as phase 15 (b) cuts qwen2) kernel vs plain, and a witness, within
   phase 15's bounds at each of 2 steps, every path from the same masters
   (two trajectories drift apart through AdamW at lr 3e-3, and the full
   model's gradient is chaotic, with no fault in either path); ms a step,
   tokens/s, device ms by class, idle, kernels a step.
19. the VLM and enc-dec families, after every earlier model is freed:
   internvl2-2b (24 layers, d 2,048, 16 heads on 8 KV heads of hd 128,
   d_ff 8,192, vocab 92,553 padded to 92,672, a 1,024-wide frontend of
   256 patches; 1.89 B parameters) and seamless-m4t-large-v2 (24 encoder
   and 24 decoder layers with cross-attention, d 1,024, 16 heads of 64,
   d_ff 8,192, vocab 256,206 padded to 256,256, a 160-wide frontend of
   4,096 frames; 2.64 B parameters) at full width, each stack's depth cut
   to 4 of its 24 layers, random weights from ``--seed``: their products
   through phase 8's ``linear`` checks and the frontend product at 2 x the frontend's rows; (a) the
   forward of 2 x 64 tokens with their patches or frames, the kernel
   path (exactly the model's ``linear`` launches) against the plain path
   within one delta (0.03 max|plain|) a position, beside a witness (the
   plain products' sums in the other operand order) and a control (the
   patches or frames zeroed, which must lie past it); were the witness
   itself past one delta, phase 17's 6 / 2 gate instead; (b)
   ``generate()`` and phase 14's checks on both dense batchers (host ==
   device, launches exact: 4 ``paged_attention`` + 17 ``linear`` a step
   for internvl2, 4 + 25 for seamless, its cross-attention's query and
   wo counted; graph == eager, no sync in a round, the ring's wrap on the
   model's first 4 layers at full width); the
   enc-dec ``cross`` planes left zero, as the JAX package leaves them;
   internvl2 through phase 9's paged host batcher and phase 11's device
   batcher at C = 8 (bitwise the host batcher), and paged == dense on its
   first 4 layers; (c)
   seamless teacher-forced through ``decode_step`` with ``cross`` from
   ``encode_cross`` against (a)'s forward, (a)'s rule (the witness the
   plain path's decode against the plain forward, the control the zero
   planes: ROADMAP C.13); (d) ``make_train_step`` at full width and
   (a)'s depth, two steps of 4 x 64 tokens with their patches or frames in 2
   microbatches (launches exact, every master moved and finite but the
   enc-dec cross layers' unread ``ln2``), then at 2 layers, full width,
   kernel vs plain within phase 15's bounds; (e) tokens/s, ms and device
   ms a step by class and idle of the dense device batchers (and the
   paged one for internvl2), and three JSON rows: ``paged_attention`` at
   seamless's step (hd 64, 16:16, 16 x 1,024 ring cells past the wrap)
   and ``linear`` at both models' published steps (97 and 145 launches at
   M = 16, L2-cold) beside cuBLAS and their byte bounds.
20. MoE training and the dense configs the card had not run, after every
   earlier model is freed: (a) ``repro_torch.launch.train --arch
   qwen2-moe-a2.7b --layers 4`` at its defaults (20 steps of 8 x 64
   tokens, 2 microbatches) at full width: the loss improves, ``linear``
   launched exactly 20 x 2 x (2 x 6 x 4 + 1) and ``moe_down_combine`` 20 x
   2 x 2 x 4 times (forward and recomputed; its backward ``torch.bmm``)
   and nothing else; ms a step, tokens/s, device ms by class, idle, peak
   memory; (b) at 2 layers one step's loss and every gradient through the
   kernels and through the plain path held to the kernel path's routing
   (the would-be flips counted, each a near tie), phase 15's bounds, and
   ``moe_down_combine``'s backward alone on every layer's captured
   inputs and cotangent against autograd through its plain version within
   0.03; (c)-(e) minitron-4b (32 layers, d 3,072, 24 heads on 8 KV heads,
   vocab 256,000), gemma3-27b (62 layers, d 5,376, 32 on 16, ``qk_norm``,
   a window of 1,024 on five of every six layers, GELU, vocab 262,144)
   and qwen3-32b (64 layers, d 5,120, 64 on 8, ``qk_norm``, d_ff 25,600)
   at full width, their depth cut to 4, 6 (five local layers and a
   global one) and 8 layers, random weights, one at a time: their products
   through phase 8's ``linear`` checks; the dense host batcher == the
   dense device batcher bitwise with the launches exact; 4 served streams
   teacher-forced over 16 steps, kernel vs plain within phase 17's 6 / 2 deltas beside
   a witness and a control (the attention over a window of one position);
   a profiled round's launches exact and its device ms a step by class;
   the paged device batcher at C = 8 over phase 9's traffic, its captured
   step's launches exact; at 4 layers graph == eager, no sync in a round
   and paged == dense; for gemma3-27b at 6 layers (five local, one global)
   4 prompts of 1,100-1,400 tokens through the paged device batcher (cache
   2,048), chunk 8 == token by token, each layer's attention past position
   1,100 within one bf16 ulp of its plain version and each local layer's
   output moved by its window; six JSON rows: ``linear`` at each model's
   published dense step and ``paged_attention`` at 8:1 (qwen3-32b), 3:1
   (minitron-4b) and 2:1 past gemma3-27b's window.
21. elastic training, after every earlier model is freed: (a)
   ``remat_policy="dots"`` at qwen2-1.5b's published width and depth and
   the launcher's defaults (8 x 64 tokens, 2 microbatches): one step's
   loss and every gradient bitwise ``"full"``'s on the kernel path, 6
   steps of each bitwise, ``linear`` launched exactly 2 x (2 x 4 x 28 +
   1) = 450 a step under ``"full"`` and 2 x (4 x 28 + 1) = 226 under
   ``"dots"`` (the backward launches no product), at 4 layers ``"dots"``
   kernel vs plain within phase 15's 2e-3 / 0.03; ms a step (median of
   steps 2-5) and peak memory of both; (b) ``tests/test_elastic.py``'s
   drill at xlstm-125m's width, 2 of its 12 layers, 8 x 32 tokens in 2
   microbatches: ``slow:1:9.0:5@1, corrupt:manifest@6, lost:2@7`` over 4
   workers of 2 logical chips on the card (model parallel 2), 12 steps,
   checkpoints every 3: segments init / straggler / host-loss, 2 workers
   left, the fallback counted, ``linear`` launched exactly the executed
   steps x 22, both recovered segments bitwise their ``replay``; then
   ``launch.train --elastic --fault-plan preempt@4``: the drained
   checkpoint, the warm restart, every step; seconds a segment and the
   bytes of a checkpoint; (c) the GPipe step (``dist.pipeline``) at
   qwen2-1.5b's width, 4 layers in 2 stages, 4 microbatches: ``linear``
   exactly 4 x 17, the loss within 1e-6 relative of ``loss_fn``'s over the
   same microbatches and every gradient within 1e-5 of its largest
   magnitude; ms a step of both.
22. serving over a mesh of logical chips, right after phase 16 (it reuses
   phase 9's model, gate, ServeConfig and 32 requests): (a)
   ``ShardedServe`` on a 2x2 mesh of logical chips on the card (two data
   slices of 1x2, params replicated), paged: every request served or
   dropped once, FIFO within each shard, each shard's streams and drops
   bitwise a lone phase-11 device batcher fed its requests in order and
   phase 16's two mesh-less shards, and ``fused_eb``, ``paged_attention``
   and ``linear`` launched in the run (counts reset just before, read
   just after); (b) the same with ``tp_params=True``: routing, streams and
   drops bitwise (a)'s (ROADMAP C.19); tokens/s and ms a step of two warm
   waves of (a), (b) and the two mesh-less shards in turns; (c) ``launch.serve --arch qwen2-1.5b --continuous --router
   --mesh 2x2 --page-size 16`` with 8 requests in a child process: exit 0,
   2 shards; (d) ``launch.dryrun`` (in process, on the card) on
   ``xlstm-125m decode_32k``, ``qwen2-1.5b train_4k`` and
   ``recurrentgemma-9b long_500k --multi-pod``: each ``OK``, its bytes and
   FLOPs, and its arguments fit the card.

Bounds: bytes over 3.35 TB/s, or operations over the bf16 tensor-core
peak or the int32 lane rate (64 lanes an SM x the SMs x ``clocks.max.sm``,
printed on the first line beside the card; the float32 lanes are twice
as many).  ``--phase17`` builds the kernels and runs phase 17 alone, a
quick MoE run that prints no result line; ``--phase18``, ``--phase19``,
``--phase20``, ``--phase21`` and ``--phase22`` the same for phases 18,
19, 20, 21 and 22 (``--phase22`` builds phase 9's model without its
host-batcher run).
Each phase prints how far into the run it starts.

Its last three lines are the kernels JSON (phases 18-20's
``paged_attention`` and ``linear`` rows last, each with its ``cell``), the
card's ``name, power.limit``
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 1 << 20  # flows per main-path predict
CHUNK = 1 << 16  # rows per plain-version chunk on the card
INT32_MAX = np.iinfo(np.int32).max
# H100 SXM published peak (NVIDIA data sheet): HBM3 bytes/s.
PEAK_BYTES = 3.35e12
# int32 operations/s: Hopper has 64 INT32 lanes an SM (half its 128 FP32
# lanes), so 64 x the SMs x the SM clock nvidia-smi reports as its maximum;
# ``main`` sets it from the card (16.7e12 on an NVIDIA H100 80GB HBM3 at
# 700.00 W, whose clocks.max.sm is 1980 MHz).
INT32_LANES_PER_SM = 64
PEAK_INT32_OPS = 0.0
# float32 FLOP/s outside the tensor cores: 128 lanes an SM, an fmaf 2 flops
# (66.9e12 on the same card); ``main`` sets it beside the int32 peak
FP32_LANES_PER_SM = 128
PEAK_FP32_FLOPS = 0.0
SOURCE = "src/repro_torch/kernels/csrc/eb_kernels.cu"
LB_DM_SOURCE = "src/repro_torch/kernels/csrc/lb_dm_kernels.cu"
PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
LINEAR_SOURCE = "src/repro_torch/kernels/csrc/linear.cu"
MOE_SOURCE = "src/repro_torch/kernels/csrc/moe.cu"
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s
PEAK_BF16_FLOPS = 989e12
REPLACES = {
    "bucketize": "src/repro/kernels/bucketize.py:32",
    "ternary_match": "src/repro/kernels/ternary_match.py:53",
    "fused_eb": "src/repro/kernels/fused_eb.py:66",
    "lb_lookup": "src/repro/kernels/lb_lookup.py:39",
    "bnn_popcount_matmul": "src/repro/kernels/bnn_mlp.py:33",
    "paged_attention": "src/repro/kernels/paged_attention.py:107",
    # no Pallas kernel: the step's products are XLA dots in the JAX package
    # (attention.py:57-59 and :289, mlp.py:24-25, arch/model.py:330)
    "linear": "src/repro/nn/attention.py:57",
    # no Pallas kernel: the MoE block's two XLA einsums (nn/moe.py:73-75)
    "moe_down_combine": "src/repro/nn/moe.py:73",
}
LB_MODELS = ("svm", "nb", "kmeans", "pca", "ae")


def peak_int32_ops(dev) -> float:
    """INT32_LANES_PER_SM x the card's SMs x ``clocks.max.sm`` (Hz)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=30).stdout
    mhz = float(out.splitlines()[0].strip())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def i32(a: np.ndarray, dev) -> torch.Tensor:
    """numpy array (uint32 words as their int32 bits) -> int32 on ``dev``."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.astype(np.int32, copy=False), device=dev)


def same(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        fail(f"{name}: kernel differs from its plain version ({bad})")


# ----------------------------------------------------------- phase 2 cases
def rand_rows(rng, N, W, n_keys):
    values = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    values &= masks
    pa = (np.arange(N, dtype=np.int32) * 256
          + rng.integers(0, 256, N).astype(np.int32))
    keys = rng.integers(0, 2**32, (n_keys, W), dtype=np.uint32)
    keys[: n_keys // 2] = values[rng.integers(0, N, n_keys // 2)]
    return keys, values, masks, pa


def check_kernels(dev) -> int:
    from test_torch_cuda import _lb_out_of_range_case, _unsorted_bucketize_case

    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(42)
    n = 0
    # bucketize: test sweep, INT32_MAX against padding; T = 1, T not a
    # power of two, rows past 48 KB (opt-in, 64 KB) and past the shared-
    # memory budget (read through L1, 256 KB), many persistent strides; a
    # view at an unaligned offset (element by element)
    cases = [(B, F, T) for B in (1, 7, 256, 1000)
             for F, T in ((1, 1), (5, 9), (8, 32))] + [
                 (3000, 8, 2000), (BATCH + 3, 5, 1), (100003, 5, 37),
                 (20001, 8, 8000)]
    for B, F, T in cases:
        vals = rng.integers(0, 2**16, (B + 1, F)).astype(np.int32)
        thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
        thr[:, T // 2:] = INT32_MAX  # padded tail
        vals[:2, 0] = INT32_MAX
        vals[::7, -1] = INT32_MAX
        vals[1::5, 0] = -3
        big, t = i32(vals, dev), i32(thr, dev)
        for name, v in (("", big[:B]), (" view at an offset", big[1:])):
            same(f"bucketize {B}x{F}x{T}{name}", ops.bucketize(v, t),
                 chunked(lambda c: ref.bucketize_ref(c, t), v))
            n += 1
    # bucketize on rows in any order (compare-counted): [5, 3, INT32_MAX],
    # a reversed row, ties; rows in shared memory and through L1
    for B, T in ((1000, 3), (300001, 28), (5000, 8000)):
        vals, thr = _unsorted_bucketize_case(T, B, T)
        v, t = i32(vals, dev), i32(thr, dev)
        same(f"bucketize {B}x{thr.shape[0]}x{T}, rows in any order",
             ops.bucketize(v, t), chunked(lambda c: ref.bucketize_ref(c, t), v))
        n += 1
    # ternary_match: test sweep, W = 3 and 5 (run-time word count), N
    # beyond one shared-memory tile and not a multiple of any tile, B = 1
    for B, N, W in ((1, 1, 1), (64, 100, 1), (200, 700, 2), (33, 513, 3),
                    (1, 700, 2), (1000, 5000, 3), (300, 301, 5)):
        k, v, m, pa = (i32(a, dev) for a in rand_rows(rng, N, W, B))
        same(f"ternary_match {B}x{N}x{W}", ops.ternary_match(k, v, m, pa, 254),
             ref.ternary_match_ref(k, v, m, pa, 254))
        n += 1
    # overlapping rows: the higher priority wins
    v = i32(np.array([[0b1000], [0b1000]], np.uint32), dev)
    pa = i32(np.array([0 * 256 + 7, 1 * 256 + 9], np.int32), dev)
    k = i32(np.array([[0b1010]], np.uint32), dev)
    got = ops.ternary_match(k, v, v, pa, 0)
    same("ternary_match priority", got, ref.ternary_match_ref(k, v, v, pa, 0))
    if got.item() != 9:
        fail(f"ternary_match priority: got {got.item()}, want 9")
    # no row matches: the default action
    v = i32(np.array([[0xFFFFFFFF]], np.uint32), dev)
    k = i32(np.array([[3]], np.uint32), dev)
    pa = i32(np.array([5], np.int32), dev)
    got = ops.ternary_match(k, v, v, pa, 123)
    if got.item() != 123:
        fail(f"ternary_match default: got {got.item()}, want 123")
    n += 2
    # fused_eb: encode + pack + match, thresholds in and beyond the shared
    # staging budget, rows beyond one tile, identity codes, B = 1
    for B, F, T, N, identity in ((1, 5, 12, 201, False),
                                 (1000, 5, 28, 540, False),
                                 (777, 8, 600, 3000, False),
                                 (513, 5, 1, 1024, True)):
        if identity:
            widths = [8] * F
            vals = rng.integers(0, 256, (B, F)).astype(np.int32)
            thr = np.full((F, T), INT32_MAX, np.int32)
        else:
            vals = rng.integers(0, 2**16, (B, F)).astype(np.int32)
            vals[0, -1] = INT32_MAX
            thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
            thr[:, -1] = INT32_MAX
            widths = [max(1, int(np.ceil(np.log2(T + 1))))] * F
        layout = key_layout(widths)
        W = max(w for w, _, _ in layout) + 1
        lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
        x, t = i32(vals, dev), i32(thr, dev)
        codes = x if identity else ref.bucketize_ref(x, t)
        keys = ref.pack_codes_ref(codes, layout, W).cpu().numpy().view(np.uint32)
        _, rv, rm, pa = rand_rows(rng, N, W, 0)
        hit = rng.integers(0, B, N // 2)
        rv[: N // 2] = keys[hit] & rm[: N // 2]
        rv, rm, pa = i32(rv, dev), i32(rm, dev), i32(pa, dev)
        same(f"fused_eb {B}x{F}x{T} N={N} identity={identity}",
             ops.fused_eb_match(x, t, rv, rm, pa, lay, 77, identity),
             ref.fused_eb_ref(x, t, rv, rm, pa, lay, 77, identity))
        n += 1
    # lb_lookup: the JAX sweep, the 48 KB shared-memory edge, and a LUT
    # past it that is read through the cache
    for B, F, V, K in ((1, 1, 2, 1), (100, 5, 64, 6), (257, 3, 256, 16),
                       (3000, 8, 256, 16), (70000, 5, 256, 3)):
        codes = i32(rng.integers(0, V, (B, F)), dev)
        luts = i32(rng.integers(-(2**15), 2**15, (F, V, K)), dev)
        same(f"lb_lookup {B}x{F}x{V}x{K}", ops.lb_lookup(codes, luts),
             ref.lb_lookup_ref(codes, luts))
        n += 1
    # lb_lookup: codes outside [0, V) add 0; LUT in shared memory (past
    # 48 KB: opted in) and past the card's 227 KB (through the cache)
    for B, F, V, K in ((100, 5, 64, 6), (3000, 8, 256, 16), (2049, 5, 256, 3),
                       (5000, 8, 1024, 8)):
        codes, luts = (i32(a, dev)
                       for a in _lb_out_of_range_case(B, B, F, V, K))
        same(f"lb_lookup {B}x{F}x{V}x{K}, codes outside [0, V)",
             ops.lb_lookup(codes, luts), ref.lb_lookup_ref(codes, luts))
        n += 1
    n += check_lb_modes(rng, dev)
    # bnn_popcount_matmul: the JAX sweep (n_in bits -> words), words with
    # bit 31 set, and a batch of many tiles
    for B, n_in, N in ((1, 1, 1), (64, 40, 16), (100, 100, 3), (17, 64, 33),
                       (70001, 40, 48)):
        W = -(-n_in // 32)
        x = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
        w = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
        x[0, 0] |= np.uint32(1 << 31)
        w[0, -1] |= np.uint32(1 << 31)
        x, w = i32(x, dev), i32(w, dev)
        same(f"bnn_popcount_matmul {B}x{W} N={N}",
             ops.bnn_popcount_matmul(x, w), ref.bnn_popcount_matmul_ref(x, w))
        n += 1
    n += check_bnn_modes(rng, dev)
    torch.cuda.synchronize(dev)
    return n


# (B, F, V, K) of the lb_lookup predict-mode grid: the sums grid above,
# the main path's shape past many tiles a block, K past the register cap
# (13, 16), LUTs past 48 KB (128 KB, opted-in shared memory) and past 227 KB
# (256 KB, through the cache)
LB_MODE_GRID = ((1, 1, 2, 1), (100, 5, 64, 6), (257, 3, 256, 16),
                (3000, 8, 256, 16), (70000, 5, 256, 3), (BATCH + 3, 5, 256, 3),
                (BATCH + 1, 5, 256, 2), (20001, 4, 16, 13), (5000, 8, 1024, 8))
LB_MODES = ("argmax", "argmin", "ovo_vote", "raw")


def check_lb_modes(rng, dev) -> int:
    """lb_lookup's predict modes against their plain versions: labels
    bitwise, raw within 1e-5; raw features in and outside [0, V), a bias
    add that wraps, sums that tie, one-vs-one pairs of the fewest classes
    that give K of them."""
    from test_torch_cuda import _lb_predict_case

    from repro_torch.kernels import ops, ref

    n = 0
    for B, F, V, K in LB_MODE_GRID:
        n_classes = next(c for c in range(2, 64) if c * (c - 1) // 2 >= K)
        x, luts, bias, pairs = (i32(a, dev) for a in _lb_predict_case(
            int(rng.integers(2**31)), B, F, V, K, n_classes))
        for mode in LB_MODES:
            kw = dict(bias=bias, scale=0.37)
            if mode == "ovo_vote":
                kw.update(pairs=pairs, n_classes=n_classes)
            got = ops.lb_lookup(x, luts, mode, **kw)
            want = chunked(lambda c: ref.lb_lookup_ref(c, luts, mode, **kw),
                           x)
            name = f"lb_lookup {B}x{F}x{V}x{K} {mode}"
            if mode == "raw":
                if (got.dtype != torch.float32 or got.shape != want.shape
                        or not torch.allclose(got, want, rtol=1e-5,
                                              atol=1e-5)):
                    fail(f"{name}: kernel differs from its plain version")
            else:
                same(name, got, want)
            n += 1
    return n


# W -> (in_bits, F) of a feature input that packs into W words
BNN_FEATURES = {1: (8, 3), 2: (8, 5), 3: (7, 13), 4: (5, 25), 10: (9, 35)}


def check_bnn_modes(rng, dev, B: int = 600001) -> int:
    """bnn_popcount_matmul's modes against their plain versions: packed or
    feature input (prologue) x counts, sign words or scores, at W 1-4 (one
    vector load) and 10 (run-time chunks), N a multiple of 4 and not, B
    past many persistent strides; features past in_bits and negative."""
    from repro_torch.kernels import ops, ref

    n = 0
    for W, (in_bits, F) in BNN_FEATURES.items():
        for N in (48, 33):
            w = i32(rng.integers(0, 2**32, (N, W), dtype=np.uint32), dev)
            feats = rng.integers(0, 2**in_bits, (B, F)).astype(np.int32)
            feats[::11] = rng.integers(-2**31, 2**31, (len(feats[::11]), F))
            packed = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
            for x, bits, n_in in ((i32(packed, dev), 0, 32 * W - 5),
                                  (i32(feats, dev), in_bits, F * in_bits)):
                for ep in ("counts", "sign", "score"):
                    same(f"bnn_popcount_matmul {B}x{W} N={N} in_bits={bits}"
                         f" {ep}",
                         ops.bnn_popcount_matmul(x, w, bits, ep, n_in),
                         chunked(lambda c: ref.bnn_popcount_matmul_ref(
                             c, w, bits, ep, n_in), x))
                    n += 1
    return n


# ------------------------------------------------------- phases 3 and 4
@dataclasses.dataclass
class PathRun:
    res: Any  # PlanterResult
    x: torch.Tensor  # the flows on the card
    fn: Callable  # the "auto" predictor
    plain: Callable  # the same tables through the plain versions
    backend: str
    launches: Dict[str, int]  # kernel launches of the one main-path predict


def drive(size: str, dev, batch: int) -> PathRun:
    """plant rf-EB of ``size``; predict ``batch`` flows through ``auto``."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops

    ds = load_dataset("unsw", n=6000)
    res = plant(PlanterConfig(model="rf", strategy="eb", size=size,
                              device=str(dev)),
                ds.X_train, ds.y_train, ds.X_test)
    rng = np.random.default_rng(SEED)
    flows = ds.X_test[rng.integers(0, len(ds.X_test), batch)]
    x = torch.as_tensor(flows.astype(np.int32), device=dev)
    backend = res.mapped.select_backend(dev)
    fn = res.mapped.torch_predict("auto", device=dev)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    labels = fn(x)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    plain = res.mapped.torch_predict("ref", device=dev)
    want = torch.cat([plain(x[i:i + CHUNK]) for i in range(0, batch, CHUNK)])
    same(f"rf-{size} {backend} labels", labels, want)
    head = flows[:CHUNK]
    got = labels[:CHUNK].cpu().numpy()
    if not np.array_equal(got, res.mapped.predict(head)):
        fail(f"rf-{size}: labels differ from the numpy reference")
    if not np.array_equal(got, res.trained.predict(head)):
        fail(f"rf-{size}: labels differ from the native forest")
    return PathRun(res, x, fn, plain, backend, counts)


def chunked(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``x`` in CHUNK-row pieces (the plain versions' memory)."""
    return torch.cat([fn(x[i:i + CHUNK]) for i in range(0, x.shape[0], CHUNK)])


def flows(ds, dev, batch: int):
    """``batch`` flows drawn from the test split with ``default_rng(SEED)``:
    (numpy int64, int32 on ``dev``)."""
    rng = np.random.default_rng(SEED)
    f = ds.X_test[rng.integers(0, len(ds.X_test), batch)]
    return f, torch.as_tensor(f.astype(np.int32), device=dev)


def drive_lb(dev, batch: int) -> Dict[str, PathRun]:
    """plant each LB model at size L; predict ``batch`` flows through
    ``auto`` with the launch counts set to 0 just before and read after."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops, ref

    ds = load_dataset("unsw", n=6000)
    head, x = flows(ds, dev, batch)
    head = head[:CHUNK]
    runs = {}
    for model in LB_MODELS:
        y = None if model in ("kmeans", "pca", "ae") else ds.y_train
        res = plant(PlanterConfig(model=model, strategy="lb", size="L",
                                  device=str(dev)), ds.X_train, y, ds.X_test)
        backend = res.mapped.select_backend(dev)
        fn = res.mapped.torch_predict("auto", device=dev)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        if counts["lb_lookup"] != 1 or sum(counts.values()) != 1:
            fail(f"{model}-LB predict launched {counts}, want one lb_lookup")
        plain = res.mapped.torch_predict("ref", device=dev)
        want = chunked(plain, x)
        lb = res.mapped.predict_np.__self__
        if lb.mode == "raw":
            # the int32 sums bitwise, then the dequantized float32 outputs
            luts = torch.as_tensor(np.ascontiguousarray(lb.luts), device=dev)
            codes = x.clamp(0, lb.luts.shape[1] - 1)
            same(f"{model}-LB sums", ops.lb_lookup(codes, luts),
                 chunked(lambda c: ref.lb_lookup_ref(c, luts), codes))
            if out.dtype != torch.float32 or not torch.allclose(
                    out, want, rtol=1e-5, atol=1e-5):
                fail(f"{model}-LB outputs differ from the plain path")
            if not np.allclose(out[:CHUNK].cpu().numpy(),
                               res.mapped.predict(head), rtol=1e-5, atol=1e-5):
                fail(f"{model}-LB outputs differ from the numpy reference")
        else:
            same(f"{model}-LB labels", out, want)
            if not np.array_equal(out[:CHUNK].cpu().numpy(),
                                  res.mapped.predict(head)):
                fail(f"{model}-LB labels differ from the numpy reference")
        runs[model] = PathRun(res, x, fn, plain, backend, counts)
    return runs


def drive_dm(dev, batch: int) -> Dict[str, PathRun]:
    """bnn-DM size L through ``auto`` (two ``bnn_popcount_matmul``
    launches), and dt/rf-DM size L through their plain-torch walk."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops

    ds = load_dataset("unsw", n=6000)
    head, x = flows(ds, dev, batch)
    head = head[:CHUNK]
    runs = {}
    for model in ("bnn", "dt", "rf"):
        res = plant(PlanterConfig(model=model, strategy="dm", size="L",
                                  device=str(dev)),
                    ds.X_train, ds.y_train, ds.X_test)
        backend = res.mapped.select_backend(dev)
        fn = res.mapped.torch_predict("auto", device=dev)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        labels = fn(x)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        kernel = 2 if model == "bnn" else 0
        if (counts["bnn_popcount_matmul"] != kernel
                or sum(counts.values()) != kernel):
            fail(f"{model}-DM predict launched {counts}, want {kernel} "
                 "bnn_popcount_matmul")
        plain = res.mapped.torch_predict("ref", device=dev)
        if model == "bnn":
            same("bnn-DM labels", labels, chunked(plain, x))
        got = labels[:CHUNK].cpu().numpy()
        if not np.array_equal(got, res.mapped.predict(head)):
            fail(f"{model}-DM labels differ from the numpy reference")
        if not np.array_equal(got, res.trained.predict(head)):
            fail(f"{model}-DM labels differ from the native model")
        runs[model] = PathRun(res, x, fn, plain, backend, counts)
    return runs


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, spins: bool = False):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler (CUPTI): the card's own time, without the host's launch
    overhead that a single call's CUDA events also span while the card
    idles.  With ``spins`` the window opens with ``open_window``'s spin
    kernels, not counted, which absorb the records the profiler drops at
    a window's start.  None when the profiler saw no kernel in three
    windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if spins:
                open_window(torch.device("cuda"))
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation and "spin_kernel" not in e.key)
        if us > 0:
            return us / reps / 1e3
    return None


def kernel_ms(fn, key: str, reps: int = 10):
    """Mean device time of one launch of the kernel whose name holds
    ``key``, over the launches the profiler recorded of ``reps`` calls of
    ``fn`` (a window opened with ``open_window``): unlike ``device_ms``,
    a record the profiler drops lowers the count, not the mean.  None
    when it recorded none in three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window(torch.device("cuda"))
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key]
        n = sum(e.count for e in got)
        if n:
            return sum(e.self_device_time_total for e in got) / n / 1e3
    return None


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_rows(staged, fused, dev):
    """Time each kernel at its main-path shapes (largest table)."""
    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    rows = []
    for name, run in (("bucketize", staged), ("ternary_match", staged),
                      ("fused_eb", fused)):
        x = run.x
        ens = run.res.mapped.predict_np.__self__
        thr, tbls = ens.device_tables(dev)
        rv, rm, pa, d = max(tbls, key=lambda t: t[0].shape[0])
        layout = key_layout(ens.widths)
        B, F = x.shape
        T = thr.shape[1]
        N, W = rv.shape
        library_ms = library_device_ms = None
        if name == "bucketize":
            args = (x, thr)
            kern, plain = ops.bucketize, ref.bucketize_ref
            n_bytes, n_ops = 2 * B * F * 4 + F * T * 4, B * F * T
            vt = x.T.contiguous()
            library_ms = time_ms(lambda: torch.searchsorted(thr, vt, right=True))
            library_device_ms = device_ms(
                lambda: torch.searchsorted(thr, vt, right=True))
        elif name == "ternary_match":
            keys = ref.pack_codes_ref(ref.bucketize_ref(x, thr), layout, W)
            args = (keys, rv, rm, pa, d)
            kern, plain = ops.ternary_match, ref.ternary_match_ref
            n_bytes = B * W * 4 + N * (2 * W + 1) * 4 + B * 4
            n_ops = B * N * (2 * W + 2)
        else:
            lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
            args = (x, thr, rv, rm, pa, lay, d)
            kern, plain = ops.fused_eb_match, ref.fused_eb_ref
            n_bytes = B * F * 4 + F * T * 4 + N * (2 * W + 1) * 4 + B * 4
            n_ops = B * F * T + B * N * (2 * W + 2)
        got, want = kern(*args), plain(*args)
        same(f"{name} at main-path shapes", got, want)
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": run.launches[name],
            "bitwise": True, "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args)),
            "device_ms": device_ms(lambda: kern(*args)),
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": {"B": B, "F": F, "T": T, "N": N, "W": W},
        })
    return rows


def lb_dm_kernel_rows(lb_runs, dm_runs, dev):
    """Time ``lb_lookup`` on kmeans-LB L (the widest K) and
    ``bnn_popcount_matmul`` on BNN-L layer 1, at 2^20 flows."""
    from repro_torch.kernels import ops, ref

    rows = []
    run = lb_runs["kmeans"]
    lb = run.res.mapped.predict_np.__self__
    luts = torch.as_tensor(np.ascontiguousarray(lb.luts), device=dev)
    F, V, K = luts.shape
    codes = run.x.clamp(0, V - 1)
    B = codes.shape[0]
    offsets = torch.arange(F, device=dev) * V
    bag = (codes.long() + offsets).contiguous()
    weight = luts.reshape(F * V, K).float()
    rows.append(dict(
        name="lb_lookup", args=(codes, luts), kern=ops.lb_lookup,
        plain=ref.lb_lookup_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * F * 4 + F * V * K * 4 + B * K * 4, n_ops=B * F * K,
        library=lambda: torch.nn.functional.embedding_bag(bag, weight,
                                                          mode="sum"),
        shape={"B": B, "F": F, "V": V, "K": K, "mode": "sums"}))
    # the predict's own launch: raw features in, the argmin label out
    fused_args = lb_fused_args(lb, run.x, dev)
    rows.append(dict(
        name="lb_lookup", args=fused_args, kern=ops.lb_lookup,
        plain=ref.lb_lookup_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * F * 4 + F * V * K * 4 + K * 4 + B * 4,
        n_ops=B * K * (F + 2) + 2 * B * F, library=None,
        shape={"B": B, "F": F, "V": V, "K": K, "mode": f"{lb.mode} (fused)"}))

    run = dm_runs["bnn"]
    bnn = run.res.mapped.predict_np.__self__
    (w, n_in), (w2, n_in2) = bnn_layers(bnn, dev)
    shifts = torch.arange(bnn.in_bits, dtype=torch.int32, device=dev)
    bits = ((run.x[..., None] >> shifts) & 1).reshape(B, -1)
    x = ops.pack_bits(bits)
    N, W = w.shape
    N2, W2 = w2.shape
    F = run.x.shape[1]
    x_pm = (bits * 2 - 1).to(torch.bfloat16)
    w_pm = torch.as_tensor(run.res.trained.binary_weights()[0].T,
                           dtype=torch.bfloat16, device=dev).contiguous()
    rows.append(dict(
        name="bnn_popcount_matmul", args=(x, w), kern=ops.bnn_popcount_matmul,
        plain=ref.bnn_popcount_matmul_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * W * 4 + N * W * 4 + B * N * 4, n_ops=B * N * W * 4,
        library=lambda: torch.matmul(x_pm, w_pm.T),
        shape={"B": B, "W": W, "N": N, "n_in": n_in, "mode": "counts"}))
    # the predict's own launches: layer 1 builds its input words from the
    # features and packs its signs, layer 2 writes the scores
    h = ops.bnn_popcount_matmul(run.x, w, bnn.in_bits, "sign", n_in)
    fused = [
        dict(layer=1, args=(run.x, w, bnn.in_bits, "sign", n_in),
             n_bytes=B * F * 4 + N * W * 4 + B * -(-N // 32) * 4,
             n_ops=B * N * W * 4,
             shape={"B": B, "F": F, "in_bits": bnn.in_bits, "W": W, "N": N,
                    "mode": "features -> sign words"}),
        dict(layer=2, args=(h, w2, 0, "score", n_in2),
             n_bytes=B * W2 * 4 + N2 * W2 * 4 + B * N2 * 4,
             n_ops=B * N2 * W2 * 4,
             shape={"B": B, "W": W2, "N": N2, "mode": "packed -> scores"})]

    out = []
    for r in rows:
        kern, plain, args = r["kern"], r["plain"], r["args"]
        got = kern(*args)
        want = chunked(lambda a: plain(a, *args[1:]), args[0])
        same(f"{r['name']} at main-path shapes", got, want)
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        b_ms, b_by = bound_ms(r["n_bytes"], r["n_ops"])
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": REPLACES[r["name"]],
            "launches": r["run"].launches[r["name"]],
            "bitwise": True, "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args)),
            "device_ms": device_ms(lambda: kern(*args)),
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(r["library"]) if r["library"] else None,
            "library_device_ms": device_ms(r["library"]) if r["library"]
            else None, "shape": r["shape"], "n_bytes": r["n_bytes"],
            "n_ops": r["n_ops"],
        })
    out[-1]["fused"] = [fused_layer_row(f) for f in fused]
    return out


def bnn_layers(bnn, dev):
    """The DM-BNN's packed layers on ``dev``: [(w [N, W] int32, n_in)]."""
    return [(torch.as_tensor(np.ascontiguousarray(w).view(np.int32),
                             device=dev), int(n_in))
            for w, n_in in bnn.packed.layers]


def fused_layer_row(f) -> Dict[str, Any]:
    """One fused bnn_popcount_matmul launch of the predict against its
    plain version, bitwise, and timed beside its bound."""
    from repro_torch.kernels import ops, ref

    args = f["args"]
    got = ops.bnn_popcount_matmul(*args)
    want = chunked(lambda a: ref.bnn_popcount_matmul_ref(a, *args[1:]),
                   args[0])
    same(f"bnn_popcount_matmul layer {f['layer']} ({f['shape']['mode']})",
         got, want)
    b_ms, b_by = bound_ms(f["n_bytes"], f["n_ops"])
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    return {"layer": f["layer"], "max_abs_err": err,
            "ms": time_ms(lambda: ops.bnn_popcount_matmul(*args)),
            "device_ms": device_ms(lambda: ops.bnn_popcount_matmul(*args)),
            "plain_ms": time_ms(lambda: ref.bnn_popcount_matmul_ref(*args),
                                reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "shape": f["shape"]}


def lb_fused_args(lb, x, dev):
    """The arguments of the LB predict's one ``lb_lookup`` launch: the raw
    features, then the model's luts, mode, bias, pairs, classes and scale
    on ``dev``."""
    return (x, *lb.kernel_args(dev))


def device_kernels(fn, calls: int = 5, tries: int = 3, want=None):
    """{kernel name: launches} on the card over ``calls`` calls of ``fn``
    (torch.profiler), each window opened with uncounted spin kernels
    (``open_window``: the profiler drops a window's first device
    records), asked up to ``tries`` times while the profiler sees no
    kernel, or fewer launches of a kernel than ``want`` ({name part:
    launches}) asks; a count over ``want`` is returned at once.  Empty
    when it never sees one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window(None)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and "spin_kernel" not in e.key}
        short = want and any(
            sum(n for k, n in seen.items() if part in k) < n_want
            for part, n_want in want.items())
        if seen and not short:
            return seen
    return seen


def check_lb_one_kernel(model: str, run: PathRun, calls: int = 5) -> str:
    """An LB predict on an int32 input on the card runs exactly one device
    kernel, the lb_lookup kernel (profiler; ``calls`` predicts; a short
    count, the profiler's dropped records, is profiled again, never
    accepted)."""
    seen = device_kernels(lambda: run.fn(run.x), calls,
                          want={"lb_lookup_kernel": calls})
    if not seen:
        return "device kernels not measured (the profiler saw none)"
    if (len(seen) != 1 or "lb_lookup_kernel" not in next(iter(seen))
            or next(iter(seen.values())) != calls):
        fail(f"{model}-LB predict ran {seen} on the card over {calls} calls, "
             "want one lb_lookup kernel a call")
    name, count = next(iter(seen.items()))
    return f"one device kernel a predict ({count} in {calls}: {name[:60]})"


def lb_dm_kernels_only(run: PathRun, dev) -> Callable:
    """The LB / DM-BNN predict's kernel launches alone, on the inputs that
    predict gives them (the LB predict's one fused launch on the raw
    features; the features into layer 1, which packs its signs, and those
    words into the last layer's scores)."""
    from repro_torch.kernels import ops

    model = run.res.mapped.predict_np.__self__
    if run.res.mapped.strategy == "lb":
        args = lb_fused_args(model, run.x, dev)
        return lambda: ops.lb_lookup(*args)
    args, h = [], run.x
    layers = bnn_layers(model, dev)
    for i, (w, n_in) in enumerate(layers):
        last = i == len(layers) - 1
        args.append((h, w, model.in_bits if i == 0 else 0,
                     "score" if last else "sign", n_in))
        h = ops.bnn_popcount_matmul(*args[-1])
    return lambda: [ops.bnn_popcount_matmul(*a) for a in args]


def flows_per_s(fn, x) -> float:
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return x.shape[0] / statistics.median(runs)


def kernels_only(run: PathRun, dev) -> Callable:
    """The path's kernel launches for one predict, without the plain-torch
    packing, stacking and combine around them (same inputs)."""
    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    ens = run.res.mapped.predict_np.__self__
    thr, tbls = ens.device_tables(dev)
    layout = key_layout(ens.widths)
    if run.backend == "cuda_fused":
        lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
        return lambda: [ops.fused_eb_match(run.x, thr, v, m, pa, lay, d)
                        for v, m, pa, d in tbls]
    n_words = tbls[0][0].shape[1]
    keys = ref.pack_codes_ref(ref.bucketize_ref(run.x, thr), layout, n_words)
    return lambda: [ops.bucketize(run.x, thr)] + [
        ops.ternary_match(keys, v, m, pa, d) for v, m, pa, d in tbls]


# ------------------------------------------------- phase 8: paged_attention
def pa_case(rng, dev, B, C, H, KV, hd, page, n_ps, quantized, past=True):
    """q, pools (bf16, or int8 with float32 scales), a shuffled block table
    (with entries past the pool when ``past``) and positions, on ``dev``."""
    N = B * n_ps
    q = torch.as_tensor(rng.normal(0, 1, (B, C, H, hd)), dtype=torch.bfloat16,
                        device=dev)
    tbl = rng.permutation(N).reshape(B, n_ps).astype(np.int32)
    if past:
        tbl[0, -1] = N + 3
        tbl[-1, 0] = N
    pos0 = rng.integers(0, n_ps * page - C + 1, B)
    pos = (pos0[:, None] + np.arange(C)[None]).astype(np.int32)
    shape = (N, page, KV, hd)
    if quantized:
        pools = [torch.as_tensor(rng.integers(-127, 128, shape),
                                 dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.as_tensor(rng.uniform(0.005, 0.02, shape[:-1] + (1,)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2)]
    else:
        pools = [torch.as_tensor(rng.normal(0, 1, shape),
                                 dtype=torch.bfloat16, device=dev)
                 for _ in range(2)]
        scales = [None, None]
    return (q, pools[0], pools[1], torch.as_tensor(tbl, device=dev),
            torch.as_tensor(pos, device=dev), scales[0], scales[1])


def bf16_ulp(want: torch.Tensor) -> float:
    """One bf16 ulp of ``want``'s largest magnitude: the kernel's limit
    against its plain version (both round to bf16 at the same places
    after float32 sums taken in other orders)."""
    m = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def pa_err_ulps(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of max |want|; fail past one."""
    err = (got.float() - want.float()).abs().max().item()
    ulp = bf16_ulp(want)
    if not torch.isfinite(got).all() or not err <= ulp:
        fail(f"{name}: kernel differs from its plain version by {err} > one "
             f"bf16 ulp ({ulp})")
    return err / ulp if ulp else 0.0


def check_paged_attention(dev) -> str:
    """Kernel vs plain over the case grid, then the four invariances."""
    from test_torch_cuda import _overwrite_past as overwrite_past

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(7)
    n, worst = 0, 0.0
    for C in (1, 8):
        for page, n_ps in ((16, 6), (8, 12)):
            for H, KV in ((12, 2), (4, 4)):
                for quantized in (False, True):
                    for window in (0, 13):
                        args = pa_case(rng, dev, 3, C, H, KV, 128, page, n_ps,
                                       quantized)
                        q, k, v, tbl, pos, ks, vs = args
                        worst = max(worst, pa_err_ulps(
                            f"paged_attention C={C} page={page} H={H} KV={KV} "
                            f"int8={quantized} window={window}",
                            ops.paged_attention(q, k, v, tbl, pos, window, ks,
                                                vs),
                            ref.paged_attention_ref(q, k, v, tbl, pos, window,
                                                    ks, vs)))
                        n += 1
    # a row at position -1 sees no key: the oracle's full-axis softmax
    for C in (1, 8):
        q, k, v, tbl, pos, ks, vs = pa_case(rng, dev, 3, C, 12, 2, 128, 16, 6,
                                            False)
        pos[0] = torch.arange(-1, C - 1, dtype=torch.int32, device=dev)
        worst = max(worst, pa_err_ulps(
            f"paged_attention C={C} with a row at position -1",
            ops.paged_attention(q, k, v, tbl, pos, 13),
            ref.paged_attention_ref(q, k, v, tbl, pos, 13)))
        n += 1
    # the dense cache's ring: one layer [B, S, KV, hd] read as B pages of
    # S positions; rows past the wrap (a window inside one lap and one
    # wrapping round cell 0) within one bf16 ulp, rows below it bitwise
    # the launch without the ring
    S, n_ring = DENSE["cache_len"], 0
    for quantized in (False, True):
        for window in (0, 13):
            q, k, v, tbl, pos, ks, vs = pa_case(rng, dev, 4, 1, 12, 2, 128,
                                                S, 1, quantized, past=False)
            pos = torch.tensor([[S], [S + 7], [2 * S + 300], [3 * S + 12]],
                               dtype=torch.int32, device=dev)
            worst = max(worst, pa_err_ulps(
                f"paged_attention ring int8={quantized} window={window}",
                ops.paged_attention(q, k, v, tbl, pos, window, ks, vs,
                                    ring=True),
                ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs,
                                        ring=True)))
            pos = torch.tensor([[0], [12], [300], [S - 1]], dtype=torch.int32,
                               device=dev)
            same(f"paged_attention ring below the wrap int8={quantized} "
                 f"window={window}",
                 ops.paged_attention(q, k, v, tbl, pos, window, ks, vs,
                                     ring=True),
                 ops.paged_attention(q, k, v, tbl, pos, window, ks, vs))
            n_ring += 1
    # the invariances, bitwise, at the serve decode shape
    B, H, KV, hd, page, n_ps = 16, 12, 2, 128, 16, 64
    q, k, v, tbl, pos, _, _ = pa_case(rng, dev, B, 1, H, KV, hd, page, n_ps,
                                      False)
    full = ops.paged_attention(q, k, v, tbl, pos, 0)
    for b in (0, 7, 15):  # a slot alone vs in the batch of 16
        alone = ops.paged_attention(q[b:b + 1].contiguous(), k, v,
                                    tbl[b:b + 1].contiguous(),
                                    pos[b:b + 1].contiguous(), 0)
        same(f"paged_attention slot {b} alone vs in a batch of {B}",
             alone[0], full[b])
    q8, k8, v8, tbl8, pos8, _, _ = pa_case(rng, dev, 4, 8, H, KV, hd, page,
                                           n_ps, False)
    chunk = ops.paged_attention(q8, k8, v8, tbl8, pos8, 13)
    for c in range(8):  # a chunk of 8 vs eight C = 1 calls, same pool
        one = ops.paged_attention(q8[:, c:c + 1].contiguous(), k8, v8, tbl8,
                                  pos8[:, c:c + 1].contiguous(), 13)
        same(f"paged_attention chunk row {c} vs C = 1", one[:, 0],
             chunk[:, c])
    perm = torch.as_tensor(rng.permutation(k.shape[0]), device=dev)
    k2, v2 = torch.empty_like(k), torch.empty_like(v)
    k2[perm], v2[perm] = k, v  # physical page p moves to perm[p]
    tbl2 = perm[tbl.clamp(0, k.shape[0] - 1).long()].to(torch.int32)
    same("paged_attention under permuted physical pages",
         ops.paged_attention(q, k2, v2, tbl2, pos, 0), full)
    # rows past each slot's position are never read: other values there
    # change nothing (decode; the chunk with a window; int8 pools)
    k3, v3 = overwrite_past(1, tbl, pos, k, v)
    same("paged_attention with the rows past each position overwritten",
         ops.paged_attention(q, k3, v3, tbl, pos, 0), full)
    k3, v3 = overwrite_past(2, tbl8, pos8, k8, v8)
    same("paged_attention chunk with the rows past each position "
         "overwritten", ops.paged_attention(q8, k3, v3, tbl8, pos8, 13),
         chunk)
    qi, ki, vi, tbli, posi, ksi, vsi = pa_case(rng, dev, 4, 8, H, KV, hd,
                                               page, n_ps, True)
    want = ops.paged_attention(qi, ki, vi, tbli, posi, 0, ksi, vsi)
    pools = overwrite_past(3, tbli, posi, ki, vi, ksi, vsi)
    same("paged_attention int8 with the rows past each position "
         "overwritten", ops.paged_attention(qi, *pools[:2], tbli, posi, 0,
                                            *pools[2:]), want)
    torch.cuda.synchronize(dev)
    return (f"{n} grid cases (2 with a row at position -1) and {n_ring} "
            f"ring cases (S = {S}, bf16 and int8 caches, window 0 and 13, "
            f"positions past the wrap) within one bf16 ulp of the output's "
            f"largest magnitude (worst {worst:.2f} ulp), the ring below the "
            f"wrap bitwise the launch without it; "
            f"rows bitwise invariant to B (3 slots alone vs in a batch of "
            f"{B}), C (8 rows vs C = 1), the physical page order, and the "
            f"rows past each position (3 cases)")


PA_VISIBLE = 256  # positions each slot sees in the second timing


def paged_attention_row(dev):
    """Time the kernel at the serve decode shape (16 slots, 64 pages of
    16, bf16 pools) twice: every slot at the end of its table, so every K
    and V row is weighed (where skipping cannot help); and every slot at
    position PA_VISIBLE - 1 (the serve cell's range), where the kernel
    reads a quarter of the rows.  Each beside its plain version and a
    gather + ``F.scaled_dot_product_attention`` yardstick (at the second,
    of the pages up to the position).  Then at the device batcher's shape
    (``c8``): the same 16 slots with DEVICE_CHUNK query rows each, slot b's
    rows at positions [p_b, p_b + 8), p_b drawn in phase 9's prompt range
    (a prefill chunk, or a decode row and its 7 padded rows)."""
    B, C, H, KV, hd, page, n_ps = 16, 1, 12, 2, 128, 16, 64
    S = n_ps * page
    rng = np.random.default_rng(SEED)
    q, k, v, tbl, _, _, _ = pa_case(rng, dev, B, C, H, KV, hd, page, n_ps,
                                    False, past=False)

    def at(p: int, C: int = 1) -> torch.Tensor:
        return torch.full((B, C), p, dtype=torch.int32, device=dev)

    full = pa_timing(q, k, v, tbl, at(S - 1), dev)
    row = {"name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
           "replaces": REPLACES["paged_attention"], "launches": None,
           "bitwise": False, **full}
    row["skip"] = pa_timing(q, k, v, tbl, at(PA_VISIBLE - 1), dev)
    q8 = torch.as_tensor(rng.normal(0, 1, (B, DEVICE_CHUNK, H, hd)),
                         dtype=torch.bfloat16, device=dev)
    p0 = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, B)
    pos8 = torch.as_tensor(p0[:, None] + np.arange(DEVICE_CHUNK)[None],
                           dtype=torch.int32, device=dev)
    row["c8"] = pa_timing(q8, k, v, tbl, pos8, dev)
    # the dense step's launch: 16 slots, each its own page of the ring's
    # 1,024 cells (cache_len), one row a slot past the wrap
    S = DENSE["cache_len"]
    qr, kr, vr, tr, _, _, _ = pa_case(rng, dev, B, 1, H, KV, hd, S, 1, False,
                                      past=False)
    posr = torch.as_tensor(S + rng.integers(0, S, (B, 1)), dtype=torch.int32,
                           device=dev)
    row["ring"] = pa_timing(qr, kr, vr, tr, posr, dev, ring=True)
    return row


def pa_timing(q, k, v, tbl, pos, dev, ring: bool = False,
              window: int = 0) -> Dict[str, Any]:
    """The kernel, its plain version and gather + SDPA at positions ``pos``
    [B, C], timed; the bound from the rows it must read and the products
    its visible positions need.  ``ring``: the dense cache's ring (window
    0, so a row past the wrap sees all ``n_ps * page`` cells, and the
    yardstick attends over all of them).  ``window``: a sliding window (a
    row sees its last ``window`` positions; the yardstick's mask too)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import paged_attention_hbm_bytes
    from repro_torch.nn.attn_backend import position_mask, repeat_kv

    B, C, H, hd = q.shape
    N, page, KV, _ = k.shape
    n_ps = tbl.shape[1]
    args = (q, k, v, tbl, pos, window)
    kw = {"ring": True} if ring else {}
    got = ops.paged_attention(*args, **kw)
    want = ref.paged_attention_ref(*args, **kw)
    hi = int(pos.max().item())
    pa_err_ulps(f"paged_attention at B = {B}, C = {C}, positions up to "
                f"{hi}{' (ring)' if ring else ''}", got, want)
    err = (got.float() - want.float()).abs().max().item()
    n_pg = min(hi // page + 1, n_ps)  # the pages up to the last position
    gtbl = tbl[:, :n_pg].long()
    S_lib = n_pg * page

    def library():
        kf = repeat_kv(k[gtbl].reshape(B, S_lib, KV, hd), H).transpose(1, 2)
        vf = repeat_kv(v[gtbl].reshape(B, S_lib, KV, hd), H).transpose(1, 2)
        mask = position_mask(pos, torch.arange(S_lib, device=dev)[None],
                             window, True)[:, None].to(q.dtype)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kf, vf,
                                              attn_mask=mask).transpose(1, 2)

    n_bytes = paged_attention_hbm_bytes(
        B, C, H, KV, hd, n_ps, page, pool_bytes=k.element_size(),
        quantized=False, act_bytes=q.element_size(),
        positions=pos.cpu().numpy(), window=window, ring=ring)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    # positions the rows weigh (a ring row at most the ring's cells, a
    # windowed row at most its window)
    seen = pos.long() + 1
    if ring:
        seen = torch.clamp(seen, max=S_lib)
    if window:
        seen = torch.clamp(seen, max=window)
    seen = int(seen.sum().item())
    t_ops = 4 * H * hd * seen / PEAK_BF16_FLOPS * 1e3  # q.k and P.V
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.paged_attention(*args, **kw)),
        "device_ms": device_ms(lambda: ops.paged_attention(*args, **kw)),
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(*args, **kw)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
        "library_max_abs_err": (library().float() - want.float()).abs().max()
        .item(),
        "shape": {"B": B, "C": C, "H": H, "KV": KV, "hd": hd, "page": page,
                  "n_ps": n_ps, "positions": [int(pos.min()), hi],
                  "ring": ring, "window": window, "bytes": n_bytes},
    }


# --------------------------------------------------- phase 8: linear
LINEAR_ROWS = (1, 16, 48, 64, 128, 256)  # M of the row-invariance grid
LINEAR_TIMED = (16, 128)  # M of the timings: C = 1 and C = 8 at 16 slots


def linear_weights(cfg):
    """The eight weight shapes of a qwen2-1.5b step, (name, K, N, float32
    out): seven products a layer and the head."""
    D, hd = cfg.d_model, cfg.head_dim_
    return [("wq", D, cfg.q_heads * hd, False),
            ("wk", D, cfg.n_kv_heads * hd, False),
            ("wv", D, cfg.n_kv_heads * hd, False),
            ("wo", cfg.q_heads * hd, D, False),
            ("w_gate", D, cfg.d_ff, False), ("w_up", D, cfg.d_ff, False),
            ("w_down", cfg.d_ff, D, False),
            ("head", D, cfg.vocab_padded, True)]


def linear_case(dev, M, K, N, seed):
    """bf16 x [M, K] ~ N(0, 1), w [K, N] ~ N(0, 1/K) on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=dev) / np.sqrt(K)).to(
        torch.bfloat16)
    return x, w


def check_linear(cfg, dev, weights=None, tag: str = "8 linear") -> str:
    """(a) every row of each of ``weights`` ((name, K, N, float32 out);
    the step's eight products by default) bitwise equal to the same row in
    another row count, at another position and alone, for M in
    LINEAR_ROWS; (b) within ``linear_limit`` (fixed before any run:
    2 K 2^-24 sum|x||w| for two float32 summation orders, plus one bf16 ulp
    of the output) of the plain version at the timed M."""
    from test_torch_cuda import linear_limit

    from repro_torch.kernels import ops, ref

    weights = weights or linear_weights(cfg)
    n_rows = n_cmp = 0
    worst = 0.0
    for i, (name, K, N, f32) in enumerate(weights):
        out = torch.float32 if f32 else None
        X, w = linear_case(dev, max(LINEAR_ROWS) + 7, K, N, SEED + i)
        for M in LINEAR_ROWS:
            a = ops.linear(X[:M], w, out)
            b = ops.linear(X[7:7 + M].contiguous(), w, out)
            if not torch.equal(a[7:], b[: M - 7]):
                fail(f"({tag}) {name}: rows differ between [{M}, {K}] "
                     f"operands at offsets 0 and 7")
            for r in sorted({0, M // 2, M - 1}):
                alone = ops.linear(X[r:r + 1].contiguous(), w, out)
                if not torch.equal(alone[0], a[r]):
                    fail(f"({tag}) {name}: row {r} alone differs from "
                         f"row {r} of a [{M}, {K}] operand")
                n_cmp += 1
            n_rows += M
        for M in LINEAR_TIMED:
            x = X[:M].contiguous()
            got, want = ops.linear(x, w, out), ref.linear_ref(x, w, out)
            err = (got.float() - want.float()).abs()
            limit = linear_limit(x, w, want, f32)
            bad = err > limit
            if bad.any():
                fail(f"({tag}) {name} at M = {M}: {int(bad.sum())} "
                     f"elements past the limit of the plain version")
            worst = max(worst, (err / limit.clamp_min(1e-30)).max().item())
        del X, w
    return (f"(a) the {len(weights)} weight shapes "
            f"{[(n, K, N) for n, K, N, _ in weights]} x M in {LINEAR_ROWS}: "
            f"{n_rows} rows bitwise equal at offsets 0 and 7, {n_cmp} rows "
            f"bitwise equal computed alone; (b) within the limit of the "
            f"plain version at M in {LINEAR_TIMED} (worst {worst:.4f} of "
            f"it)")


def linear_groups(cfg):
    """The step's grouped launches: (name, member names) of
    ``linear_weights``."""
    return [("qkv", ("wq", "wk", "wv")), ("gate_up", ("w_gate", "w_up"))]


def check_linear_groups(cfg, dev) -> str:
    """Each member of the step's two grouped launches bitwise its lone
    launch, for M in LINEAR_ROWS; a group is one launch."""
    from repro_torch.kernels import ops

    shapes = {name: (K, N) for name, K, N, _ in linear_weights(cfg)}
    n = 0
    for gname, members in linear_groups(cfg):
        K = shapes[members[0]][0]
        X, _ = linear_case(dev, max(LINEAR_ROWS), K, 8, SEED + 100)
        ws = [linear_case(dev, 1, K, shapes[m][1], SEED + 101 + i)[1]
              for i, m in enumerate(members)]
        for M in LINEAR_ROWS:
            x = X[:M].contiguous()
            before = ops.launch_counts()["linear"]
            got = ops.linear_group(x, ws)
            if ops.launch_counts()["linear"] != before + 1:
                fail(f"(8 linear) the {gname} group made more than one "
                     f"launch")
            for m, g, w in zip(members, got, ws):
                if not torch.equal(g, ops.linear(x, w)):
                    fail(f"(8 linear) {gname} at M = {M}: {m} differs from "
                         f"its lone launch")
                n += 1
    return (f"(c) the groups {[g for g, _ in linear_groups(cfg)]} at M in "
            f"{LINEAR_ROWS}: {n} members bitwise their lone launches, one "
            f"launch a group")


# a timing rotates over copies of its weights that together pass this many
# bytes, so every call finds them out of the 50 MB L2, as a serve step does
COLD_BYTES = 120e6


def rotating(copies, call):
    """A callable that runs ``call(copy)`` over ``copies`` in turn."""
    state = {"i": 0}

    def fn():
        i = state["i"]
        state["i"] = (i + 1) % len(copies)
        return call(copies[i])

    return fn


def linear_timings(cfg, dev, Ms=LINEAR_TIMED, units=None):
    """Each of the eight products and the two groups at M in ``Ms`` (or
    ``units``: (name, [(K, N, float32 out)]) of ``moe_linear_units``),
    L2-cold (rotating over copies of the weights past COLD_BYTES): the
    kernel's events and device time, cuBLAS's (``x @ w``, or the head's
    ``torch.mm(out_dtype=float32)``; a group's members one after another),
    the plain version's, the error against it and the byte bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.linear import linear_hbm_bytes

    if units is None:
        shapes = {name: (K, N, f32) for name, K, N, f32 in linear_weights(cfg)}
        units = [(name, (name,)) for name in shapes] + linear_groups(cfg)
    else:
        shapes = {f"{name}{j}": m for name, members in units
                  for j, m in enumerate(members)}
        units = [(name, tuple(f"{name}{j}" for j in range(len(members))))
                 for name, members in units]
    per = []
    for i, (name, members) in enumerate(units):
        f32 = shapes[members[0]][2]
        out = torch.float32 if f32 else None
        K = shapes[members[0]][0]
        ws = [linear_case(dev, 1, K, shapes[m][1], SEED + 10 * i + j)[1]
              for j, m in enumerate(members)]
        w_bytes = sum(w.numel() * 2 for w in ws)
        copies = [ws] + [[w.clone() for w in ws]
                         for _ in range(int(np.ceil(COLD_BYTES / w_bytes))
                                        - 1)]
        X, _ = linear_case(dev, max(Ms), K, 8, SEED + 10 * i + 9)
        for M in Ms:
            x = X[:M].contiguous()
            if len(ws) == 1:
                kernel = rotating(copies, lambda c: ops.linear(x, c[0], out))
            else:
                kernel = rotating(copies, lambda c: ops.linear_group(x, c))
            lib = linear_library(x, f32)
            library = lib and rotating(copies,
                                       lambda c: [lib(w) for w in c])
            got = ops.linear_group(x, ws, out)
            err = max((g.float() - ref.linear_ref(x, w, out).float())
                      .abs().max().item() for g, w in zip(got, ws))
            n_bytes = 2 * M * K + sum(
                linear_hbm_bytes(M, K, w.shape[1], 4 if f32 else 2)
                - 2 * M * K for w in ws)
            flops = sum(2 * M * K * w.shape[1] for w in ws)
            t_bytes = n_bytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            per.append({
                "weight": name, "members": list(members), "M": M, "K": K,
                "N": [w.shape[1] for w in ws], "max_abs_err": err,
                "copies": len(copies),
                "ms": time_ms(kernel),
                "device_ms": device_ms(kernel, spins=True),
                "plain_ms": time_ms(
                    lambda: [ref.linear_ref(x, w, out) for w in ws],
                    reps=5, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(library) if library else None,
                "library_device_ms": (device_ms(library, spins=True)
                                      if library else None)})
        del copies, ws
        torch.cuda.empty_cache()
    return per


def linear_library(x, f32):
    """``w -> `` one PyTorch call computing the same product (cuBLAS):
    ``x @ w``, or for the float32 head ``torch.mm`` with ``out_dtype``
    where this PyTorch has it (else None)."""
    if not f32:
        return lambda w: x @ w
    try:
        torch.mm(x[:1], x[:1].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return None
    return lambda w: torch.mm(x, w, out_dtype=torch.float32)


def linear_step(cfg, per, m_layer: int, m_head: int, key: str):
    """``key`` summed over one step's launches: per layer the q/k/v group,
    wo, the gate/up group and w_down at ``m_layer`` rows, and the head at
    ``m_head``; for cuBLAS (``library*``) the seven products alone.  None
    when a term is missing."""
    by = {(r["weight"], r["M"]): r[key] for r in per}
    lone = key.startswith("library")
    names = (("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down") if lone
             else ("qkv", "wo", "gate_up", "w_down"))
    vals = [by[(n, m_layer)] for n in names] * cfg.n_layers
    vals.append(by[("head", m_head)])
    return None if None in vals else sum(vals)


def linear_step_row(cfg, per, launches: int) -> Dict[str, Any]:
    """The JSON row: one device-batcher step's products at C = DEVICE_CHUNK
    (each layer's four launches at M = 16 x DEVICE_CHUNK, the head at
    M = 16), summed from ``per``; ``c1`` the same at C = 1 (M = 16
    throughout, the host batcher's step)."""
    B = SERVE["max_batch"]
    m8 = B * DEVICE_CHUNK
    row = {"name": "linear", "route": "cuda", "source": LINEAR_SOURCE,
           "replaces": REPLACES["linear"], "launches": launches,
           "bitwise": False,
           "max_abs_err": max(r["max_abs_err"] for r in per),
           "bound_by": "bytes",
           "shape": {"step": f"{cfg.n_layers} x (q/k/v group, wo, gate/up "
                             f"group, w_down) at M = {m8}, the head at "
                             f"M = {B}; L2-cold"},
           "per_product": per}
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms"):
        row[key] = linear_step(cfg, per, m8, B, key)
    row["c1"] = {key: linear_step(cfg, per, B, B, key)
                 for key in ("device_ms", "bound_ms", "library_device_ms")}
    return row


# ------------------------------------------------------ phases 9 and 10
SERVE = dict(max_batch=16, cache_len=1024, page_size=16)
SERVE_REQUESTS, SERVE_TOKENS = 32, 32
PROMPT_LENS = (16, 256)  # prompt lengths are drawn in this closed range
# the parity contract of phase 10, fixed before any run
CAPTURE_STEPS = (0, 64, 128, 192)  # serve steps whose attention is captured
LOGIT_TOL = 0.03  # delta = LOGIT_TOL * max |plain logits|, per position
MIN_POSITIONS = 512  # teacher-forced generated positions, at least
SHARED_PREFIX = 72  # tokens every prompt of the share_prefix check shares


@dataclasses.dataclass
class ServeRun:
    cfg: Any
    params: Any
    gate: Any
    prompts: list
    feats: np.ndarray
    cb: Any  # the ContinuousBatcher after the run
    seconds: float
    launches: Dict[str, int]


def serve_workload(cfg, params, gate, prompts, feats, dev, attn_impl="auto"):
    """The phase-9 traffic through ServeEngine + ContinuousBatcher:
    (batcher after the run, seconds, kernel launches during it)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(cfg, params, ServeConfig(**SERVE,
                                                  attn_impl=attn_impl),
                         gate=gate, device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=SERVE_TOKENS)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, (p, f) in enumerate(zip(prompts, feats)):
        cb.submit(rid, p, features=f)
    cb.run(max_steps=20000)
    torch.cuda.synchronize(dev)
    return cb, time.perf_counter() - t0, ops.launch_counts()


def serve_gate(dev):
    """The serve phases' admission gate: rf-S planted on unsw, on the
    card (gate-sized, so ``fused_eb``)."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=4000)
    gate = plant(PlanterConfig(model="rf", size="S", device=str(dev)),
                 ds.X_train, ds.y_train, ds.X_test).mapped
    if gate.select_backend(dev) != "cuda_fused":
        fail(f"the rf-S gate takes {gate.select_backend(dev)}, not cuda_fused")
    return gate


def drive_serve(dev, seed: int, arch: str = "qwen2-1.5b") -> ServeRun:
    """``arch`` (qwen2-1.5b) at full width (its depth ``served_config``'s)
    through ServeEngine + ContinuousBatcher."""
    from repro_torch.arch import model as M
    from repro_torch.data import load_dataset
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    cfg = served_config(arch)
    params = M.init_params(cfg, seed, dev)
    ds = load_dataset("unsw", n=4000)
    gate = serve_gate(dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                     SERVE_REQUESTS)]
    feats = ds.X_test[np.arange(SERVE_REQUESTS) % len(ds.X_test)]
    warm = ContinuousBatcher(ServeEngine(cfg, params, ServeConfig(**SERVE),
                                         device=dev),
                             eos_token=-1, max_tokens=4)
    warm.submit("warm-up", prompts[0][:8])
    warm.run(max_steps=100)
    cb, seconds, counts = serve_workload(cfg, params, gate, prompts, feats,
                                         dev)
    return ServeRun(cfg, params, gate, prompts, feats, cb, seconds, counts)


def check_serve(run: ServeRun) -> str:
    cb, cfg = run.cb, run.cfg
    for k, n in step_kernels(cfg).items():
        if run.launches[k] != cb.steps * n:
            fail(f"{k} launched {run.launches[k]} times in {cb.steps} "
                 f"steps of {n} launches")
    if run.launches["fused_eb"] < SERVE_REQUESTS:
        fail(f"fused_eb launched {run.launches['fused_eb']} times for "
             f"{SERVE_REQUESTS} admissions")
    others = {k: n for k, n in run.launches.items()
              if n and k not in ("fused_eb", *step_kernels(cfg))}
    if others:
        fail(f"the serve path launched other kernels: {others}")
    served, dropped = set(cb.done), set(cb.dropped)
    if served & dropped or len(served) + len(dropped) != SERVE_REQUESTS:
        fail(f"served {len(served)} + dropped {len(dropped)} != "
             f"{SERVE_REQUESTS} requests")
    keep = run.gate.predict(run.feats) != 1
    rejected = {r for r, why in cb.drop_reasons.items() if why == "gate-reject"}
    if rejected != set(np.where(~keep)[0].tolist()):
        fail("gate-reject drops differ from the gate's numpy verdicts")
    if set(cb.drop_reasons.values()) - {"gate-reject", "quarantined"}:
        fail(f"unexpected drops: {cb.drop_reasons}")
    for rid, toks in cb.done.items():
        if len(toks) != SERVE_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: {len(toks)} tokens, or out of vocab")
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"{len(served)} served, {len(dropped)} dropped "
            f"({dict(collections.Counter(cb.drop_reasons.values()))}), "
            f"{n_tok} tokens in {cb.steps} steps, {run.seconds:.3f} s: "
            f"{n_tok / run.seconds:.1f} tokens/s, "
            f"{run.seconds / cb.steps * 1e3:.3f} ms per step; launches "
            f"{ {k: n for k, n in run.launches.items() if n} }")


def layer_kinds(cfg) -> list:
    """Each layer's mixer in order: the pattern's macros, then the tail."""
    if not cfg.block_pattern:
        return ["attn"] * cfg.n_layers
    pat = list(cfg.block_pattern)
    n_macro, n_tail = divmod(cfg.n_layers, len(pat))
    return pat * n_macro + pat[:n_tail]


# ``linear`` launches of a recurrent or hybrid layer's mixer: the RG-LRU's
# (w_lin, w_gate) and (w_rec_gate, w_in_gate) groups and w_out; the
# mLSTM's (wq, wk, w_if) and (wv, w_gate) groups and w_out; the sLSTM's
# w_gates and w_out; attention's q/k/v group and wo
MIXER_PRODUCTS = {"attn": 2, "rglru": 3, "mlstm": 3, "slstm": 2}


def attention_layers(cfg) -> int:
    return layer_kinds(cfg).count("attn")


def step_products(cfg) -> int:
    """``linear`` launches a serve step: 4 a layer with an MLP (the q/k/v
    group, wo, the gate/up group, w_down), 4 with an MoE block (the q/k/v
    group, wo, the router, the experts' gate/up group) and 2 more with its
    shared experts (their gate/up group and down), 6 an enc-dec decoder
    layer (its cross-attention's query and wo besides), and the head; a
    ``block_pattern`` layer's mixer ``MIXER_PRODUCTS`` and its MLP 2."""
    if cfg.block_pattern:
        mlp = 2 if cfg.d_ff else 0
        return sum(MIXER_PRODUCTS[k] + mlp for k in layer_kinds(cfg)) + 1
    if cfg.n_experts:
        return (4 + 2 * bool(cfg.n_shared_experts)) * cfg.n_layers + 1
    if cfg.family == "encdec":  # and the cross-attention's query and wo
        return 6 * cfg.n_layers + 1
    return 4 * cfg.n_layers + 1


def step_kernels(cfg) -> Dict[str, int]:
    """The wrapper launches of one serve step by kernel (without the
    gate's): ``paged_attention`` once a layer, ``linear``
    ``step_products``, and ``moe_down_combine`` once an MoE layer."""
    want = {"paged_attention": attention_layers(cfg),
            "linear": step_products(cfg)}
    if cfg.n_experts:
        want["moe_down_combine"] = cfg.n_layers
    return want


def kernel_class(name: str) -> str:
    """A device kernel's class in a serve step's time."""
    name = name.lower()
    for cls in ("paged_attention", "fused_eb", "linear", "moe_down_combine"):
        if cls in name:
            return cls
    if any(w in name for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                               "matmul")):
        return "matmul"
    return "other"


def profile_serve(run: ServeRun, dev, steps: int = 24,
                  scfg: Dict[str, Any] = SERVE) -> str:
    """Where a serve step's time goes, at 16 live slots: ``steps`` host-
    batcher steps timed with the host clock, then ``steps`` more under
    torch.profiler for the device time by kernel; the device's idle share
    is 1 - device time / the unprofiled wall time of a step.  ``scfg``:
    the ServeConfig (phase 9's paged cache, or phase 14's dense one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**scfg),
                         device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=2 * steps + 8)
    for rid in range(SERVE["max_batch"]):
        cb.submit(rid, run.prompts[rid][:16])
    cb.run(max_steps=4)  # every slot live and warm
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cb.run(max_steps=steps)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cb.run(max_steps=steps)
        torch.cuda.synchronize(dev)
    by = collections.Counter()
    for evt in prof.key_averages():
        # kernels only: a CPU op (aten::mm) carries its kernels' time too
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        by[kernel_class(evt.key)] += evt.self_device_time_total / 1e3 / steps
    busy = sum(by.values())
    if busy <= 0:
        return "device time not measured (the profiler saw no kernels)"
    return (f"{steps} steps of {SERVE['max_batch']} live slots: "
            f"{wall:.3f} ms per step (host clock, unprofiled); device ms per "
            f"step { {k: round(v, 4) for k, v in by.items()} } (profiler), "
            f"so the device idles {1 - busy / wall:.3f} of the step")


def check_captured_attention(run: ServeRun, dev) -> str:
    """(a) The workload through the plain ``"torch"`` backend; at the
    CAPTURE_STEPS every layer's attention inputs also go through the
    kernel, which must lie within one bf16 ulp of the plain output."""
    from repro_torch.kernels import ops
    from repro_torch.nn import attn_backend as AB

    plain = AB.get("torch")
    calls, worst, n = [0], [0.0], [0]

    def capturing(q, kv, *, n_heads, head_dim, window):
        out = plain(q, kv, n_heads=n_heads, head_dim=head_dim, window=window)
        step, layer = divmod(calls[0], run.cfg.n_layers)
        calls[0] += 1
        if step in CAPTURE_STEPS:
            got = ops.paged_attention(q, kv.k, kv.v, kv.block_tbl, kv.pos,
                                      window, kv.k_scale, kv.v_scale)
            worst[0] = max(worst[0], pa_err_ulps(
                f"captured attention, step {step} layer {layer}", got, out))
            n[0] += 1
        return out

    AB.register("torch-capture", capturing)
    cb, _, _ = serve_workload(run.cfg, run.params, run.gate, run.prompts,
                              run.feats, dev, attn_impl="torch-capture")
    want = len(CAPTURE_STEPS) * run.cfg.n_layers
    if n[0] != want:
        fail(f"captured {n[0]} layer calls, expected {want} (the plain run "
             f"took {cb.steps} steps)")
    return (f"(a) plain-backend serve run, {cb.steps} steps: the kernel on "
            f"the captured inputs of all {run.cfg.n_layers} layers at steps "
            f"{CAPTURE_STEPS} ({n[0]} calls) within one bf16 ulp of the "
            f"plain output (worst {worst[0]:.2f} ulp)")


@contextlib.contextmanager
def plain_moe():
    """The MoE block's expert down product and combine through the plain
    version (``ref.moe_down_combine_ref``) on the card, inside the block."""
    from repro_torch.kernels import ops, ref

    kernel = ops.moe_down_combine
    ops.moe_down_combine = ref.moe_down_combine_ref
    try:
        yield
    finally:
        ops.moe_down_combine = kernel


class ForcedRouting:
    """The kernel path's top-k experts at every ``nn.moe.route`` call
    (``record``), imposed on another path's calls in the same order
    (``replay``), with that path's own gates as the weights.  Routing is
    discontinuous: where a token's k-th and (k+1)-th router logits lie
    within a rounding of each other, a one-ulp difference upstream picks
    the other expert and everything downstream moves.  So the other path
    is held to the kernel path's routing, and every token it would have
    routed otherwise must be such a near tie: its k-th and (k+1)-th logits
    within 2 LOGIT_TOL of its largest: ``loose`` counts the flips that
    are not, ``worst`` is the largest gap over that bound.  With
    ``misroute`` (the control of phase 17 (d)) each token's top expert is
    replaced by its best-gated expert that the kernel path did not pick."""

    def __init__(self):
        self.calls, self.flips, self.rows, self.at = [], 0, 0, 0
        self.loose, self.worst = 0, 0.0

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.nn import moe

        real = moe.route
        moe.route = lambda *a: fn(real, *a)
        try:
            yield
        finally:
            moe.route = real

    def record(self):
        def rec(real, x, router, n_experts, top_k):
            out = real(x, router, n_experts, top_k)
            self.calls.append(out[1])
            return out
        return self._patched(rec)

    @contextlib.contextmanager
    def replay(self, misroute: bool = False):
        from repro_torch.kernels import ops
        from repro_torch.nn import moe

        self.flips = self.rows = self.at = self.loose = 0
        self.worst = 0.0

        def rep(real, x, router, n_experts, top_k):
            gates, idx, _ = real(x, router, n_experts, top_k)
            forced = self.calls[self.at]
            self.at += 1
            if misroute:
                best = gates.scatter(-1, forced, -1.0).argmax(-1)
                forced = torch.cat([best[..., None], forced[..., 1:]], -1)
                return gates, forced, moe.topk_weights(gates, forced)
            flip = (idx.sort(-1).values != forced.sort(-1).values).any(-1)
            if flip.any():
                logits = ops.linear(x, router.to(x.dtype)).float()
                top = logits[..., :n_experts].sort(-1, descending=True).values
                gap = top[..., top_k - 1] - top[..., top_k]
                bound = 2 * LOGIT_TOL * logits[..., :n_experts].abs().amax(-1)
                over = gap[flip] / bound[flip].clamp_min(1e-30)
                self.loose += int((over > 1).sum())
                self.worst = max(self.worst, over.max().item())
            self.flips += int(flip.sum())
            self.rows += flip.numel()
            return gates, forced, moe.topk_weights(gates, forced)

        with self._patched(rep):
            yield
        if self.at != len(self.calls):
            fail(f"(17d) a replayed path made {self.at} routing calls, the "
                 f"kernel path {len(self.calls)}")


def teacher_rows(run: ServeRun, done: Dict[Any, list], dev, impl: str,
                 chunk: int = 32) -> Dict[tuple, torch.Tensor]:
    """The served streams (prompt + generated) of ``sorted(done)`` through
    the ``impl`` attention on a fresh pool, ``chunk`` tokens a step:
    {(index in sorted(done), position): float32 logits} at every position
    that predicts a generated token."""
    from repro_torch.arch import model as M

    rids = sorted(done)
    seqs = [run.prompts[r] + done[r] for r in rids]
    B, n_ps = len(seqs), SERVE["cache_len"] // SERVE["page_size"]
    tbl = torch.arange(B * n_ps, dtype=torch.int32,
                       device=dev).reshape(B, n_ps)
    L = max(len(s) for s in seqs)
    toks = np.zeros((B, L), np.int32)
    for b, s in enumerate(seqs):
        toks[b, : len(s)] = s
    kv = M.init_paged_kv(run.cfg, B * n_ps, SERVE["page_size"], device=dev)
    rows = {}
    for t0 in range(0, L, chunk):
        n_new = np.array([min(chunk, max(0, len(s) - t0)) for s in seqs],
                         np.int32)
        lg, kv = M.paged_decode_step(
            run.params, kv, tbl,
            torch.full((B,), t0, dtype=torch.int32, device=dev),
            torch.as_tensor(toks[:, t0:t0 + chunk], device=dev),
            torch.as_tensor(n_new, device=dev), run.cfg, attn_impl=impl,
            all_positions=True)
        for b, r in enumerate(rids):  # positions predicting generated
            P = len(run.prompts[r])
            for j in range(int(n_new[b])):
                if P - 1 <= t0 + j < len(seqs[b]) - 1:
                    rows[(b, t0 + j)] = lg[b, j].clone()
        del lg
    return rows


def check_teacher_forced(run: ServeRun, dev) -> str:
    """(b) The kernel run's served streams through the kernel path and the
    plain path (``teacher_rows``): float32 logits at every position that
    predicts a generated token, held to delta = LOGIT_TOL * max |plain
    logits| there."""
    done = run.cb.done
    seqs = [run.prompts[r] + done[r] for r in sorted(done)]
    out = {impl: teacher_rows(run, done, dev, impl)
           for impl in ("cuda", "torch")}
    keys = sorted(out["cuda"])
    a = torch.stack([out["cuda"][k] for k in keys])
    c = torch.stack([out["torch"][k] for k in keys])
    served = torch.as_tensor([seqs[b][t + 1] for b, t in keys], device=dev)
    n_pos = a.shape[0]
    if n_pos < MIN_POSITIONS:
        fail(f"teacher-forced over {n_pos} generated positions, fewer than "
             f"{MIN_POSITIONS}")
    diff = (a - c).abs().amax(-1)
    delta = LOGIT_TOL * c.abs().amax(-1)
    ratio = (diff / delta).max().item()
    if not (diff <= delta).all():
        fail(f"teacher-forced logits: {int((diff > delta).sum())} of {n_pos} "
             f"positions differ by more than delta (worst {ratio:.3f} delta)")
    top2 = c.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    flip = a.argmax(-1) != c.argmax(-1)
    loose = flip & (margin > 2 * delta)
    if loose.any():
        fail(f"{int(loose.sum())} greedy flips where the plain top-2 margin "
             f"exceeds 2 delta")
    del out
    return (f"(b) teacher-forced over {n_pos} generated positions: max "
            f"|logits_kernel - logits_plain| within {ratio:.3f} delta at the "
            f"worst position (mean {(diff / delta).mean().item():.3f}); "
            f"{int(flip.sum())} greedy flips, all within 2 delta; greedy "
            f"agreement {1 - flip.float().mean().item():.4f} (not a gate: "
            f"{(margin <= 2 * delta).float().mean().item():.3f} of positions "
            f"have a plain top-2 margin within 2 delta); kernel path greedy "
            f"== served on {(a.argmax(-1) == served).float().mean().item():.4f}"
            f" of positions")


# layers of the repeated serve checks that depth does not change (phase 10
# (a), (c) and (d), phase 14 (b) and (c), 17 (c), 18 (b), 19 (b)'s paged
# == dense and wraps, 20's graph == eager, no sync and paged == dense): the
# model's first layers at full width, so that the run keeps to its time
# limit
SERVE_CUT = 4
# layers of the earlier slices' models in phases 17-20, at full width: a
# block_pattern model keeps whole macros and its tail (recurrentgemma-9b:
# 4 macros + 2, so that 18 (a)'s control stays past the gate: dropping
# the RG-LRU states moved the logits 5.56 deltas on average at 38 layers,
# 3.50 at 14, against the gate's 2), an enc-dec model cuts its encoder
# alike, gemma3-27b keeps five local layers and a global one.  Their
# full-depth numbers are in PERF.md.  At full depth the run
# took 1,060 s of its 1,200 on one host, and a host a third slower ran
# past the limit.  qwen2-1.5b (phases 9-16, 21, 22) and xlstm-125m keep
# their published depth.
SERVE_DEPTH = {"qwen2-moe-a2.7b": 4, "recurrentgemma-9b": 14,
               "internvl2-2b": 4, "seamless-m4t-large-v2": 4,
               "minitron-4b": 4, "gemma3-27b": 6, "qwen3-32b": 8}


def served_config(arch: str):
    """``arch``'s config at full width, its depth cut to SERVE_DEPTH."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n = SERVE_DEPTH.get(arch)
    if n is None:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=n, n_encoder_layers=min(cfg.n_encoder_layers, n))


def width_depth(cfg) -> str:
    """"full width and depth", or how far ``cfg``'s depth is cut."""
    from repro_torch.configs import get_config

    n = get_config(cfg.name).n_layers
    if cfg.n_layers == n:
        return "full width and depth"
    both = " (each stack)" if cfg.family == "encdec" else ""
    return f"full width, depth cut to {cfg.n_layers} of {n} layers{both}"


def cut_depth(run: ServeRun, n: int = SERVE_CUT) -> ServeRun:
    """``run`` with its model cut to the first ``n`` layers (and cross
    layers; a ``block_pattern`` model to whole macros, at least one, and
    no tail), the same weights at full width, traffic and gate."""
    params = dict(run.params)
    pat = run.cfg.block_pattern
    if pat:
        n = len(pat) * max(1, n // len(pat))
        params["macros"] = {k: v[:n // len(pat)]
                            for k, v in params["macros"].items()}
        params["tail"] = []
    for key in ("layers", "cross_layers"):
        if key in params:
            params[key] = params[key][:n]
    return dataclasses.replace(
        run, cfg=dataclasses.replace(run.cfg, n_layers=n), params=params)


def serve_variant(run: ServeRun, dev, prompts, waves, **kw) -> Any:
    """A ContinuousBatcher over a fresh engine (own pool) with ``kw`` set,
    fed ``prompts`` in ``waves`` (lists of indices), 8 tokens each."""
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE, **kw),
                         device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=8)
    for wave in waves:
        for rid in wave:
            cb.submit(rid, prompts[rid])
        cb.run(max_steps=5000)
    return cb


def check_shared_and_int8(run: ServeRun, dev) -> str:
    """(c) share_prefix streams bitwise equal to unshared ones; (d) one
    kv_int8 run completes."""
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(1, run.cfg.vocab_size, SHARED_PREFIX).tolist()
    prompts = [prefix + rng.integers(1, run.cfg.vocab_size,
                                     int(rng.integers(1, 20))).tolist()
               for _ in range(24)]
    waves = [range(16), range(16, 24)]  # the first wave fills the trie
    plain = serve_variant(run, dev, prompts, waves)
    shared = serve_variant(run, dev, prompts, waves, share_prefix=True)
    # a greedy token in the padded vocab columns quarantines its request,
    # as in the JAX package: such drops must match too
    if (shared.done != plain.done or shared.dropped != plain.dropped
            or len(plain.done) + len(plain.dropped) != len(prompts)):
        fail("share_prefix streams differ from the unshared ones")
    if shared.pool.stats["shared_tokens"] <= 0:
        fail("share_prefix run shared no prefix tokens")
    i8 = serve_variant(run, dev, prompts, [range(8)], kv_int8=True)
    if (len(i8.done) + len(i8.dropped) != 8
            or set(i8.drop_reasons.values()) - {"quarantined"}
            or not all(len(t) == 8 for t in i8.done.values())):
        fail(f"kv_int8 run served {len(i8.done)} of 8 requests "
             f"({i8.drop_reasons})")
    return (f"(c) share_prefix == unshared bitwise over {len(prompts)} "
            f"requests ({shared.pool.stats['shared_tokens']} prompt tokens "
            f"shared); (d) kv_int8 served {len(i8.done)} of 8 "
            f"({len(i8.dropped)} quarantined)")


# ------------------------------------------------------------ phase 11
DEVICE_ROUND, DEVICE_CHUNK = 16, 8  # sync_every, prefill_chunk of (a)
# the profiler drops the first device records of a session, more the more
# sessions the process has run before (phase 11's window once lost all 6
# launches of the gate call that opens it); a window opens with this many
# spin kernels, which absorb the loss and are not counted
PROFILER_SPINS = 256
OUR_KERNELS = ("bucketize_kernel", "ternary_match_kernel", "fused_eb_kernel",
               "lb_lookup_kernel", "bnn_counts_kernel", "bnn_rows_kernel",
               "paged_attention_kernel", "linear_wgmma_kernel",
               "moe_down_combine_kernel")


@dataclasses.dataclass
class DeviceRun:
    cb: Any  # the DeviceContinuousBatcher after its first wave
    seconds: float  # the first wave, graph capture included
    launches: Dict[str, int]  # wrapper counts over the first wave


def device_batcher(run: ServeRun, dev, chunk=DEVICE_CHUNK,
                   sync_every=DEVICE_ROUND, graph=True, **kw):
    """Phase 9's engine through a fresh ``DeviceContinuousBatcher``; ``kw``
    (spec_k and draft, tracer and metrics, fault_injector) go to it."""
    from repro_torch.serve.engine import (DeviceContinuousBatcher,
                                          ServeConfig, ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE),
                         gate=run.gate, device=dev)
    return DeviceContinuousBatcher(engine, eos_token=-1,
                                   max_tokens=SERVE_TOKENS,
                                   sync_every=sync_every,
                                   prefill_chunk=chunk, graph=graph, **kw)


def device_wave(cb, run: ServeRun, dev, tag=None, n=SERVE_REQUESTS,
                dense: bool = False) -> float:
    """Submit phase 9's requests (ids ``(tag, i)`` past the first wave;
    ``dense``: each prompt's first token only), run them to the end;
    seconds on the host clock, synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i, (p, f) in enumerate(zip(run.prompts[:n], run.feats[:n])):
        cb.submit(i if tag is None else (tag, i), p[:1] if dense else p,
                  features=f)
    cb.run(max_steps=20000)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def drive_device(run: ServeRun, dev, **kw) -> DeviceRun:
    """One batcher, phase 9's workload; the wrapper counts are reset just
    before and read just after."""
    from repro_torch.kernels import ops

    cb = device_batcher(run, dev, **kw)
    ops.reset_launch_counts()
    seconds = device_wave(cb, run, dev)
    return DeviceRun(cb, seconds, ops.launch_counts())


def wave_streams(cb) -> Dict[Any, list]:
    """The first wave's streams (plain request ids)."""
    return {r: t for r, t in cb.done.items() if not isinstance(r, tuple)}


def check_device_main(d: DeviceRun, run: ServeRun) -> str:
    """(a) the terminal states, the gate's verdicts, the pool, the path's
    kernels."""
    cb, cfg = d.cb, run.cfg
    for k in ("fused_eb", *step_kernels(cfg)):
        if d.launches[k] <= 0:
            fail(f"the device batcher did not launch {k}: {d.launches}")
    others = {k: n for k, n in d.launches.items()
              if n and k not in ("fused_eb", *step_kernels(cfg))}
    if others:
        fail(f"the device batcher launched other kernels: {others}")
    served, dropped = set(cb.done), set(cb.dropped)
    if served & dropped or len(served) + len(dropped) != SERVE_REQUESTS:
        fail(f"device batcher: served {len(served)} + dropped "
             f"{len(dropped)} != {SERVE_REQUESTS}")
    keep = run.gate.predict(run.feats) != 1
    rejected = {r for r, why in cb.drop_reasons.items() if why == "gate-reject"}
    if rejected != set(np.where(~keep)[0].tolist()):
        fail("device batcher: gate-reject drops differ from the gate's "
             "numpy verdicts")
    if set(cb.drop_reasons.values()) - {"gate-reject", "quarantined"}:
        fail(f"device batcher: unexpected drops {cb.drop_reasons}")
    for rid, toks in cb.done.items():
        if len(toks) != SERVE_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"device batcher request {rid}: {len(toks)} tokens, or "
                 "out of vocab")
    held = np.where(cb.pool.ref > 0)[0]
    if (set(held.tolist()) != cb.pool.cached_pages()
            or (cb.pool.ref[held] != 1).any() or (cb.pool.ref < 0).any()):
        fail(f"device batcher: the pool holds {int(cb.pool.ref.sum())} "
             f"references past the {cb.pool.n_cached} prefix holds")
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"(a) sync_every {DEVICE_ROUND}, prefill_chunk {DEVICE_CHUNK}, "
            f"graph: {len(served)} served, {len(dropped)} dropped "
            f"({dict(collections.Counter(cb.drop_reasons.values()))}), "
            f"{n_tok} tokens; {cb.steps} steps with work, "
            f"{cb.steps_executed} run, {cb.steps_wasted} wasted; first "
            f"wave {d.seconds:.3f} s with the graph capture; pool back to "
            f"{cb.pool.n_cached} prefix holds; wrapper launches "
            f"{ {k: n for k, n in d.launches.items() if n} } (the eager "
            f"warm-up, the capture and the gate calls)")


def first_wave_drops(cb) -> tuple:
    """The first wave's dropped list and reasons (plain request ids)."""
    return ([r for r in cb.dropped if not isinstance(r, tuple)],
            {r: w for r, w in cb.drop_reasons.items()
             if not isinstance(r, tuple)})


def same_run(name: str, a, b) -> None:
    if (wave_streams(a) != wave_streams(b)
            or first_wave_drops(a) != first_wave_drops(b)):
        fail(f"{name}: streams or drops differ")


def layer_products(layer, prefix: str = ""):
    """(name, weight) of a layer's matrices (the 2-D bf16 leaves), in tree
    order."""
    for k, v in layer.items():
        if isinstance(v, dict):
            yield from layer_products(v, f"{prefix}{k}/")
        elif v.dim() == 2 and v.dtype == torch.bfloat16:
            yield f"{prefix}{k}", v


def gemm_rows_invariant(run: ServeRun, dev) -> str:
    """Each of layer 0's products through ``ops.linear``, the step's
    product (and for an MoE layer ``ops.moe_down_combine`` on its
    ``w_down``, each row's top-k of the real experts): a row of a chunked
    step's [16 x DEVICE_CHUNK, K] operand has the bits of the same row in a
    token-by-token step's [16, K] (random bf16 activations); fails
    otherwise."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    layer = run.params["layers"][0]
    B = SERVE["max_batch"]
    names = []
    for name, w in layer_products(layer):
        x = torch.randn((B * DEVICE_CHUNK, w.shape[0]), generator=gen,
                        device=dev).to(w.dtype)
        rows = x.reshape(B, DEVICE_CHUNK, -1)[:, 0].contiguous()
        if not torch.equal(ops.linear(x, w).reshape(B, DEVICE_CHUNK, -1)[:, 0],
                           ops.linear(rows, w)):
            fail(f"(d) {name} {tuple(w.shape)}: a row of the "
                 f"[{B * DEVICE_CHUNK}, K] product differs from its "
                 f"[{B}, K] product's")
        names.append(f"{name} {tuple(w.shape)}")
    if "moe" in layer:
        from test_torch_cuda import combine_case

        w = layer["moe"]["w_down"]
        E, F, D = w.shape
        c = combine_case(SEED, B * DEVICE_CHUNK, E, run.cfg.n_experts,
                         run.cfg.n_experts_active, dev)
        h = torch.randn((B * DEVICE_CHUNK, E, F), generator=gen,
                        device=dev).to(torch.bfloat16)
        rows = h.reshape(B, DEVICE_CHUNK, E, F)[:, 0].contiguous()
        crow = c.reshape(B, DEVICE_CHUNK, E)[:, 0].contiguous()
        if not torch.equal(
                ops.moe_down_combine(h, w, c).reshape(B, DEVICE_CHUNK, D)[:, 0],
                ops.moe_down_combine(rows, w, crow)):
            fail(f"(d) moe_down_combine {tuple(w.shape)}: a row differs "
                 f"between [{B * DEVICE_CHUNK}, ...] and [{B}, ...] calls")
        names.append(f"moe/w_down {tuple(w.shape)} (moe_down_combine)")
    return ", ".join(names)


def check_chunked(chunked, tbt, run: ServeRun, dev, tag: str = "(d)") -> str:
    """(d) chunk 8 against token-by-token: the same drops and every stream
    bitwise equal (ROADMAP §C.5)."""
    a = wave_streams(chunked)
    same_run(f"{tag} chunk 8 vs 1", chunked, tbt)
    return (f"{tag} chunk {DEVICE_CHUNK} vs 1: all {len(a)} streams bitwise "
            f"equal ({sum(len(t) for t in a.values())} tokens), drops "
            f"equal; a row of each product of layer 0 has the same bits in "
            f"[{SERVE['max_batch']} x {DEVICE_CHUNK}, K] and "
            f"[{SERVE['max_batch']}, K] operands: "
            f"{gemm_rows_invariant(run, dev)}")


def check_no_sync(run: ServeRun, dev, tag: str = "(e)", **kw) -> str:
    """(e) one round of the eager step and one of the replayed graph, from
    a mid-flight state, under ``set_sync_debug_mode("error")``; ``kw`` go
    to the batcher."""
    out = []
    for graph in (False, True):
        cb = device_batcher(run, dev, graph=graph, **kw)
        for i in range(SERVE["max_batch"]):
            cb.submit(i, run.prompts[i], features=run.feats[i])
        cb.run(max_steps=4)
        (fs,) = cb._steps.values()
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fs.run(DEVICE_ROUND)
        except RuntimeError as exc:
            fail(f"{tag} a {'replayed' if graph else 'eager'} round made "
                 f"the host wait: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
        out.append("replayed" if graph else "eager")
    return (f"{tag} {DEVICE_ROUND}-step rounds, "
            f"{' and '.join(out)}, under set_sync_debug_mode(\"error\"): "
            f"no synchronising call")


def gate_tables(gate) -> int:
    return sum(len(st.tables) for st in gate.pipeline.stages
               if st.kind == "ternary")


def open_window(dev) -> None:
    """The first work of a profiler window: ``PROFILER_SPINS`` spin
    kernels (``torch.cuda._sleep``), which ``kernel_counts`` skips."""
    for _ in range(PROFILER_SPINS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)


def kernel_counts(prof) -> tuple:
    """(launches of the repo's kernels by name, device ms by kernel class,
    device events) in a profile."""
    from torch.autograd import DeviceType

    counts: Dict[str, int] = collections.Counter()
    by: Dict[str, float] = collections.Counter()
    events = 0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or "spin_kernel" in evt.key):
            continue
        by[kernel_class(evt.key)] += evt.self_device_time_total / 1e3
        events += evt.count
        for k in OUR_KERNELS:
            if k in evt.key:
                counts[k] += evt.count
    return dict(counts), dict(by), events


def profile_round(cb, run: ServeRun, dev, tag: str,
                  dense: bool = False) -> tuple:
    """A fresh wave's first round (its gate call and ``DEVICE_ROUND``
    replays) under torch.profiler, then the rest of the wave unprofiled:
    (the repo's kernels by name, steps run in the round).  ``dense``:
    each prompt's first token only."""
    from torch.profiler import ProfilerActivity, profile

    for i, (p, f) in enumerate(zip(run.prompts, run.feats)):
        cb.submit((tag, i), p[:1] if dense else p, features=f)
    s0, keys = cb.steps_executed, len(cb._steps)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        cb.run(max_steps=DEVICE_ROUND)
        torch.cuda.synchronize(dev)
    steps = cb.steps_executed - s0
    if steps != DEVICE_ROUND or len(cb._steps) != keys:
        fail(f"(f) the profiled round ran {steps} steps, or captured")
    cb.run(max_steps=20000)
    counts, by, _ = kernel_counts(prof)
    return counts, by, steps


def state_tensors(tree) -> list:
    """Every tensor of a decode state (nested dicts, lists and tuples), in
    order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in state_tensors(v)]
    return []


# rounds profiled at most before a short count fails: the profiler can drop
# records mid-window (it once lost about one step's, PERF.md §7)
PROFILE_TRIES = 3


def round_counts(cb, run: ServeRun, dev, tag: str,
                 dense: bool = False) -> tuple:
    """The profiler's kernels of one round: its gate call and
    ``DEVICE_ROUND`` replays, which launch ``paged_attention`` once a layer
    and ``linear`` ``step_products`` times a step, and ``fused_eb`` once a
    gate table in each step and in the gate call.  A count over the
    expected one fails at once; a short one profiles a fresh round again,
    up to PROFILE_TRIES rounds, and passes only on an exact match (a short
    count is never accepted).  Returns (counts, steps, every try's
    counts, the exact round's device ms by kernel class)."""
    T = gate_tables(run.gate)
    want = {f"{k}_kernel" if k != "linear" else "linear_wgmma_kernel":
            DEVICE_ROUND * n for k, n in step_kernels(run.cfg).items()}
    want["fused_eb_kernel"] = (DEVICE_ROUND + 1) * T
    want = {k: n for k, n in want.items() if n}
    # the same wave unprofiled first, so that every shape key a round's
    # wave takes is captured before a profiler window: late in a full run
    # a CUDA graph captured just after a window (the dense step's second
    # key) failed as invalidated, where the same sequence in a fresh
    # process did not (PERF.md §7).  A dense wave starts at the ring's
    # global position where the last one stopped, so it decodes other
    # tokens; a greedy token in the padded vocabulary columns quarantines
    # its request and moves the later admissions, and so the wave's keys
    # (qwen3-32b at 16 layers).  Each profiled dense wave therefore starts
    # from the warm wave's decode state, copied back in place (the graphs'
    # buffers kept): it replays the warm wave.
    start = ([t.clone() for t in state_tensors(cb._decode)]
             if dense else [])
    for i, (p, f) in enumerate(zip(run.prompts, run.feats)):
        cb.submit((f"{tag}warm", i), p[:1] if dense else p, features=f)
    cb.run(max_steps=DEVICE_ROUND)
    cb.run(max_steps=20000)
    keys = set(cb._steps)
    tries = []
    for t in range(PROFILE_TRIES):
        for now, then in zip(state_tensors(cb._decode) if dense else (),
                             start):
            now.copy_(then)
        counts, by, rsteps = profile_round(cb, run, dev, f"{tag}{t}", dense)
        if set(cb._steps) != keys:
            fail(f"{tag}: a profiled round's wave captured a new shape key "
                 f"{sorted(set(cb._steps) - keys)} beside {sorted(keys)} "
                 f"(try {t}; drops "
                 f"{dict(collections.Counter(cb.drop_reasons.values()))})")
        tries.append(counts)
        over = {k: n for k, n in counts.items() if n > want.get(k, 0)}
        if over:
            fail(f"{tag}: the profiler saw {counts} in a round of {rsteps} "
                 f"steps, more than the expected {want} (one gate call of "
                 f"{T} tables); tries {tries}")
        if counts == want:
            return counts, rsteps, tries, by
    fail(f"{tag}: the profiler's counts stayed short of {want} in "
         f"{PROFILE_TRIES} rounds: {tries}")


def profile_device(cb, run: ServeRun, dev, dense: bool = False,
                   tag: str = "(f)", whole: bool = True) -> Dict[str, Any]:
    """(f) the kernels of one round (``round_counts``; about 37,000 device
    events, a window of a whole run about 220,000).  Then one warm wave
    timed on the host clock and one under the profiler give the device
    time a step and the idle share; with ``whole`` False the device time
    a step is the exactly counted round's (its gate call and
    DEVICE_ROUND steps), and no wave is profiled (the profiler's
    reckoning of a whole wave of a 60-layer model takes about 30 s).  The
    dense steps (phases 14 and 18-20) take the round: every step of a
    dense wave replays one graph, so a round is a wave's steps; a paged
    wave's rounds differ (prefill chunks, then decode rows)."""
    from torch.profiler import ProfilerActivity, profile

    counts, rsteps, tries, rby = round_counts(cb, run, dev, tag, dense)
    s0 = cb.steps_executed
    wall = device_wave(cb, run, dev, tag="timed", dense=dense)
    steps = cb.steps_executed - s0
    n_tok = sum(len(t) for r, t in cb.done.items()
                if isinstance(r, tuple) and r[0] == "timed")
    if not whole:
        busy = sum(rby.values()) / rsteps
        return dict(seconds=wall, steps=steps, tokens=n_tok,
                    ms_step=wall / steps * 1e3, busy_ms_step=busy,
                    by={k: round(v / rsteps, 4) for k, v in rby.items()},
                    idle=1 - busy / (wall / steps * 1e3), counts=counts,
                    rsteps=rsteps, tries=tries)
    s0 = cb.steps_executed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        device_wave(cb, run, dev, tag="profiled", dense=dense)
    psteps = cb.steps_executed - s0
    wcounts, by, events = kernel_counts(prof)
    busy = sum(by.values())
    return dict(seconds=wall, steps=steps, tokens=n_tok,
                ms_step=wall / steps * 1e3, busy_ms_step=busy / psteps,
                by={k: round(v / psteps, 4) for k, v in by.items()},
                idle=1 - (busy / psteps) / (wall / steps * 1e3),
                counts=counts, rsteps=rsteps, tries=tries, wcounts=wcounts,
                psteps=psteps, events=events)


# ------------------------------------------------------------ phase 12
SPEC_K = 3


def drive_spec(run: ServeRun, d: DeviceRun, dev) -> Dict[str, Any]:
    """Phase 9's workload with ``spec_k`` SPEC_K and a bigram draft trained
    on a pilot wave (phase 11's first ``max_batch`` streams, as the
    launcher's ``--draft pilot``): every greedy stream and drop bitwise
    phase 11's; then a warm wave timed on the host clock."""
    from repro_torch.serve.spec import train_draft

    pilot = wave_streams(d.cb)
    chains = [list(p) for p in run.prompts] + [
        list(run.prompts[r]) + list(t) for r, t in sorted(pilot.items())
        if r < SERVE["max_batch"]]
    draft = train_draft(chains, vocab_size=run.cfg.vocab_size)
    cb = device_batcher(run, dev, spec_k=SPEC_K, draft=draft)
    device_wave(cb, run, dev)
    same_run("(12) spec greedy vs plain greedy", cb, d.cb)
    first, first_steps = cb.spec_stats(), cb.steps
    s0 = cb.steps_executed
    wall = device_wave(cb, run, dev, tag="timed")
    tokens = sum(len(t) for r, t in cb.done.items()
                 if isinstance(r, tuple) and r[0] == "timed")
    return dict(cb=cb, draft=draft, stats=first, first_steps=first_steps,
                seconds=wall, steps=cb.steps_executed - s0, tokens=tokens)


# ------------------------------------------------------------ phase 13
FAULT_SLOT, FAULT_DRAIN = 3, 1  # CorruptTokens: a slot live at drain 1


def check_traced(run: ServeRun, d: DeviceRun, dev) -> str:
    """A traced run of the device batcher (``obs`` Tracer and Metrics):
    streams and drops bitwise the untraced phase 11 run's, every request
    one terminal event; TTFT and decode ms a token from the tracer."""
    from repro_torch.obs import Metrics, Tracer

    mx = Metrics()
    tr = Tracer(metrics=mx)
    cb = device_batcher(run, dev, tracer=tr, metrics=mx)
    wall = device_wave(cb, run, dev)
    same_run("(13) traced vs untraced", cb, d.cb)
    problems = tr.validate()
    if problems:
        fail(f"(13) tracer lifecycle violations: {problems[:5]}")
    if sum(r.terminal is not None for r in tr.requests.values()) != (
            SERVE_REQUESTS):
        fail("(13) not every request reached a terminal event")
    pct = tr.phase_percentiles()
    show = {k: {q: round(v[q], 3) for q in ("p50", "p99")} | {"n": v["n"]}
            for k, v in pct.items() if v["n"]}
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"traced run (first wave, graph capture included): streams and "
            f"drops bitwise the untraced run's, {n_tok} tokens in "
            f"{wall:.4f} s; lifecycles valid; percentiles (ms) {show}; "
            f"counters {mx.snapshot()['counters']}")


def check_faults(run: ServeRun, d: DeviceRun, dev) -> str:
    """A fault-plan run: ``CorruptTokens`` on slot FAULT_SLOT at drain
    FAULT_DRAIN (the request the fill put there, prefilled by then and not
    yet done, is quarantined) and ``PoolExhaust`` at drain 2 held for 2
    drains; every other request is served with phase 11's stream, and
    ``pool.ref`` is back to its prefix holds."""
    from repro_torch.serve.faults import CorruptTokens, FaultPlan, PoolExhaust

    plan = FaultPlan([CorruptTokens(slot=FAULT_SLOT, at_drain=FAULT_DRAIN),
                      PoolExhaust(at_drain=2, hold_drains=2)])
    inj = plan.injector()
    cb = device_batcher(run, dev, fault_injector=inj)
    device_wave(cb, run, dev)
    reasons = first_wave_drops(d.cb)[1]
    kept = [r for r in range(SERVE_REQUESTS)
            if reasons.get(r) != "gate-reject"]
    victim = kept[FAULT_SLOT]  # the step fills slots in FIFO order
    want = {**reasons, victim: "quarantined"}
    if cb.drop_reasons != want or len(inj.fired) != 2:
        fail(f"(13) fault run: drops {cb.drop_reasons}, expected {want}; "
             f"fired {inj.fired}")
    ref = wave_streams(d.cb)
    if {r: t for r, t in ref.items() if r != victim} != wave_streams(cb):
        fail("(13) fault run: a stream no fault touched differs")
    held = np.where(cb.pool.ref > 0)[0]
    if (set(held.tolist()) != cb.pool.cached_pages()
            or (cb.pool.ref[held] != 1).any() or (cb.pool.ref < 0).any()
            or cb._exh_holds):
        fail(f"(13) fault run: the pool holds {int(cb.pool.ref.sum())} "
             f"references past its {cb.pool.n_cached} prefix holds")
    return (f"fault plan {[type(f).__name__ for f in inj.fired]}: request "
            f"{victim} (slot {FAULT_SLOT}) quarantined at drain "
            f"{FAULT_DRAIN}, the other {len(wave_streams(cb))} streams "
            f"bitwise phase 11's, pool back to {cb.pool.n_cached} prefix "
            f"holds")


# ------------------------------------------------------------ phase 14
DENSE = dict(max_batch=16, cache_len=1024)  # phase 9's cell, no page_size
WRAP_CACHE = 128  # cache_len of (c)
# (c): the first 16 requests, one wave, 336 tokens each, so the run passes
# 2.5 x 128 unless every admitted request is quarantined
WRAP_REQUESTS, WRAP_TOKENS = 16, 336
WRAP_CAPTURE = (200, 330)  # global positions whose attention (c) captures
DENSE_GENERATE = 64  # positions generated in (b), after 4 prompt tokens


def dense_engine(run: ServeRun, dev, gate: bool = True, **kw):
    """Phase 9's model and gate over the dense ring cache (``DENSE``,
    ``kw`` overriding it)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    return ServeEngine(run.cfg, run.params, ServeConfig(**{**DENSE, **kw}),
                       gate=run.gate if gate else None, device=dev)


def dense_batchers(run: ServeRun, dev, max_tokens: int = 0, **kw) -> tuple:
    """The host batcher and the device batcher (sync_every DEVICE_ROUND,
    graph on) over fresh dense engines (``kw`` to their ServeConfig),
    ``max_tokens`` (default SERVE_TOKENS) a request."""
    from repro_torch.serve.engine import (ContinuousBatcher,
                                          DeviceContinuousBatcher)

    max_tokens = max_tokens or SERVE_TOKENS
    host = ContinuousBatcher(dense_engine(run, dev, **kw), eos_token=-1,
                             max_tokens=max_tokens)
    device = DeviceContinuousBatcher(
        dense_engine(run, dev, **{k: v for k, v in kw.items()
                                  if k != "attn_impl"}),
        eos_token=-1, max_tokens=max_tokens, sync_every=DEVICE_ROUND)
    return host, device


def check_terminal(cb, run: ServeRun, tag: str, max_tokens: int,
                   n: int = 0) -> None:
    """Served + dropped = the ``n`` (default SERVE_REQUESTS) submitted,
    the gate-reject set the gate's numpy verdicts, no other drop than
    gate-reject or quarantined, every stream ``max_tokens`` in-vocabulary
    tokens."""
    n = n or SERVE_REQUESTS
    served, dropped = set(wave_streams(cb)), set(first_wave_drops(cb)[0])
    if served & dropped or len(served) + len(dropped) != n:
        fail(f"{tag}: served {len(served)} + dropped {len(dropped)} != {n}")
    keep = run.gate.predict(run.feats[:n]) != 1
    reasons = first_wave_drops(cb)[1]
    if {r for r, w in reasons.items() if w == "gate-reject"} != set(
            np.where(~keep)[0].tolist()):
        fail(f"{tag}: gate-reject drops differ from the gate's verdicts")
    if set(reasons.values()) - {"gate-reject", "quarantined"}:
        fail(f"{tag}: unexpected drops {reasons}")
    for rid, toks in wave_streams(cb).items():
        if len(toks) != max_tokens or not all(
                0 <= t < run.cfg.vocab_size for t in toks):
            fail(f"{tag} request {rid}: {len(toks)} tokens, or out of vocab")


def drive_dense(run: ServeRun, dev, tag: str = "(14a)") -> Dict[str, Any]:
    """(a) phase 9's traffic (first prompt token only) through the dense
    host batcher (wrapper counts reset just before, read just after) and
    the dense device batcher: every stream, drop and reason bitwise."""
    from repro_torch.kernels import ops

    host, device = dense_batchers(run, dev)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    host_s = device_wave(host, run, dev, dense=True)
    counts = ops.launch_counts()
    device_s = device_wave(device, run, dev, dense=True)
    same_run(f"{tag} dense host batcher vs dense device batcher", host,
             device)
    for cb, who in ((host, f"{tag} host"), (device, f"{tag} device")):
        check_terminal(cb, run, who, SERVE_TOKENS)
    if not (int(host.engine.state["pos"]) == host.steps == device.steps
            == int(device._decode["pos"])):
        fail(f"{tag} global positions {int(host.engine.state['pos'])}, "
             f"{int(device._decode['pos'])} for {host.steps} and "
             f"{device.steps} steps with work")
    return dict(host=host, host_s=host_s, counts=counts, device=device,
                device_s=device_s)


def check_dense_launches(d: Dict[str, Any], run: ServeRun,
                         tag: str = "(14e)") -> str:
    """(e) the host batcher's wrapper counts: ``paged_attention`` = steps x
    the attention layers (28), ``linear`` = steps x ``step_products``
    (113), ``fused_eb`` = the gate's tables x (one admission call a
    submitted request + one fused gate call a step)."""
    host, counts = d["host"], d["counts"]
    L, T, steps = attention_layers(run.cfg), gate_tables(run.gate), host.steps
    want = {"paged_attention": steps * L,
            "linear": steps * step_products(run.cfg),
            "fused_eb": T * (SERVE_REQUESTS + steps)}
    want = {k: n for k, n in want.items() if n}
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        fail(f"{tag} the dense host batcher launched {got} in {steps} steps, "
             f"expected {want}")
    return (f"(e) host batcher, {steps} steps: wrapper launches {got} == "
            f"steps x {L}, steps x {step_products(run.cfg)}, {T} x "
            f"({SERVE_REQUESTS} admissions + {steps} steps)")


def check_paged_vs_dense(run: ServeRun, dev) -> str:
    """(b) ``generate`` on the dense engine against ``step_paged`` one
    token a step on a paged engine (page 16, the same cache_len), the
    same 4-token prompts (phase 9's first 16 prompts' heads), greedy: the
    generated tokens bitwise equal over DENSE_GENERATE positions."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    B, P, n = DENSE["max_batch"], 4, DENSE_GENERATE
    prompts = np.array([p[:P] for p in run.prompts[:B]], np.int32)
    got = dense_engine(run, dev, gate=False).generate(prompts, n)
    paged = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE),
                        device=dev)
    n_ps = SERVE["cache_len"] // SERVE["page_size"]
    tbl = np.arange(B * n_ps, dtype=np.int32).reshape(B, n_ps)
    tok, outs = prompts[:, 0], []
    for t in range(P + n - 1):
        nxt = paged.step_paged(tok[:, None], tbl, np.full(B, t, np.int32),
                               np.ones(B, np.int32))
        tok = prompts[:, t + 1] if t + 1 < P else nxt
        if t + 1 >= P:
            outs.append(nxt)
    want = np.stack(outs, 1)
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"(14b) dense generate differs from the paged step at "
             f"{int((got != want).sum())} of {want.size} tokens")
    return (f"(b) paged == dense bitwise on the card: generate over the "
            f"dense cache vs step_paged (page {SERVE['page_size']}), {B} "
            f"slots x {n} generated positions ({P} prompt tokens each)")


def check_wrap(run: ServeRun, dev) -> str:
    """(c) cache_len WRAP_CACHE, the first WRAP_REQUESTS requests with
    WRAP_TOKENS tokens each: the global position passes 2.5 x
    WRAP_CACHE.  The host batcher attends through a backend that runs the
    kernel and, at the global positions WRAP_CAPTURE, also the plain
    version on the same inputs (all 28 layers): within one bf16 ulp.
    Host == device batcher bitwise."""
    from repro_torch.nn import attn_backend as AB

    kernel, plain = AB.get("cuda"), AB.get("torch")
    L = attention_layers(run.cfg)
    calls, worst, n = [0], [0.0], [0]

    def capturing(q, kv, *, n_heads, head_dim, window):
        out = kernel(q, kv, n_heads=n_heads, head_dim=head_dim,
                     window=window)
        step, layer = divmod(calls[0], L)
        calls[0] += 1
        if step in WRAP_CAPTURE:
            want = plain(q, kv, n_heads=n_heads, head_dim=head_dim,
                         window=window)
            worst[0] = max(worst[0], pa_err_ulps(
                f"(14c) ring at position {step}, layer {layer}", out, want))
            n[0] += 1
        return out

    AB.register("cuda-capture", capturing)
    host, device = dense_batchers(run, dev, max_tokens=WRAP_TOKENS,
                                  cache_len=WRAP_CACHE,
                                  attn_impl="cuda-capture")
    host_s = device_wave(host, run, dev, n=WRAP_REQUESTS, dense=True)
    device_s = device_wave(device, run, dev, n=WRAP_REQUESTS, dense=True)
    same_run("(14c) host vs device batcher across the wrap", host, device)
    check_terminal(device, run, "(14c)", WRAP_TOKENS, WRAP_REQUESTS)
    pos = int(host.engine.state["pos"])
    if n[0] != len(WRAP_CAPTURE) * L or pos <= 2.5 * WRAP_CACHE or (
            int(device._decode["pos"]) != pos):
        fail(f"(14c) captured {n[0]} layer calls; global position {pos} "
             f"(device {int(device._decode['pos'])}), cache {WRAP_CACHE}")
    return (f"(c) cache {WRAP_CACHE}, {WRAP_TOKENS} tokens a request, "
            f"window {run.cfg.local_window or 'none'}: "
            f"global position {pos} ({pos / WRAP_CACHE:.2f} laps); the "
            f"kernel on the captured inputs of all {L} layers at positions "
            f"{WRAP_CAPTURE} ({n[0]} calls) within one bf16 ulp of the plain "
            f"version (worst {worst[0]:.2f} ulp); host == device batcher "
            f"bitwise ({len(wave_streams(host))} streams, "
            f"{sum(len(t) for t in wave_streams(host).values())} tokens; "
            f"host {host_s:.3f} s, device {device_s:.3f} s with its capture)")


def check_dense_no_sync(run: ServeRun, dev, tag: str = "(14d)") -> str:
    """(d) one round of the eager and of the replayed dense step, from a
    mid-flight state, under ``set_sync_debug_mode("error")``."""
    from repro_torch.serve.engine import DeviceContinuousBatcher

    out = []
    for graph in (False, True):
        cb = DeviceContinuousBatcher(dense_engine(run, dev), eos_token=-1,
                                     max_tokens=SERVE_TOKENS,
                                     sync_every=DEVICE_ROUND, graph=graph)
        for i in range(DENSE["max_batch"]):
            cb.submit(i, run.prompts[i][:1], features=run.feats[i])
        cb.run(max_steps=4)
        (fs,) = cb._steps.values()
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fs.run(DEVICE_ROUND)
        except RuntimeError as exc:
            fail(f"{tag} a {'replayed' if graph else 'eager'} dense round "
                 f"made the host wait: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
        out.append("replayed" if graph else "eager")
    return (f"(d) {DEVICE_ROUND}-step dense rounds, {' and '.join(out)}, "
            f"under set_sync_debug_mode(\"error\"): no synchronising call")


# ------------------------------------------------------------ phase 15
# the launcher's defaults (src/repro/launch/train.py:32-39): 20 steps of a
# batch of 8 sequences of 64 tokens in 2 microbatches, lr 1e-3
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 20, 8, 64, 2
TRAIN_TIMED = (5, 20)  # (e): steps whose median wall time is a step's
TRAIN_CUT = 4  # layers of (b): full width, depth cut
# (d)'s model: xlstm-125m at full width, one macro (mLSTM + sLSTM), its
# checkpoint with the moments about 1 GB; RESUME_STEPS steps of the
# launcher's batch at RESUME_SEQ tokens.  On qwen2-1.5b (d) was bound by
# its checkpoints' bytes (the embedding and head's float32 masters and
# moments, 5.6 GB, and 0.56 GB a layer): 115-144 s of the run at one
# layer; xlstm-125m at the launcher's 20 steps of 64 tokens took 81 s,
# its sLSTM's steps one a token on the host
RESUME_ARCH, RESUME_CUT = "xlstm-125m", 2
RESUME_STEPS, RESUME_SEQ = 8, 32
TRAIN_PARITY_STEPS = 3  # (b)
# (b), fixed before any run: each step's loss through the kernel within
# this relative distance of the plain run's (bf16 products summed in
# another order, about one bf16 ulp of an activation; the port against the
# JAX package on the CPU stays within 3e-4 over ten steps and is held to
# 2e-3 in tests/test_torch_train.py), and each gradient leaf at step 0
# within LOGIT_TOL (the serve parity delta) of the plain leaf's largest
# magnitude
TRAIN_LOSS_RTOL = 2e-3
RESUME_SIGTERM_AFTER = 3  # (d): SIGTERM once the step-3 line is read
# (d): a child runs the launcher with deterministic algorithms, set here
# and not by the launcher (CUBLAS_WORKSPACE_CONFIG in its environment);
# with RESUME_GATED first it starts and reaches the card, then waits for a
# line on its stdin before the launcher reads its arguments
RESUME_GATED = "--after-stdin"
RESUME_CHILD = ("import sys, torch\n"
                "torch.use_deterministic_algorithms(True)\n"
                "from repro_torch.launch.train import main\n"
                f"if sys.argv[1:2] == [{RESUME_GATED!r}]:\n"
                "    torch.zeros(1, device='cuda')\n"
                "    sys.stdin.readline()\n"
                "    del sys.argv[1]\n"
                "main(sys.argv[1:])\n")


def train_config(n_layers: int = 0):
    """qwen2-1.5b, depth cut to ``n_layers`` when given, and the launcher's
    TrainConfig at its defaults."""
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("qwen2-1.5b")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, TrainConfig(
        microbatches=TRAIN_MICRO, q_block=min(512, TRAIN_SEQ),
        adamw=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS))


def train_batches(cfg, dev, seed: int, n: int):
    """The launcher's first ``n`` batches (``TokenPipeline``) on ``dev``."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed))
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(s).items()} for s in range(n)]


def train_launches(cfg) -> int:
    """``linear`` launches of the launcher's run, fixed before any run from
    the JAX package's step: per microbatch each layer's four products in
    the forward and again when ``"full"`` remat recomputes the layer in
    the backward (the backward's products are ``torch.matmul``), and the
    head once (outside the remat)."""
    return TRAIN_STEPS * TRAIN_MICRO * (2 * 4 * cfg.n_layers + 1)


def drive_train(dev, seed: int) -> Dict[str, Any]:
    """(a) ``repro_torch.launch.train.main`` at its defaults (qwen2-1.5b at
    full width and depth), the wrapper counts reset just before and read
    just after: 20 finite losses, the last five's mean below the first
    five's, ``linear`` launched exactly ``train_launches`` times and no
    other kernel of the repo."""
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg, _ = train_config()
    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(["--arch", "qwen2-1.5b", "--seed", str(seed)])
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    lines = out.getvalue().splitlines()
    step_ms = [float(ln.split()[4]) for ln in lines if ln.startswith("step ")]
    if (len(losses) != TRAIN_STEPS or not np.isfinite(losses).all()
            or len(step_ms) != TRAIN_STEPS):
        fail(f"(15a) the launcher gave {len(losses)} losses {losses}")
    if not (np.mean(losses[-5:]) < np.mean(losses[:5])
            and lines[-1].endswith("(improved)")):
        fail(f"(15a) the loss did not improve: {lines[-1]}")
    want = {"linear": train_launches(cfg)}
    if counts != want:
        fail(f"(15a) the launcher launched {counts}, expected {want}")
    torch.cuda.empty_cache()
    lo, hi = TRAIN_TIMED
    return dict(cfg=cfg, losses=losses, step_ms=step_ms, counts=counts,
                peak=peak, before=before, last=lines[-1], seconds=seconds,
                ms=statistics.median(step_ms[lo:hi]))


class plain_products:
    """Inside the block every ``linear`` product is ``ref.linear_ref``
    (the plain version) on any device; the gradient is unchanged."""

    def __enter__(self):
        from repro_torch.kernels.ref import linear_ref

        self.mod = sys.modules["repro_torch.kernels.linear"]
        self.real = self.mod._forward
        self.mod._forward = lambda x, ws, out: [linear_ref(x, w, out)
                                                for w in ws]

    def __exit__(self, *exc):
        self.mod._forward = self.real


def step_grads(cfg, tcfg, params, batch, with_loss: bool = False):
    """The float32 gradient of every master a train step computes for
    ``batch`` (microbatches' gradients summed in float32, over their
    count), as ``{key: [parts]}``; with ``with_loss`` also the step's loss
    (the microbatches' mean)."""
    from repro_torch.arch import model as M
    from repro_torch.tree import leaves, map_leaves

    masters = map_leaves(lambda l: [p.detach().requires_grad_(True)
                                    for p in l.parts], params)
    flat = [(leaf.key, p) for leaf in leaves(masters) for p in leaf.parts]
    n = tcfg.microbatches
    size = batch["tokens"].shape[0] // n
    acc, total = None, 0.0
    for i in range(n):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss = M.loss_fn(masters, mb, cfg, q_block=tcfg.q_block,
                         remat_policy=tcfg.remat_policy)
        gs = torch.autograd.grad(loss, [p for _, p in flat],
                                 allow_unused=True)
        for g, (key, _) in zip(gs, flat):
            if g is None and not M.unread(key):
                raise RuntimeError(f"{key}: no gradient reaches it")
        gs = [torch.zeros_like(p) if g is None else g.float()
              for g, (_, p) in zip(gs, flat)]
        acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
        total += float(loss.detach())
    out: Dict[str, list] = collections.defaultdict(list)
    for (key, _), g in zip(flat, acc):
        out[key].append(g / n)
    return (out, total / n) if with_loss else out


def check_train_parity(dev, seed: int) -> str:
    """(b) qwen2-1.5b at full width, depth cut to TRAIN_CUT, the same
    masters and batches: TRAIN_PARITY_STEPS launcher steps with every
    product through the kernel, then through ``linear_ref``; each step's
    loss within TRAIN_LOSS_RTOL, each gradient leaf at step 0 within
    LOGIT_TOL x the plain leaf's largest magnitude."""
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_train_step

    cfg, tcfg = train_config(TRAIN_CUT)
    batches = train_batches(cfg, dev, seed, TRAIN_PARITY_STEPS)
    runs = {}
    for path in ("kernel", "plain"):
        ctx = (plain_products() if path == "plain"
               else contextlib.nullcontext())
        with ctx:
            ops.reset_launch_counts()
            params, state = init_train_state(cfg, tcfg, seed, dev)
            grads = step_grads(cfg, tcfg, params, batches[0])
            step = make_train_step(cfg, tcfg)
            losses = []
            for b in batches:
                params, state, loss = step(params, state, b)
                losses.append(float(loss))
            launched = ops.launch_counts()["linear"]
        if (launched > 0) != (path == "kernel"):
            fail(f"(15b) the {path} run launched linear {launched} times")
        runs[path] = (losses, grads)
        del params, state, step
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    if not all(np.isfinite(lk)) or max(rel) > TRAIN_LOSS_RTOL:
        fail(f"(15b) losses kernel {lk} vs plain {lp}: relative {rel} past "
             f"{TRAIN_LOSS_RTOL}")
    worst, worst_key = 0.0, None
    for key, parts in gp.items():
        ref_max = max(p.abs().max().item() for p in parts)
        err = max((a - b).abs().max().item() for a, b in zip(gk[key], parts))
        if not err <= LOGIT_TOL * ref_max:
            fail(f"(15b) gradient {key}: {err} past {LOGIT_TOL} x {ref_max}")
        if ref_max and err / ref_max > worst:
            worst, worst_key = err / ref_max, key
    return (f"(b) {TRAIN_CUT} layers at full width, {TRAIN_PARITY_STEPS} "
            f"steps: losses kernel {lk} vs plain {lp} (relative at most "
            f"{max(rel):.3e}, limit {TRAIN_LOSS_RTOL}); {len(gp)} gradient "
            f"leaves at step 0 within {LOGIT_TOL} x max|g_plain| (worst "
            f"{worst:.4f}, {worst_key})")


def check_linear_backward(cfg, dev) -> str:
    """(c) each of the eight weight shapes at M = 256 and 512: the forward
    one launch within ``linear_limit`` of the plain version; given the same
    ``dy``, ``dx`` and ``dw`` bitwise autograd's through the plain product
    (``linear_ref``; the head's one float32 product ``x.float() @
    w.float()``): the same ``torch.matmul`` calls."""
    from test_torch_cuda import linear_limit

    from repro_torch.kernels import ops, ref

    n = 0
    for i, (name, K, N, f32) in enumerate(linear_weights(cfg)):
        out = torch.float32 if f32 else None
        for M in (256, 512):
            x, w = linear_case(dev, M, K, N, SEED + 200 + i)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 300 + i + M)
            dy = torch.randn((M, N), generator=gen, device=dev)
            dy = dy if f32 else dy.to(torch.bfloat16)
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            before = ops.launch_counts()["linear"]
            y = ops.linear(xa, wa, out)
            y.backward(dy)
            xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = ((xb.float() @ wb.float()) if f32
                    else ref.linear_ref(xb, wb))
            want.backward(dy)
            if ops.launch_counts()["linear"] != before + 1:
                fail(f"(15c) {name} at M = {M}: not one launch")
            bad = (y.detach().float() - want.detach().float()).abs() > \
                linear_limit(x, w, want.detach(), f32)
            if bad.any():
                fail(f"(15c) {name} at M = {M}: forward past linear_limit")
            if not (torch.equal(xa.grad, xb.grad)
                    and torch.equal(wa.grad, wb.grad)):
                fail(f"(15c) {name} at M = {M}: dx or dw differs from "
                     f"autograd through the plain product")
            n += 1
            del xa, wa, xb, wb, y, want, dy
    torch.cuda.empty_cache()
    return (f"(c) {n} cases (8 weight shapes x M in (256, 512)): dx and dw "
            f"bitwise autograd's through the plain product, the forward "
            f"one launch within linear_limit")


def _child(args, env, err_path, gated: bool = False):
    """A launcher run in a child process, its stdout piped, its stderr to
    ``err_path``; ``gated``: it waits for a line on its (piped) stdin."""
    import subprocess

    with open(err_path, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", RESUME_CHILD,
             *([RESUME_GATED] if gated else []), *args],
            stdin=subprocess.PIPE if gated else None, stdout=subprocess.PIPE,
            stderr=err, text=True, cwd=ROOT, env=env)


def _losses(path) -> Dict[int, float]:
    """step -> loss from a launcher's ``--metrics-out`` file (JSON floats:
    every bit kept)."""
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return {r["step"]: r["gauges"]["train.loss"] for r in rows}


def check_resume(dev, seed: int) -> str:
    """(d) three launcher runs in child processes (deterministic
    algorithms, ``CUBLAS_WORKSPACE_CONFIG``) on RESUME_ARCH at full width
    and RESUME_CUT layers, RESUME_STEPS steps at RESUME_SEQ tokens: one
    uninterrupted; one sent SIGTERM once its RESUME_SIGTERM_AFTER line is
    read, which must save through ``PreemptionHandler`` and stop; one with
    ``--resume auto`` on the second's directory.  From the resumed step on
    its losses are bitwise the uninterrupted run's; its final checkpoint
    (step RESUME_STEPS) equals the uninterrupted run's in every leaf (masters, m, v,
    count, step), bitwise; the preempted checkpoint restores onto the card
    bitwise what its archive holds (checked while the resumed run trains,
    as is the uninterrupted run's final checkpoint read).  The resumed
    run's process starts with the other two and waits on its stdin until
    the preempted one has stopped."""
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.train import init_train_state
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(RESUME_ARCH), n_layers=RESUME_CUT)
    _, tcfg = train_config()  # the launcher's defaults: the tree's shape
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    base = ["--arch", RESUME_ARCH, "--layers", str(RESUME_CUT), "--seq",
            str(RESUME_SEQ), "--steps", str(RESUME_STEPS), "--seed",
            str(seed), "--ckpt-every", "1000"]
    procs = []

    def wait(name, proc):
        try:
            rc = proc.wait(timeout=600)
        except Exception:
            proc.kill()
            raise
        if rc != 0:
            fail(f"(15d) the {name} run exited {rc}: "
                 f"{(tmp / f'{name}.err').read_text()[-2000:]}")

    try:
        t0 = time.perf_counter()
        runs = {name: _child(base + ["--ckpt-dir", str(tmp / name),
                                     "--metrics-out",
                                     str(tmp / f"{name}.jsonl")], env,
                             tmp / f"{name}.err")
                for name in ("full", "cut")}
        resumed = _child(base + ["--ckpt-dir", str(tmp / "cut"),
                                 "--metrics-out", str(tmp / "res.jsonl"),
                                 "--resume", "auto"], env, tmp / "res.err",
                         gated=True)
        procs += [*runs.values(), resumed]
        cut, lines = runs["cut"], []
        for line in cut.stdout:
            lines.append(line)
            if line.startswith(f"step {RESUME_SIGTERM_AFTER:5d} "):
                cut.send_signal(signal.SIGTERM)
        wait("cut", cut)
        stop = [ln for ln in lines if ln.startswith("preempted at step")]
        if not stop or "checkpoint saved, stopping" not in stop[0]:
            fail(f"(15d) the SIGTERM run did not stop with a checkpoint: "
                 f"{lines[-3:]}")
        at = int(stop[0].split()[3].rstrip(";"))
        saved = at + 1
        resumed.stdin.write("go\n")
        resumed.stdin.flush()
        # while the resumed run trains: the step-`saved` checkpoint onto
        # the card, and the uninterrupted run's final one read
        mgr = CheckpointManager(str(tmp / "cut"))
        flat = mgr.restore_flat(saved)
        params, state = init_train_state(cfg, tcfg, seed + 1, dev)
        got = mgr.restore(saved, {"params": params, "state": state})
        del params, state
        n_leaves = 0
        for leaf in leaves(got):
            arr = flat[leaf.key]
            parts = list(arr) if leaf.stacked else [arr]
            for p, want in zip(leaf.parts, parts):
                if not np.array_equal(p.cpu().numpy(), want):
                    fail(f"(15d) {leaf.key} of step {saved} did not "
                         f"restore bitwise")
            n_leaves += 1
        if int(got["state"]["step"]) != saved or int(
                got["state"]["opt"].count) != saved:
            fail(f"(15d) step/count {int(got['state']['step'])}/"
                 f"{int(got['state']['opt'].count)} restored for {saved}")
        del got, flat
        torch.cuda.empty_cache()
        wait("full", runs["full"])
        a = CheckpointManager(str(tmp / "full")).restore_flat(RESUME_STEPS)
        out, _ = resumed.communicate(timeout=600)
        if resumed.returncode != 0 or f"resumed from step {saved}" not in out:
            fail(f"(15d) the resumed run: rc {resumed.returncode}, "
                 f"{out[-500:]} {(tmp / 'res.err').read_text()[-2000:]}")
        seconds = time.perf_counter() - t0
        full, res = _losses(tmp / "full.jsonl"), _losses(tmp / "res.jsonl")
        if sorted(res) != list(range(saved, RESUME_STEPS)) or any(
                res[s] != full[s] for s in res):
            fail(f"(15d) resumed losses {res} differ from the uninterrupted "
                 f"run's {full}")
        b = CheckpointManager(str(tmp / "cut")).restore_flat(RESUME_STEPS)
        if set(a) != set(b) or any(
                a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
                for k in a):
            fail("(15d) the resumed run's final checkpoint differs from the "
                 "uninterrupted run's")
        n_bytes = sum(v.nbytes for v in a.values())
        del a, b
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return (f"(d) {RESUME_ARCH} at full width, {RESUME_CUT} layers, "
            f"{RESUME_STEPS} steps of {TRAIN_BATCH} x {RESUME_SEQ} tokens: "
            f"SIGTERM after the "
            f"step-{RESUME_SIGTERM_AFTER} line stopped the run at step {at} "
            f"with a checkpoint of step {saved}; --resume auto gave steps "
            f"{saved}-{RESUME_STEPS - 1} bitwise the uninterrupted run's "
            f"losses; the two runs' step-{RESUME_STEPS} checkpoints equal in "
            f"every leaf ({n_bytes / 1e9:.2f} GB each); the step-{saved} "
            f"checkpoint's {n_leaves} leaves restored onto the card bitwise "
            f"(while the resumed run trained); three runs {seconds:.1f} s")


def model_flops(cfg) -> float:
    """Model FLOPs of one launcher step: 6 x the parameters of the
    products (the layers' matrices and the head; not the embedding, a
    gather, nor the norms and biases) x the tokens, and the attention's
    q.k and P.V, forward and backward (12 x layers x B x S^2 x H x hd,
    the full S x S the blocked attention computes)."""
    D, hd, H = cfg.d_model, cfg.head_dim_, cfg.q_heads
    layer = (D * H * hd * 2 + 2 * D * cfg.n_kv_heads * hd
             + 3 * D * cfg.d_ff)
    n_mm = cfg.n_layers * layer + D * cfg.vocab_padded
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 12 * cfg.n_layers * TRAIN_BATCH * TRAIN_SEQ ** 2 * H * hd
    return 6 * n_mm * tokens + attn


def train_class(name: str) -> str:
    """A device kernel's class in a train step by its name: the ``linear``
    kernel, the attention's softmax, the loss and the embedding (other),
    or the rest (the matmuls among them are told apart by their ops)."""
    low = name.lower()
    if "linear" in low and "mma" in low:
        return "linear forward"
    if "moe_down_combine" in low:
        return "moe_down_combine"
    if "softmax" in low and "logsoftmax" not in low:
        return "attention"
    if any(w in low for w in ("logsoftmax", "nll", "index", "embedding",
                              "scatter", "gather", "sort", "radix")):
        return "other"
    return "rest"


def profile_train(dev, seed: int, wall_ms: float,
                  config=None) -> Dict[str, Any]:
    """(e) device ms a launcher step by class, over 2 steps after 2 warm
    ones, at full width and depth (or ``config``, (cfg, TrainConfig)):
    ``linear`` forward (the kernel), the backward's matmuls (the device
    time of ``aten::mm``: the products' ``dx`` and ``dw``), attention
    (``aten::bmm``: q.k and P.V forward, recomputed and backward; and the
    softmax; for an MoE config ``aten::bmm`` also holds
    ``moe_down_combine``'s backward, so it stands alone), the
    ``moe_down_combine`` kernel, other (the loss and the embedding's
    gather and scatter) and the optimizer with every other elementwise
    kernel; idle = 1 - device / ``wall_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import init_train_state, make_train_step

    cfg, tcfg = config or train_config()
    params, state = init_train_state(cfg, tcfg, seed, dev)
    step = make_train_step(cfg, tcfg)
    batches = train_batches(cfg, dev, seed, 4)
    for b in batches[:2]:
        params, state, loss = step(params, state, b)
    float(loss)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        for b in batches[2:]:
            params, state, loss = step(params, state, b)
        float(loss)
        torch.cuda.synchronize(dev)
    by: Dict[str, float] = collections.Counter()
    ops_ms: Dict[str, float] = collections.Counter()
    kernels = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            if "spin_kernel" not in evt.key:
                by[train_class(evt.key)] += evt.self_device_time_total / 2e3
                kernels += evt.count
        elif evt.key in ("aten::mm", "aten::bmm"):
            ops_ms[evt.key] += evt.device_time_total / 2e3
    del params, state, step
    torch.cuda.empty_cache()
    busy = sum(by.values())
    rest = by.pop("rest", 0.0)
    by["backward matmuls"] = ops_ms["aten::mm"]
    if cfg.n_experts:
        by["bmm (attention, moe_down_combine backward)"] = ops_ms["aten::bmm"]
    else:
        by["attention"] += ops_ms["aten::bmm"]
    by["optimizer and elementwise"] = (rest - ops_ms["aten::mm"]
                                       - ops_ms["aten::bmm"])
    return {"by": {k: round(v, 4) for k, v in by.items()}, "busy": busy,
            "idle": 1 - busy / wall_ms if busy else None,
            "mm_ops": dict(ops_ms), "kernels": kernels / 2}


def train_linear_row(cfg, dev, launches: int, backward_ms) -> Dict[str, Any]:
    """(e) the ``train`` entry of the ``linear`` row: each product and
    group at M = 256 (a microbatch, 4 x 64 tokens), L2-cold, summed over
    one forward (each layer's four launches and the head), beside cuBLAS
    and the byte bound; the launches of phase 15's launcher run and the
    backward's cuBLAS device ms a step (``aten::mm``)."""
    M = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
    per = linear_timings(cfg, dev, (M,))
    row = {"M": M, "launches": launches, "backward_mm_device_ms_a_step":
           backward_ms, "shape": f"one forward: {cfg.n_layers} x (q/k/v "
           f"group, wo, gate/up group, w_down) and the head at M = {M}; "
           f"L2-cold", "per_product": per}
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms"):
        row[key] = linear_step(cfg, per, M, M, key)
    return row


# ------------------------------------------------------------ phase 16
ROUTER_SHARDS = 2  # (b)-(e)
ROUTER_STRIKES = 2  # (d): straggler_strikes
ROUTER_SLOW_S = 30.0  # (d): SlowShard's virtual delay at each drain


def sharded(run: ServeRun, dev, n_shards: int, graph: bool = True, **kw):
    """Phase 9's model, gate and ServeConfig through the mesh-less router:
    ``n_shards`` shards, each a device batcher as phase 11's (sync_every
    DEVICE_ROUND, prefill_chunk DEVICE_CHUNK), ``kw`` (faults, retries,
    strikes) to the router."""
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.router import ShardedServe

    return ShardedServe(run.cfg, run.params, ServeConfig(**SERVE), None,
                        gate=run.gate, eos_token=-1, max_tokens=SERVE_TOKENS,
                        sync_every=DEVICE_ROUND, prefill_chunk=DEVICE_CHUNK,
                        n_shards=n_shards, device=dev, graph=graph, **kw)


def route_wave(r, run: ServeRun, dev, tag=None, **run_kw) -> float:
    """Phase 9's 32 requests (ids ``(tag, i)`` past the first wave) through
    router ``r`` to the end; seconds on the host clock, synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i, (p, f) in enumerate(zip(run.prompts, run.feats)):
        r.submit(i if tag is None else (tag, i), p, features=f)
    r.run(max_steps=20000, **run_kw)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def router_steps(r) -> int:
    return sum(b.steps_executed for b in r.batchers)


def timed_route(r, run: ServeRun, dev) -> Dict[str, float]:
    """A warm wave through ``r``: tokens/s and ms per step run (the
    shards' steps one after another on the one card)."""
    s0 = router_steps(r)
    seconds = route_wave(r, run, dev, tag="timed")
    steps = router_steps(r) - s0
    n_tok = sum(len(t) for k, t in r.done.items()
                if isinstance(k, tuple) and k[0] == "timed")
    return {"tokens": n_tok, "seconds": seconds, "steps": steps,
            "tokens_s": n_tok / seconds, "ms_step": seconds / steps * 1e3}


def check_terminal_once(r, n: int, tag: str) -> None:
    served, dropped = set(wave_streams(r)), set(first_wave_drops(r)[0])
    if served & dropped or len(served) + len(dropped) != n or len(
            first_wave_drops(r)[0]) != len(dropped):
        fail(f"{tag}: served {len(served)} + dropped {len(dropped)} is not "
             f"the {n} submitted, each terminal once")


def check_replayed(r, want, tag: str) -> None:
    """Every stream of ``r``'s first wave bitwise ``want``'s, every drop
    reason ``want``'s."""
    if wave_streams(r) != wave_streams(want):
        bad = [k for k, t in wave_streams(r).items()
               if wave_streams(want).get(k) != t]
        fail(f"{tag}: streams differ from (a)'s: {bad[:5]}")
    if first_wave_drops(r)[1] != first_wave_drops(want)[1]:
        fail(f"{tag}: drops {first_wave_drops(r)[1]} differ from (a)'s "
             f"{first_wave_drops(want)[1]}")


def drive_router(run: ServeRun, d: DeviceRun, dev) -> Dict[str, Any]:
    """(a) one shard == phase 11's device batcher, bitwise; (b) two shards:
    FIFO within each, each shard's streams bitwise a lone device batcher
    fed its requests in their order; tokens/s and ms a step of both."""
    from repro_torch.kernels import ops

    one = sharded(run, dev, 1)
    ops.reset_launch_counts()
    one_s = route_wave(one, run, dev)
    launches = ops.launch_counts()
    same_run("(16a) one shard vs phase 11's device batcher", one, d.cb)
    check_terminal(one, run, "(16a)", SERVE_TOKENS)
    for k in ("fused_eb", *step_kernels(run.cfg)):
        if launches[k] <= 0:
            fail(f"(16a) the router did not launch {k}: {launches}")
    two = sharded(run, dev, ROUTER_SHARDS)
    two_s = route_wave(two, run, dev)
    check_terminal(two, run, "(16b)", SERVE_TOKENS)
    for s, rids in enumerate(two.assigned):
        if not rids or rids != sorted(rids):
            fail(f"(16b) shard {s} holds {rids}: empty, or not FIFO")
        lone = device_batcher(run, dev)
        for rid in rids:
            lone.submit(rid, run.prompts[rid], features=run.feats[rid])
        lone.run(max_steps=20000)
        for rid in rids:
            if two.done.get(rid) != lone.done.get(rid) or (
                    two.drop_reasons.get(rid) != lone.drop_reasons.get(rid)):
                fail(f"(16b) request {rid} on shard {s} differs from the "
                     f"lone batcher's")
        del lone
    torch.cuda.empty_cache()
    return dict(one=one, one_s=one_s, two=two, two_s=two_s,
                launches=launches, t_one=timed_route(one, run, dev),
                t_two=timed_route(two, run, dev))


def check_router_faults(run: ServeRun, one, dev) -> str:
    """(c) ``ShardCrash(shard=1, at_drain=1)``, two retries, shards taking
    DEVICE_ROUND-step turns: the crash is logged first, some work moves,
    every request is terminal once and every stream and drop is (a)'s;
    (d) shard 1 slowed by ROUTER_SLOW_S (virtually) at each drain with
    ``straggler_strikes`` ROUTER_STRIKES: evicted, shard 0 never, and the
    same streams."""
    from repro_torch.serve.faults import FaultPlan, ShardCrash, SlowShard

    crash = sharded(run, dev, ROUTER_SHARDS, max_retries=2,
                    fault_injector=FaultPlan(
                        [ShardCrash(shard=1, at_drain=1)]).injector())
    route_wave(crash, run, dev, drain_chunk=DEVICE_ROUND)
    log = crash.failover_log
    if not log or log[0][:2] != (1, "crash-injected") or log[0][2] <= 0:
        fail(f"(16c) failover log {log}: no crash of shard 1 that moved work")
    if crash.alive != [True, False] or not crash.retries:
        fail(f"(16c) alive {crash.alive}, retries {crash.retries}")
    check_terminal_once(crash, SERVE_REQUESTS, "(16c)")
    check_replayed(crash, one, "(16c)")
    slow = sharded(run, dev, ROUTER_SHARDS, max_retries=2,
                   straggler_strikes=ROUTER_STRIKES,
                   fault_injector=FaultPlan(
                       [SlowShard(shard=1, delay_s=ROUTER_SLOW_S, at_drain=i)
                        for i in range(8)]).injector())
    route_wave(slow, run, dev, drain_chunk=DEVICE_ROUND)
    if not any(why == "straggler" for _, why, _ in slow.failover_log) or (
            slow.alive != [True, False]):
        fail(f"(16d) failover log {slow.failover_log}, alive {slow.alive}: "
             f"the slow shard was not the one evicted")
    check_terminal_once(slow, SERVE_REQUESTS, "(16d)")
    check_replayed(slow, one, "(16d)")
    hops = len(crash.retries)
    slow_log = slow.failover_log
    del crash, slow
    torch.cuda.empty_cache()
    return (f"(c) ShardCrash(shard=1, at_drain=1), drain_chunk "
            f"{DEVICE_ROUND}: failover log {log}, {hops} requests replayed "
            f"on shard 0; every request terminal once, every stream and drop "
            f"bitwise (a)'s; (d) SlowShard({ROUTER_SLOW_S} s) on shard 1 at "
            f"every drain, straggler_strikes {ROUTER_STRIKES}: failover log "
            f"{slow_log}, shard 0 kept; every stream and drop bitwise (a)'s")


def check_router_launches(run: ServeRun, dev) -> str:
    """(e) one routed round, eager (the wrappers count every launch; a
    CUDA graph's replays tick no counter): the router's gate call, then
    each shard's first round of DEVICE_ROUND steps (pregate off, the
    in-step gate on): ``fused_eb`` = the gate's tables x (1 + the steps
    run), ``paged_attention`` = steps x layers, ``linear`` = steps x
    ``step_products``, and nothing else."""
    from repro_torch.kernels import ops

    r = sharded(run, dev, ROUTER_SHARDS, graph=False)
    for i, (p, f) in enumerate(zip(run.prompts, run.feats)):
        r.submit(i, p, features=f)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    r.run(max_steps=DEVICE_ROUND)
    torch.cuda.synchronize(dev)
    got = {k: n for k, n in ops.launch_counts().items() if n}
    steps = router_steps(r)
    T = gate_tables(run.gate)
    want = {k: steps * n for k, n in step_kernels(run.cfg).items()}
    want["fused_eb"] = T * (1 + steps)
    if steps != ROUTER_SHARDS * DEVICE_ROUND or got != want:
        fail(f"(16e) one routed round: {steps} steps, launches {got}, "
             f"expected {ROUTER_SHARDS} x {DEVICE_ROUND} steps and {want}")
    del r
    torch.cuda.empty_cache()
    return (f"(e) one routed round (eager, {ROUTER_SHARDS} shards x "
            f"{DEVICE_ROUND} steps): wrapper launches {got} == {T} tables x "
            f"(1 gate call + {steps} steps), {steps} x {run.cfg.n_layers}, "
            f"{steps} x {step_products(run.cfg)}")


def launcher_router_start():
    """``python -m repro_torch.launch.serve --continuous --router
    --page-size 16`` in a child process on the card, started while (c)-(e)
    run (they time nothing); (its process, the start time)."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--continuous",
         "--router", "--page-size", "16"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def launcher_router_check(proc, t0: float) -> str:
    """The launcher's --router run: exit 0, one shard."""
    try:
        out, err = proc.communicate(timeout=600)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("router:", "[router]"))]
    if proc.returncode != 0 or len(lines) != 2 or "1 shard" not in lines[0]:
        fail(f"(16) the launcher's --router run: rc {proc.returncode}, "
             f"{out[-800:]} {err[-2000:]}")
    return (f"launcher --continuous --router --page-size 16 "
            f"({time.perf_counter() - t0:.1f} s, beside (c)-(e)): "
            f"{' | '.join(lines)}")


# ------------------------------------------------------------ phase 22
MESH_SPEC, MESH_CHIPS = "2x2", 4  # (a)-(c): DATA x MODEL logical chips
MESH_LAUNCH_REQUESTS = 8  # (c)
DRYRUN_CELLS = (("xlstm-125m", "decode_32k", False),  # (d): the JAX
                ("qwen2-1.5b", "train_4k", False),  # package's dry-run
                ("recurrentgemma-9b", "long_500k", True))  # tests' cells


def serve_run(dev, seed: int) -> ServeRun:
    """Phase 9's model, gate and traffic without its host-batcher run
    (``--phase22`` alone)."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    from repro_torch.data import load_dataset

    cfg = get_config("qwen2-1.5b")
    params = M.init_params(cfg, seed, dev)
    ds = load_dataset("unsw", n=4000)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                     SERVE_REQUESTS)]
    feats = ds.X_test[np.arange(SERVE_REQUESTS) % len(ds.X_test)]
    return ServeRun(cfg, params, serve_gate(dev), prompts, feats, None, 0.0,
                    {})


def meshed(run: ServeRun, dev, tp_params: bool):
    """Phase 16's router on a MESH_SPEC mesh of logical chips on the card:
    one shard a data slice, each a device batcher as phase 11's."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.router import ShardedServe

    mesh = make_serve_mesh(MESH_SPEC, chips=MESH_CHIPS, device=dev)
    return ShardedServe(run.cfg, run.params, ServeConfig(**SERVE), mesh,
                        gate=run.gate, eos_token=-1, max_tokens=SERVE_TOKENS,
                        sync_every=DEVICE_ROUND, prefill_chunk=DEVICE_CHUNK,
                        tp_params=tp_params, device=dev)


def drive_mesh(run: ServeRun, dev) -> Dict[str, Any]:
    """(a) replicated, (b) ``tp_params``: the checks of the module
    docstring; then warm waves of both and of phase 16's two mesh-less
    shards, timed in turns."""
    from repro_torch.kernels import ops

    a = meshed(run, dev, False)
    if a.n_shards != 2 or [m.device_ids() for m in a.submeshes] != [
            [0, 1], [2, 3]]:
        fail(f"(22a) {a.n_shards} shards over {a.submeshes}")
    ops.reset_launch_counts()
    route_wave(a, run, dev)
    launches = ops.launch_counts()
    for k in ("fused_eb", *step_kernels(run.cfg)):
        if launches[k] <= 0:
            fail(f"(22a) the mesh router did not launch {k}: {launches}")
    check_terminal_once(a, SERVE_REQUESTS, "(22a)")
    held = [len(rids) for rids in a.assigned]
    for s, rids in enumerate(a.assigned):
        if not rids or rids != sorted(rids):
            fail(f"(22a) shard {s} holds {rids}: empty, or not FIFO")
        lone = device_batcher(run, dev)
        for rid in rids:
            lone.submit(rid, run.prompts[rid], features=run.feats[rid])
        lone.run(max_steps=20000)
        for rid in rids:
            if a.done.get(rid) != lone.done.get(rid) or (
                    a.drop_reasons.get(rid) != lone.drop_reasons.get(rid)):
                fail(f"(22a) request {rid} on shard {s} differs from the "
                     f"lone batcher's")
        del lone
    b = meshed(run, dev, True)
    route_wave(b, run, dev)
    check_terminal_once(b, SERVE_REQUESTS, "(22b)")
    if b.assigned != a.assigned:
        fail(f"(22b) tp_params routed {b.assigned}, (a) {a.assigned}")
    check_replayed(b, a, "(22b)")
    plain = sharded(run, dev, ROUTER_SHARDS)  # phase 16's two shards
    route_wave(plain, run, dev)
    if plain.assigned != a.assigned:
        fail(f"(22a) the mesh-less router routed {plain.assigned}, the "
             f"mesh's {a.assigned}")
    check_replayed(plain, a, "(22a) mesh-less")

    def timed(r):  # a warm wave, the garbage of earlier ones collected
        gc.collect()
        return timed_route(r, run, dev)

    # in turns (n, a, b, b, a, n): a difference must beat the spread
    t = {"n": [timed(plain)], "a": [timed(a)], "b": [timed(b), timed(b)]}
    t["a"].append(timed(a))
    t["n"].append(timed(plain))
    out = dict(a=a, launches=launches, held=held, t=t)
    del b, plain
    torch.cuda.empty_cache()
    return out


def launcher_mesh_start(dev):
    """(c) the launcher on the MESH_SPEC mesh in a child process, started
    while (d) plans."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--continuous", "--router", "--mesh", MESH_SPEC,
         "--page-size", "16", "--requests", str(MESH_LAUNCH_REQUESTS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def launcher_mesh_check(proc) -> str:
    try:
        out, err = proc.communicate(timeout=600)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    import re

    lines = [ln for ln in out.splitlines()
             if ln.startswith(("router:", "[router]"))]
    ends = re.search(r"served (\d+) requests \(dropped (\d+)",
                     lines[-1] if lines else "")
    if proc.returncode != 0 or len(lines) != 2 or (
            "2 shard(s)" not in lines[0]) or ends is None or (
            int(ends[1]) + int(ends[2]) != MESH_LAUNCH_REQUESTS):
        fail(f"(22c) the launcher's --mesh {MESH_SPEC} run: rc "
             f"{proc.returncode}, {out[-800:]} {err[-2000:]}")
    return " | ".join(lines)


def check_dryrun() -> list:
    """(d) ``launch.dryrun``'s CLI on DRYRUN_CELLS, in process, on the
    card: exit 0 and one ``OK`` line each whose arguments fit."""
    import io

    from repro_torch.launch import dryrun

    lines = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        buf = io.StringIO()
        argv = ["--arch", arch, "--shape", shape] + (
            ["--multi-pod"] if multi_pod else [])
        with contextlib.redirect_stdout(buf):
            try:
                dryrun.main(argv)
                code = 0
            except SystemExit as e:
                code = e.code
        ok = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("OK ")]
        if code != 0 or len(ok) != 1 or "fit=yes" not in ok[0]:
            fail(f"(22d) launch.dryrun {' '.join(argv)}: exit {code}, "
                 f"{buf.getvalue()[-1500:]}")
        lines.append(" ".join(ok[0].split()))
    return lines


def phase22(run: ServeRun, dev, card: str, two=None) -> None:
    """Phase 22: serving over a mesh of logical chips (a)-(c) and the
    dry-run planner (d); every check a hard failure.  ``two``: phase 16's
    two-shard warm wave, printed beside (a) and (b)."""
    t_all = time.perf_counter()
    proc = launcher_mesh_start(dev)
    t0 = time.perf_counter()
    try:
        planned = check_dryrun()
    except BaseException:
        proc.kill()
        raise
    t_d = time.perf_counter() - t0
    launched = launcher_mesh_check(proc)
    print(f"[22 c launcher] launch.serve --arch qwen2-1.5b --continuous "
          f"--router --mesh {MESH_SPEC} --page-size 16 --requests "
          f"{MESH_LAUNCH_REQUESTS}: {launched} "
          f"({time.perf_counter() - t_all:.1f} s, beside (d); {card})")
    for line in planned:
        print(f"[22 d dryrun] {line} ({card})")
    print(f"[22 d dryrun] {len(planned)} cells planned on meta tensors in "
          f"{t_d:.1f} s")
    t0 = time.perf_counter()
    m = drive_mesh(run, dev)
    print(f"[22 a mesh] {SERVE}, phase 9's {SERVE_REQUESTS} requests through "
          f"ShardedServe on a {MESH_SPEC} mesh of {MESH_CHIPS} logical chips "
          f"on the card (slices {[s.device_ids() for s in m['a'].submeshes]}"
          f", params replicated): every request terminal once "
          f"({len(wave_streams(m['a']))} served, drops "
          f"{first_wave_drops(m['a'])[1]}), shards hold {m['held']} in FIFO "
          f"order, each shard's streams and drops bitwise a lone device "
          f"batcher's and the mesh-less {ROUTER_SHARDS}-shard router's; "
          f"wrapper launches "
          f"{dict((k, n) for k, n in m['launches'].items() if n)}; (b) "
          f"tp_params=True: routing, streams and drops bitwise (a)'s "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    for tag, key in (("(a) mesh, replicated", "a"), ("(b) mesh, tp_params",
                                                     "b"),
                     (f"{ROUTER_SHARDS} mesh-less shards", "n")):
        ts = m["t"][key]
        rates = ", ".join(f"{x['tokens_s']:.1f}" for x in ts)
        steps = ", ".join(f"{x['ms_step']:.4f}" for x in ts)
        print(f"[22 mesh timing] {tag}, two warm waves (in turns n, a, b, "
              f"b, a, n; garbage collected before each), graph: "
              f"{ts[0]['tokens']} tokens each, {rates} tokens/s, {steps} ms "
              f"per step run ({ts[0]['steps']} steps a wave; the shards "
              f"take turns on the card) ({card})")
    if two is not None:
        print(f"[22 mesh timing] phase 16's {ROUTER_SHARDS} mesh-less shards "
              f"(one warm wave, no collection): {two['tokens_s']:.1f} "
              f"tokens/s, {two['ms_step']:.4f} ms per step run ({card})")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[22] phase 22 in {time.perf_counter() - t_all:.1f} s ({card})")


# ------------------------------------------------------------ phase 17
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_FORCED = 4  # (d) requests teacher-forced (the plain MoE is slow)
# (d): deltas a position's logits may lie from the reference path's, and
# on average over the positions: about 2x and 1.4x the largest readings of
# one rounding's effect (the plain path 1.961 / 1.193 at worst / on
# average, the witness 3.169 / 1.446), far under the control's (59.661 /
# 46.908; all four on the H100, seed 0)
MOE_LOGIT_LIMIT = 6.0
MOE_LOGIT_MEAN = 2.0
MOE_ROWS = (1, 7, 16, 128, 200, 256)  # (b): M of the kernel vs plain
MOE_STEP = 48  # (b): the device-batcher step whose every layer is captured


def moe_kernel_row(moe: ServeRun, dev, captured,
                   layers) -> Dict[str, Any]:
    """(b) ``moe_down_combine`` bitwise its plain version at M in MOE_ROWS
    on layer 0's ``w_down`` (each row's top-k of the real experts, tied
    and zero weights among them: ``test_torch_cuda.combine_case``) and on
    the skewed routings of ``MOE_SKEWS``, and the JSON row at the step's
    shape on the inputs ``captured`` from a C = 8 chunk of 16 sequences
    (layer 0's h and combine): events, device time, the plain version,
    ``torch.einsum`` of the down product plus the weighted sum (the
    library yardstick), and the bound of what these inputs need (the
    picked experts' W_down slices and h rows read once, 2 flops a
    product) beside the same flops on the float32 lanes; ``layers``
    (``moe_layers``) joins it as ``per_layer``."""
    from test_torch_cuda import MOE_SKEWS, combine_case

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.moe import moe_down_combine_bytes, plan

    w = moe.params["layers"][0]["moe"]["w_down"]
    E, F, D = w.shape
    cfg = moe.cfg
    cases = [(M, None) for M in MOE_ROWS] + [(M, s) for s, M in MOE_SKEWS]
    for M, skew in cases:
        c = combine_case(SEED + M, M, E, cfg.n_experts, cfg.n_experts_active,
                         dev, skew)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + M)
        h = torch.randn((M, E, F), generator=gen, device=dev).to(
            torch.bfloat16)
        if not torch.equal(ops.moe_down_combine(h, w, c),
                           ref.moe_down_combine_ref(h, w, c)):
            fail(f"(17b) moe_down_combine at M = {M} (skew {skew}) differs "
                 f"from its plain version")
    h, c = captured
    got = ops.moe_down_combine(h, w, c)
    want = ref.moe_down_combine_ref(h, w, c)
    if not torch.equal(got, want):
        fail("(17b) moe_down_combine on the captured step inputs differs "
             "from its plain version")
    M = h.shape[0]
    pairs = int((c != 0).sum())

    def library():
        y = torch.einsum("mef,efd->med", h, w)
        return torch.einsum("med,me->md", y, c)

    n_bytes = moe_down_combine_bytes(h, w, c)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = 2 * pairs * F * D / PEAK_BF16_FLOPS * 1e3
    return {
        "name": "moe_down_combine", "route": "cuda", "source": MOE_SOURCE,
        "replaces": REPLACES["moe_down_combine"], "launches": None,
        "bitwise": True, "max_abs_err": 0.0,
        "ms": time_ms(lambda: ops.moe_down_combine(h, w, c)),
        "device_ms": device_ms(lambda: ops.moe_down_combine(h, w, c),
                               spins=True),
        "plain_ms": time_ms(lambda: ref.moe_down_combine_ref(h, w, c),
                            reps=3, warmup=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "fp32_lane_ms": 2 * pairs * F * D / PEAK_FP32_FLOPS * 1e3,
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library, spins=True),
        "library_max_abs_err": (library().float() - want.float()).abs().max()
        .item(),
        "shape": {"M": M, "E": E, "F": F, "D": D, "pairs": pairs,
                  "experts_picked": int((c != 0).any(0).sum()),
                  "bytes": n_bytes, "checked_bitwise_at_M": list(MOE_ROWS),
                  "checked_bitwise_skewed": [list(x) for x in MOE_SKEWS],
                  "grid": _build.load("moe").moe_grid(),
                  "down_items": len(plan(c, D)["items"])},
        "per_layer": layers,
    }


def capture_moe_step(moe: ServeRun, dev) -> Dict[str, Any]:
    """Phase 9's wave through an eager device batcher (C = DEVICE_CHUNK,
    so M = 128 rows a layer): every layer's (h, combine) of step
    MOE_STEP, and for every step and layer the most rows any expert took
    (``most`` [steps, layers], on the host after the wave)."""
    from repro_torch.kernels import ops

    L = moe.cfg.n_layers
    kernel, layers, most = ops.moe_down_combine, [], []

    def record(h, w, c):
        if len(most) // L == MOE_STEP:
            layers.append((h.clone(), c.clone()))
        most.append((c != 0).sum(0).max())  # stays on the card
        return kernel(h, w, c)

    cb = device_batcher(moe, dev, graph=False)
    ops.moe_down_combine = record
    try:
        device_wave(cb, moe, dev)
    finally:
        ops.moe_down_combine = kernel
    if len(most) % L or len(layers) != L:
        fail(f"(17b) the eager wave made {len(most)} moe_down_combine "
             f"calls, not {L} a step past step {MOE_STEP}")
    return {"layers": layers, "most": torch.stack(most).reshape(-1, L).cpu()}


def moe_layers(moe: ServeRun, dev, step: Dict[str, Any]) -> list:
    """(b) each layer's ``moe_down_combine`` on the inputs of
    ``capture_moe_step``: bitwise its plain version; its routing (experts
    picked, rows an expert: most and mean over the picked ones; the most
    rows an expert took in any step of the wave, mean and max over the
    steps), its work items and the kernel's device time (``kernel_ms``)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe import plan

    out = []
    for layer, (h, c) in enumerate(step["layers"]):
        w = moe.params["layers"][layer]["moe"]["w_down"]
        if not torch.equal(ops.moe_down_combine(h, w, c),
                           ref.moe_down_combine_ref(h, w, c)):
            fail(f"(17b) moe_down_combine on layer {layer}'s inputs of step "
                 f"{MOE_STEP} differs from its plain version")
        rows = (c != 0).sum(0)
        picked = rows[rows > 0].float()
        wave = step["most"][:, layer].float()
        out.append({
            "layer": layer, "pairs": int(rows.sum()),
            "picked": int(picked.numel()), "max_rows": int(picked.max()),
            "mean_rows": round(float(picked.mean()), 3),
            "wave_max_rows_mean": round(float(wave.mean()), 3),
            "wave_max_rows_max": int(wave.max()),
            "down_items": len(plan(c, w.shape[2])["items"]),
            "device_ms": kernel_ms(
                lambda h=h, w=w, c=c: ops.moe_down_combine(h, w, c),
                "moe_down_combine_kernel")})
    return out


def capture_moe_inputs(moe: ServeRun, dev):
    """Layer 0's (h, combine) of the first ``moe_down_combine`` call of a
    C = DEVICE_CHUNK chunk over 16 sequences (phase 9's first 16 prompts'
    heads): the kernel's inputs at the device batcher's step shape."""
    from repro_torch.arch import model as M
    from repro_torch.kernels import ops

    kernel, got = ops.moe_down_combine, []

    def record(h, w, c):
        if not got:
            got.append((h.clone(), c.clone()))
        return kernel(h, w, c)

    B, n_ps = SERVE["max_batch"], SERVE["cache_len"] // SERVE["page_size"]
    kv = M.init_paged_kv(moe.cfg, B * n_ps, SERVE["page_size"], device=dev)
    toks = np.zeros((B, DEVICE_CHUNK), np.int32)
    n_new = np.zeros(B, np.int32)
    for b, p in enumerate(moe.prompts[:B]):
        n_new[b] = min(len(p), DEVICE_CHUNK)
        toks[b, : n_new[b]] = p[: n_new[b]]
    ops.moe_down_combine = record
    try:
        M.paged_decode_step(
            moe.params, kv,
            torch.arange(B * n_ps, dtype=torch.int32,
                         device=dev).reshape(B, n_ps),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(n_new, device=dev), moe.cfg)
    finally:
        ops.moe_down_combine = kernel
    del kv
    return got[0]


def check_moe_rows(moe: ServeRun, dev) -> str:
    """(c) the first MOE_FORCED served streams teacher-forced at C = 8 and
    C = 1 through the kernel path: every logit bitwise (each row's bits
    independent of the chunk)."""
    done = {r: moe.cb.done[r] for r in sorted(moe.cb.done)[:MOE_FORCED]}
    c8 = teacher_rows(moe, done, dev, "cuda", chunk=DEVICE_CHUNK)
    c1 = teacher_rows(moe, done, dev, "cuda", chunk=1)
    if c8.keys() != c1.keys() or any(not torch.equal(c8[k], c1[k])
                                     for k in c8):
        fail("(17c) teacher-forced logits at C = 8 differ from C = 1")
    return (f"(c) {len(c8)} teacher-forced positions of {len(done)} streams "
            f"bitwise equal at C = {DEVICE_CHUNK} and C = 1")


def ordered_bf16(t: torch.Tensor) -> torch.Tensor:
    """int32 keys of bf16 ``t``, monotone in the value, adjacent bf16
    values one apart (both zeros are 0)."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i >= 0, i, -32768 - i)


def from_ordered(o: torch.Tensor) -> torch.Tensor:
    """The bf16 values of ``ordered_bf16`` keys."""
    return torch.where(o >= 0, o, -32768 - o).to(torch.int16).view(
        torch.bfloat16)


def check_moe_parity(moe: ServeRun, dev) -> str:
    """(d) The first MOE_FORCED served streams teacher-forced (C = 32) on
    the card, every other path held to the kernel path's routing
    (``ForcedRouting``: in the plain path each token that would have
    routed otherwise must be a near tie), logits compared per position in
    deltas of LOGIT_TOL * max |reference logits|.  (i) The plain path
    (plain attention and plain ``moe_down_combine``): the attention kernel
    on the inputs of every one of its calls within one bf16 ulp of the
    plain output (phase 10 (a)'s gate), and the kernel path's logits
    within MOE_LOGIT_LIMIT deltas at every position and MOE_LOGIT_MEAN on
    average.  Phase 10's one delta does not hold here: the kernel and the
    plain attention differ by one rounding on a few of their elements,
    and through 24 random MoE layers that moves the logits by about one
    delta.  (ii) The witness of that cause: the kernel path with one bf16
    ulp added to or taken from the same share of its attention outputs'
    nonzero elements, at random, must lie within the gate of the kernel
    path too.  (iii) The control: the kernel path with each token's top
    expert replaced by its best unpicked one must lie past the gate of
    the plain path, or the gate could not see a misrouted expert."""
    from repro_torch.kernels import ops
    from repro_torch.nn import attn_backend as AB

    done = {r: moe.cb.done[r] for r in sorted(moe.cb.done)[:MOE_FORCED]}
    forced = ForcedRouting()
    with forced.record():
        kern = teacher_rows(moe, done, dev, "cuda")
    plain, kernel = AB.get("torch"), AB.get("cuda")
    worst, calls, differ = [0.0], [0], [0, 0]

    def capturing(q, kv, *, n_heads, head_dim, window):
        out = plain(q, kv, n_heads=n_heads, head_dim=head_dim, window=window)
        got = ops.paged_attention(q, kv.k, kv.v, kv.block_tbl, kv.pos,
                                  window, kv.k_scale, kv.v_scale)
        worst[0] = max(worst[0], pa_err_ulps(
            f"(17d) attention call {calls[0]}", got, out))
        calls[0] += 1
        differ[0] += int((got != out).sum())
        differ[1] += int((out != 0).sum())
        return out

    AB.register("torch-capture-moe", capturing)
    with forced.replay(), plain_moe():
        full = teacher_rows(moe, done, dev, "torch-capture-moe")
    routings, plain_flips = forced.rows, (forced.flips, forced.loose,
                                          forced.worst)
    share = differ[0] / differ[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def noisy(q, kv, **kw):
        out = kernel(q, kv, **kw)
        r = torch.rand(out.shape, generator=gen, device=out.device)
        r = torch.where((out != 0) & torch.isfinite(out), r, 1.0)
        step = torch.where(r < share / 2, -1, (r < share).to(torch.int32))
        return from_ordered(ordered_bf16(out) + step).view(out.shape)

    AB.register("cuda-ulp-noise", noisy)
    with forced.replay():
        noise = teacher_rows(moe, done, dev, "cuda-ulp-noise")
    noise_flips = (forced.flips, forced.loose, forced.worst)
    with forced.replay(misroute=True):
        control = teacher_rows(moe, done, dev, "cuda")
    keys = sorted(kern)

    def deltas(got, want):
        a = torch.stack([got[k] for k in keys])
        c = torch.stack([want[k] for k in keys])
        return (a - c).abs().amax(-1) / (LOGIT_TOL * c.abs().amax(-1)), (
            a.argmax(-1) == c.argmax(-1)).float().mean().item()

    (sound, agree), (wit, _), (ctl, _) = (
        deltas(kern, full), deltas(noise, kern), deltas(control, full))
    lim = MOE_LOGIT_LIMIT

    def reading(r):
        return (f"{r.mean().item():.3f} delta on average, "
                f"{r.min().item():.3f} to {r.max().item():.3f}, "
                f"{int((r > 1).sum())} past one delta, "
                f"{int((r > lim).sum())} past {lim}")

    def passes(r):
        return r.max() <= lim and r.mean() <= MOE_LOGIT_MEAN

    def flips(f):
        return (f"{f[0]} routings would have flipped, {f[1]} of them no near "
                f"tie (worst {f[2]:.3f} of the near-tie bound)")

    line = (f"(d) {len(keys)} teacher-forced positions of {len(done)} "
            f"streams, {routings} token-layer routings a path: (i) the plain "
            f"path ({flips(plain_flips)}): the attention kernel within one "
            f"bf16 ulp of the plain output on all {calls[0]} calls' inputs "
            f"(worst {worst[0]:.2f} ulp of the largest; {differ[0]} of its "
            f"{differ[1]} nonzero elements differ, a share of {share:.3e}); "
            f"logits {reading(sound)}; greedy agreement {agree:.4f}; (ii) "
            f"the witness, the kernel path with one ulp on that share of "
            f"its attention elements ({flips(noise_flips)}): {reading(wit)} "
            f"from the kernel path; (iii) the control, the top expert "
            f"misrouted: {reading(ctl)} from the plain path")
    if plain_flips[1]:
        fail(f"(17d) the plain path routed a token otherwise than the kernel "
             f"path where its top-k was no near tie: {line}")
    gate = f"{lim} deltas a position, {MOE_LOGIT_MEAN} on average"
    if not passes(sound):
        fail(f"(17d) the kernel path's logits lie past {gate} of the plain "
             f"path's: {line}")
    if not passes(wit):
        fail(f"(17d) the witness lies past {gate}: {line}")
    if passes(ctl):
        fail(f"(17d) the control lies within {gate} of the plain path, so "
             f"the gate cannot see it: {line}")
    return (f"{line}; the gate, {gate}: both sound readings within it, the "
            f"control past it")


def check_moe_dense(moe: ServeRun, dev) -> str:
    """(e) one wave of phase 9's first 16 requests, first prompt token
    only (every kept slot admitted at step 0): the paged device batcher
    (page 16) and the dense one (no page_size, the same cache_len) give
    every stream and drop bitwise."""
    from repro_torch.serve.engine import (DeviceContinuousBatcher,
                                          ServeConfig, ServeEngine)

    n, out = SERVE["max_batch"], []
    for scfg in (SERVE, DENSE):
        cb = DeviceContinuousBatcher(
            ServeEngine(moe.cfg, moe.params, ServeConfig(**scfg),
                        gate=moe.gate, device=dev),
            eos_token=-1, max_tokens=SERVE_TOKENS, sync_every=DEVICE_ROUND)
        device_wave(cb, moe, dev, n=n, dense=True)
        check_terminal(cb, moe, f"(17e) {scfg}", SERVE_TOKENS, n)
        out.append(cb)
    same_run("(17e) paged vs dense device batcher", *out)
    del out
    torch.cuda.empty_cache()
    return (f"(e) paged == dense device batcher bitwise on {n} single-token "
            f"prompts (one wave)")


def moe_linear_units(cfg):
    """The MoE step's products that a dense step lacks: the router (N =
    E), the experts' gate/up group (N = E x F each), the shared experts'
    gate/up group and down."""
    D, EF, S = cfg.d_model, cfg.n_experts_padded * cfg.d_ff, cfg.shared_d_ff
    return [("router", [(D, cfg.n_experts_padded, False)]),
            ("experts_gate_up", [(D, EF, False), (D, EF, False)]),
            ("shared_gate_up", [(D, S, False), (D, S, False)]),
            ("shared_down", [(S, D, False)])]


def moe_linear_weights(cfg):
    """``moe_linear_units`` as ``check_linear``'s (name, K, N, float32
    out): one entry a unit, since a group's members share their shape."""
    return [(name, *members[0]) for name, members in moe_linear_units(cfg)]


def phase16(serve: ServeRun, d: DeviceRun, prof: Dict[str, Any], dev,
            card: str) -> Dict[str, float]:
    """Phase 16: phase 9's model, gate and traffic through the mesh-less
    router (checks (a)-(e), the timings, the launcher's --router run)."""
    t0 = time.perf_counter()
    r16 = drive_router(serve, d, dev)
    print(f"[16 router] (a) {SERVE}, phase 9's {SERVE_REQUESTS} requests "
          f"through ShardedServe(mesh=None, n_shards=1): every stream, drop "
          f"and reason bitwise phase 11's device batcher "
          f"({len(wave_streams(r16['one']))} served, drops "
          f"{first_wave_drops(r16['one'])[1]}), wrapper launches "
          f"{ {k: n for k, n in r16['launches'].items() if n} }; (b) "
          f"n_shards={ROUTER_SHARDS}: shards hold "
          f"{[len(a) for a in r16['two'].assigned]} requests in FIFO order, "
          f"each shard's streams and drops bitwise a lone device batcher's "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    for tag, key in (("1 shard", "t_one"), (f"{ROUTER_SHARDS} shards",
                                            "t_two")):
        t = r16[key]
        print(f"[16 router timing] {tag}, warm wave, graph: {t['tokens']} "
              f"tokens in {t['seconds']:.4f} s, {t['tokens_s']:.1f} "
              f"tokens/s, {t['ms_step']:.4f} ms per step run ({t['steps']} "
              f"steps; the shards take turns on the card); phase 11's warm "
              f"wave {prof['tokens'] / prof['seconds']:.1f} tokens/s, "
              f"{prof['ms_step']:.4f} ms per step run ({card})")
    child = launcher_router_start()
    try:
        for check in (lambda: check_router_faults(serve, r16["one"], dev),
                      lambda: check_router_launches(serve, dev),
                      lambda: launcher_router_check(*child)):
            t0 = time.perf_counter()
            line = check()
            print(f"[16 router] {line} ({time.perf_counter() - t0:.1f} s; "
                  f"{card})")
    finally:
        if child[0].poll() is None:
            child[0].kill()
            child[0].communicate()
    return r16["t_two"]


def phase17(dev, seed: int, card: str) -> tuple:
    """Phase 17: qwen2-moe-a2.7b at full width (SERVE_DEPTH) through the
    host and device batchers (checks (a)-(f), the timings): (the
    ``moe_down_combine`` JSON row, the MoE step's ``linear`` timings)."""
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    moe = drive_serve(dev, seed, arch=MOE_ARCH)
    mcfg = moe.cfg
    n_params = sum(p.numel() for leaf in leaves(moe.params)
                   for p in leaf.parts)
    print(f"[17 moe] {MOE_ARCH} at {width_depth(mcfg)} ({mcfg.n_layers} "
          f"layers, d {mcfg.d_model}, {mcfg.n_heads}/{mcfg.n_kv_heads} heads, "
          f"hd {mcfg.head_dim_}, {mcfg.n_experts} experts padded to "
          f"{mcfg.n_experts_padded}, top-{mcfg.n_experts_active}, expert "
          f"d_ff {mcfg.d_ff}, shared {mcfg.shared_d_ff}, vocab "
          f"{mcfg.vocab_padded}), {n_params / 1e9:.2f} B parameters "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated), "
          f"RANDOM weights from seed {seed}; host batcher, {SERVE}: "
          f"{check_serve(moe)} ({time.perf_counter() - t0:.1f} s; {card})")
    print(f"[17 moe] (f) host batcher, {moe.cb.steps} steps: wrapper "
          f"launches == steps x {step_kernels(mcfg)} exactly")
    t0 = time.perf_counter()
    line = check_linear(mcfg, dev, moe_linear_weights(mcfg), "17 linear")
    print(f"[17 linear] the MoE step's new products: {line} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    moe_lin = linear_timings(mcfg, dev, units=moe_linear_units(mcfg))
    for t in moe_lin:
        print(f"[17 linear timing] {t['weight']} [{t['M']}, {t['K']}] x "
              f"N {t['N']}, max |kernel - plain| {t['max_abs_err']}, "
              f"L2-cold over {t['copies']} copies: kernel "
              f"{t['ms']:.4f} ms (device {t['device_ms']}), cuBLAS "
              f"{t['library_ms']} ms (device {t['library_device_ms']}), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) ({card})")
    t0 = time.perf_counter()
    step = capture_moe_step(moe, dev)
    layers = moe_layers(moe, dev, step)
    for r in layers:
        print(f"[17 moe layer {r['layer']}] step {MOE_STEP} of "
              f"{len(step['most'])}: {r['pairs']} routed pairs, "
              f"{r['picked']} experts picked, rows an expert max "
              f"{r['max_rows']} mean {r['mean_rows']}; the wave's most rows "
              f"an expert a step: mean {r['wave_max_rows_mean']} max "
              f"{r['wave_max_rows_max']}; {r['down_items']} down items; "
              f"bitwise its plain version; device {r['device_ms']} ms "
              f"({card})")
    del step
    moe_row = moe_kernel_row(moe, dev, capture_moe_inputs(moe, dev), layers)
    print(f"[17 moe] (b) moe_down_combine bitwise its plain version on "
          f"layer 0's w_down at M in {MOE_ROWS} (tied and zero weights), on "
          f"skewed routing {moe_row['shape']['checked_bitwise_skewed']}, "
          f"on every layer's inputs of an eager device-batcher step and "
          f"on the captured step inputs {moe_row['shape']}: kernel "
          f"{moe_row['ms']:.4f} ms (device {moe_row['device_ms']}), plain "
          f"{moe_row['plain_ms']:.4f} ms, einsum pair "
          f"{moe_row['library_ms']:.4f} ms (device "
          f"{moe_row['library_device_ms']}), bound "
          f"{moe_row['bound_ms']:.4f} ms ({moe_row['bound_by']}), the same "
          f"flops on the float32 lanes {moe_row['fp32_lane_ms']:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    dm = drive_device(moe, dev)
    print(f"[17 moe] {check_device_main(dm, moe)} ({card})")
    tbt = device_batcher(moe, dev, chunk=1)
    device_wave(tbt, moe, dev)
    same_run("(17e) device batcher prefill_chunk 1 vs the host batcher", tbt,
             moe.cb)
    print(f"[17 moe] (e) host batcher == device batcher (prefill_chunk 1) "
          f"bitwise: {len(moe.cb.done)} streams, drops "
          f"{moe.cb.drop_reasons}")
    print(f"[17 moe] {check_chunked(dm.cb, tbt, moe, dev, '(c)')}")
    del tbt
    torch.cuda.empty_cache()
    for check in (lambda: check_moe_rows(cut_depth(moe), dev) + (
                      f" ({SERVE_CUT} layers, full width)"),
                  lambda: check_moe_parity(moe, dev),
                  lambda: check_moe_dense(moe, dev)):
        t0 = time.perf_counter()
        line = check()
        print(f"[17 moe] {line} ({time.perf_counter() - t0:.1f} s; {card})")
    mprof = profile_device(dm.cb, moe, dev)
    print(f"[17 moe] (f) profiler over a round of {mprof['rsteps']} steps "
          f"and its gate call: {mprof['counts']}, exact on try "
          f"{len(mprof['tries'])} of at most {PROFILE_TRIES} (each try's "
          f"counts: {mprof['tries']}) ({card})")
    print(f"[17 moe timing] device batcher, warm wave, graph: "
          f"{mprof['tokens']} tokens in {mprof['seconds']:.4f} s, "
          f"{mprof['tokens'] / mprof['seconds']:.1f} tokens/s, "
          f"{mprof['ms_step']:.4f} ms per step run ({mprof['steps']} steps); "
          f"device {mprof['busy_ms_step']:.4f} ms a step (profiler: "
          f"{mprof['by']}), idle {mprof['idle']:.3f}; host batcher "
          f"{sum(len(t) for t in moe.cb.done.values()) / moe.seconds:.1f} "
          f"tokens/s, {moe.seconds / moe.cb.steps * 1e3:.4f} ms per step; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB ({card})")
    moe_row["launches"] = moe.launches["moe_down_combine"]
    return moe_row, moe_lin


# ------------------------------------------------------------ phase 18
HYBRID_ARCH, XLSTM_ARCH = "recurrentgemma-9b", "xlstm-125m"
REC_ARCHS = (HYBRID_ARCH, XLSTM_ARCH)
# (e): examples/train_lm.py's settings: 8 x 128 tokens in 2 microbatches,
# lr 3e-3; 20 steps of the launcher at REC_TRAIN_LAYERS (one macro, full
# width): the full 12 layers took 105 s of the run's limit (5.1-5.3 s a
# step, the sLSTM's host loop), 4 layers 35.4 s on a slow host, when phase
# 21's elastic drill trains the same macro again
REC_TRAIN_LAYERS = 2
REC_TRAIN_STEPS, REC_TRAIN_BATCH, REC_TRAIN_SEQ, REC_TRAIN_MICRO = (
    20, 8, 128, 2)
REC_TRAIN_ARGS = ["--arch", XLSTM_ARCH, "--batch", "8", "--seq", "128",
                  "--microbatches", "2", "--lr", "3e-3", "--steps",
                  str(REC_TRAIN_STEPS), "--ckpt-every", "50", "--layers",
                  str(REC_TRAIN_LAYERS)]
REC_TIMED = (5, REC_TRAIN_STEPS)  # (e): steps whose median is a step's
REC_PARITY_STEPS = 2  # (e): steps through the kernel and the plain path
# (e): the parity's depth, one macro (an mLSTM and an sLSTM) at full
# width, as phase 15 (b) cuts qwen2 to TRAIN_CUT layers.  At the full 12
# layers the random model's gradient is chaotic: the JAX package's own
# jitted and op-by-op gradients of one xlstm-125m loss differ by 29-36% of
# each leaf's norm (seq 16, on the CPU), and a product rounded otherwise
# by 13-46% (seq 16-128); at 2 layers by at most 1.3% (PERF.md §6)
REC_PARITY_LAYERS = 2
REC_PROFILE_STEPS = 12  # (a)/(d): eager host-batcher steps profiled
# the JAX package's leaves of each mixer (src/repro/nn/recurrent.py,
# src/repro/nn/attention.py) and a layer: (e)'s checkpoint keys are built
# from these, not from the port's tree
JAX_MIXER_LEAVES = {
    "mlstm": ("wq", "wk", "wv", "w_i", "w_f", "b_f", "w_gate", "w_out",
              "conv"),
    "slstm": ("w_gates", "r_gates", "b_gates", "w_out"),
    "rglru": ("w_lin", "w_gate", "w_out", "w_rec_gate", "w_in_gate", "lam",
              "conv"),
    "attn": ("wq", "wk", "wv", "wo")}


def rec_run(dev, seed: int, arch: str, gate) -> ServeRun:
    """``arch`` at its published width (its depth ``served_config``'s),
    random weights from ``seed``, phase 9's gate and traffic (prompts drawn
    in the model's vocabulary): the ``ServeRun`` the dense checks of phase
    14 take."""
    from repro_torch.arch import model as M
    from repro_torch.data import load_dataset

    cfg = served_config(arch)
    params = M.init_params(cfg, seed, dev)
    ds = load_dataset("unsw", n=4000)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                     SERVE_REQUESTS)]
    feats = ds.X_test[np.arange(SERVE_REQUESTS) % len(ds.X_test)]
    return ServeRun(cfg, params, gate, prompts, feats, None, 0.0, {})


def rec_generate(run: ServeRun, dev, tag: str) -> Dict[str, Any]:
    """``ServeEngine.generate`` on the dense engine with the gate fused,
    phase 9's first 16 prompts' 4-token heads, DENSE_GENERATE tokens: the
    wrapper counts, reset just before and read just after, exactly the
    steps x (``step_kernels`` + the gate's tables); every token in the
    vocabulary."""
    from repro_torch.kernels import ops

    B, P, n = DENSE["max_batch"], 4, DENSE_GENERATE
    eng = dense_engine(run, dev)
    prompts = np.array([p[:P] for p in run.prompts[:B]], np.int32)
    feats = run.feats[:B]
    eng.generate(prompts[:, :1], 2, features=feats)  # warm-up
    eng.state = None  # a fresh decode state
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, n, features=feats)
    seconds = time.perf_counter() - t0
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    steps = P + n - 1
    want = {k: steps * c for k, c in step_kernels(run.cfg).items() if c}
    want["fused_eb"] = steps * gate_tables(run.gate)
    if counts != want:
        fail(f"{tag} generate launched {counts} in {steps} steps, expected "
             f"{want}")
    # generate argmaxes over the padded vocabulary, as the JAX package's
    # does (a random head's padded columns can win; the batchers
    # quarantine such a token, generate returns it)
    if out.shape != (B, n) or not ((out >= 0) & (out < run.cfg.vocab_padded)
                                   ).all():
        fail(f"{tag} generate gave {out.shape} tokens, or past the padded "
             f"vocabulary")
    return dict(seconds=seconds, steps=steps, tokens=B * n, counts=counts)


def rec_graph_eager(run: ServeRun, device, dev, tag: str) -> float:
    """The dense device batcher without its CUDA graph on the same wave:
    every stream, drop and reason bitwise the captured one's."""
    from repro_torch.serve.engine import DeviceContinuousBatcher

    eager = DeviceContinuousBatcher(dense_engine(run, dev), eos_token=-1,
                                    max_tokens=SERVE_TOKENS,
                                    sync_every=DEVICE_ROUND, graph=False)
    seconds = device_wave(eager, run, dev, dense=True)
    same_run(f"{tag} graph vs eager", device, eager)
    del eager
    gc.collect()  # a batcher is a reference cycle: free its cache now
    return seconds


def kernels_under(evt, skip=("linear_wgmma_kernel",)) -> float:
    """Device microseconds of the kernels launched under a profiler event
    (its own and its CPU children's), but those named in ``skip``."""
    own = sum(k.duration for k in evt.kernels
              if not any(s in k.name for s in skip))
    return own + sum(kernels_under(c, skip) for c in evt.cpu_children)


def rec_profile_host(run: ServeRun, dev) -> Dict[str, Any]:
    """Where an eager dense step's device time goes, at 16 live slots:
    REC_PROFILE_STEPS host-batcher steps timed on the host clock, then as
    many under torch.profiler, each recurrent layer's decode inside a
    ``record_function("recurrence")`` range (set here, not in the port):
    device ms a step by class, ``linear``, ``paged_attention``, the gate
    (``fused_eb``), the recurrences (every kernel under a range but
    ``linear``'s) and other; idle = 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.nn import recurrent as R
    from repro_torch.serve.engine import ContinuousBatcher

    steps = REC_PROFILE_STEPS
    cb = ContinuousBatcher(dense_engine(run, dev), eos_token=-1,
                           max_tokens=2 * steps + 8)
    for rid in range(DENSE["max_batch"]):
        cb.submit(rid, run.prompts[rid][:1], features=run.feats[rid])
    cb.run(max_steps=4)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cb.run(max_steps=steps)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / steps * 1e3
    names = ("rglru_decode", "mlstm_decode", "slstm_decode")
    real = {n: getattr(R, n) for n in names}

    def ranged(fn):
        def call(*a, **kw):
            with record_function("recurrence"):
                return fn(*a, **kw)
        return call

    try:
        for n in names:
            setattr(R, n, ranged(real[n]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window(dev)
            cb.run(max_steps=steps)
            torch.cuda.synchronize(dev)
    finally:
        for n in names:
            setattr(R, n, real[n])
    by: Dict[str, float] = collections.Counter()
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or "spin_kernel" in evt.key):
            continue
        by[kernel_class(evt.key)] += evt.self_device_time_total / 1e3 / steps
    rec = sum(kernels_under(e) for e in prof.events()
              if e.name == "recurrence" and e.device_type == DeviceType.CPU)
    rec = rec / 1e3 / steps
    busy = sum(by.values())
    other = by.pop("other", 0.0) + by.pop("matmul", 0.0)
    by["recurrences"] = rec if rec > 0 else None
    by["other"] = other - rec
    return dict(wall=wall, by={k: (round(v, 4) if v is not None else
                                   "not measured") for k, v in by.items()},
                busy=busy, idle=1 - busy / wall if busy else None)


class witness_products:
    """Inside the block every ``linear`` product is the plain product in
    the other operand order, ``(w^T x^T)^T`` through cuBLAS (the float32
    head on float32 copies): the same function as ``linear_ref``, its
    float32 sums taken in another order, so its bf16 outputs round the
    other way where the two sums straddle a rounding boundary."""

    def __enter__(self):
        self.mod = sys.modules["repro_torch.kernels.linear"]
        self.real = self.mod._forward

        def one(x, w, out):
            x2 = x.reshape(-1, x.shape[-1])
            if out == torch.float32:
                y = (w.float().t() @ x2.float().t()).t()
            else:
                y = (w.t() @ x2.t()).t()
            return y.reshape(*x.shape[:-1], w.shape[1])

        self.mod._forward = lambda x, ws, out: [one(x, w, out) for w in ws]

    def __exit__(self, *exc):
        self.mod._forward = self.real


class stateless:
    """The control of (a) and (d): inside the block every recurrent decode
    starts from the initial state at every step (h, C, n, c and the conv
    history zero, the stabilizer m at -1e30): a decode that forgot to
    carry its state, the rest of the step as it is."""

    def __enter__(self):
        from repro_torch.nn import recurrent as R

        self.R = R
        self.real = {n: getattr(R, n) for n in ("rglru_decode",
                                                "mlstm_decode",
                                                "slstm_decode")}

        def forgetful(fn):
            def call(p, x, state, *a):
                fresh = {k: torch.full_like(v, R.M_START) if k == "m"
                         else torch.zeros_like(v) for k, v in state.items()}
                return fn(p, x, fresh, *a)
            return call

        for n, fn in self.real.items():
            setattr(R, n, forgetful(fn))

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.R, n, fn)


# (a)/(d) teacher-forced paths: (products, attention backend, fault); the
# kernel path and the witness are held to the gate, the control must lie
# past it
TF_PATHS = {"kernel": ("kernel", "auto", None), "plain": ("plain", "torch",
                                                          None),
            "plain products": ("plain", "auto", None),
            "plain attention": ("kernel", "torch", None),
            "witness": ("witness", "torch", None),
            "control": ("plain", "torch", stateless)}
# (a)/(d): phase 17's gate for a deep random model (MOE_LOGIT_LIMIT deltas
# a position, MOE_LOGIT_MEAN on average).  Phase 9's one delta is printed,
# not gated: on recurrentgemma-9b (38 random layers, 32 steps of recurrent
# state) the witness, the plain path with its products' float32 sums in
# another order, lies 1.372 deltas from the plain path at worst and 0.975
# on average, 302 of 512 positions past one delta (PERF.md §6, NVIDIA
# H100 80GB HBM3, 700.00 W), so no correct kernel path can hold it


def tf_logits(run: ServeRun, seqs: np.ndarray, dev, products: str,
              attn: str, fault=None) -> torch.Tensor:
    """``seqs [B, L]`` teacher-forced through ``decode_step`` from a fresh
    state: float32 logits ``[B * (L - 1), Vp]`` of every step."""
    from repro_torch.arch import model as M

    ctx = {"kernel": contextlib.nullcontext, "plain": plain_products,
           "witness": witness_products}[products]()
    B, L = seqs.shape
    with ctx, (fault or contextlib.nullcontext)():
        st = M.init_decode_state(run.cfg, B, DENSE["cache_len"], device=dev)
        rows = []
        for t in range(L - 1):
            lg, st = M.decode_step(
                run.params, st, torch.as_tensor(seqs[:, t:t + 1], device=dev),
                run.cfg, attn_impl=attn)
            rows.append(lg)
    return torch.stack(rows, 1).reshape(B * (L - 1), -1)


def rec_teacher_forced(run: ServeRun, done: Dict[Any, list], dev, tag: str,
                       paths=None, n: int = 0) -> tuple:
    """The host batcher's served streams ``done`` (first prompt token +
    generated, the first ``n`` of them, by default 16) teacher-forced
    through ``decode_step`` from a fresh state along ``paths`` (by
    default the ``TF_PATHS``): the kernel path (every product the
    ``linear`` kernel, the attention kernel), the plain path
    (``linear_ref``, the ``"torch"`` backend), each half alone, a witness
    (the plain path with its products' sums in another order) and a
    control (the plain path with every recurrent state dropped at every
    step, ``stateless``).  Each path's
    logits against the plain path's in deltas (LOGIT_TOL * max|plain
    logits| at the position): the kernel path and the witness within
    MOE_LOGIT_LIMIT deltas at every position and MOE_LOGIT_MEAN on
    average, the control past that, or the gate could not see a fault;
    phase 9's one delta and its greedy-flip rule are printed.  Returns
    (line, whether every gate held)."""
    paths = paths or TF_PATHS
    rids = sorted(done)[:n or DENSE["max_batch"]]
    seqs = np.array([run.prompts[r][:1] + done[r] for r in rids], np.int32)
    B, L = seqs.shape
    c = tf_logits(run, seqs, dev, *paths["plain"])
    delta = LOGIT_TOL * c.abs().amax(-1)
    top2 = c.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    dist, held = {}, {}
    for name, path in paths.items():
        if name == "plain":
            continue
        a = tf_logits(run, seqs, dev, *path)
        if not torch.isfinite(a).all():
            fail(f"{tag} teacher-forced {name} logits are not finite")
        r = (a - c).abs().amax(-1) / delta
        flip = a.argmax(-1) != c.argmax(-1)
        loose = int((flip & (margin > 2 * delta)).sum())
        dist[name] = (f"max {r.max().item():.3f} mean {r.mean().item():.3f} "
                      f"delta, {int((r > 1).sum())} of {r.numel()} positions "
                      f"past one delta, {int(flip.sum())} greedy flips "
                      f"({loose} where the plain margin exceeds 2 delta)")
        held[name] = bool(r.max() <= MOE_LOGIT_LIMIT
                          and r.mean() <= MOE_LOGIT_MEAN)
        del a
    ok = held["kernel"] and held["witness"] and not held["control"]
    return (f"teacher-forced, {B} served streams x {L - 1} decode steps from "
            f"a fresh state, against the plain path (delta = {LOGIT_TOL} x "
            f"max|plain logits|): {dist}; the gate ({MOE_LOGIT_LIMIT} deltas "
            f"a position, {MOE_LOGIT_MEAN} on average): kernel "
            f"{'within' if held['kernel'] else 'PAST'}, witness "
            f"{'within' if held['witness'] else 'PAST'}, control "
            f"{'past' if not held['control'] else 'WITHIN'}", ok)


def weight_bytes(params, skip=("embed",)) -> int:
    """Bytes of every parameter a decode step reads (all but ``skip``)."""
    from repro_torch.tree import leaves

    return sum(p.numel() * p.element_size() for leaf in leaves(params)
               if leaf.key not in skip for p in leaf.parts)


def rec_serve(dev, seed: int, arch: str, gate, card: str, tag: str,
              wrap: bool) -> Dict[str, Any]:
    """(a) / (d): ``arch`` at full width (SERVE_DEPTH) through ``generate()``,
    the dense host batcher and the dense device batcher (CUDA graph):
    host == device and graph == eager bitwise, launches exact, a round
    without a synchronising call, the kernel path within phase 9's delta
    of the plain path on teacher-forced steps; tokens/s, ms and device ms a
    step by class, idle share, the step's share of its byte bound.  With
    ``wrap``, (b): the ring past its wrap (phase 14 (c)'s check)."""
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    run = rec_run(dev, seed, arch, gate)
    cfg = run.cfg
    n_params = sum(p.numel() for leaf in leaves(run.params)
                   for p in leaf.parts)
    w_bytes = weight_bytes(run.params)
    print(f"[18 {tag}] {arch} at {width_depth(cfg)} ({cfg.n_layers} "
          f"layers, pattern {cfg.block_pattern} "
          f"{dict(collections.Counter(layer_kinds(cfg)))}, d "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd "
          f"{cfg.head_dim_}, window {cfg.local_window}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_padded}), {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, a "
          f"step reads {w_bytes / 1e9:.3f} GB of weights (all but the "
          f"embedding), RANDOM weights from seed {seed}; {DENSE} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    line = check_linear(cfg, dev, rec_linear_weights(cfg), f"18{tag} linear")
    print(f"[18 {tag} linear] the model's products: {line} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    g = rec_generate(run, dev, f"(18{tag})")
    print(f"[18 {tag}] generate(), 16 prompts of 4 tokens + "
          f"{DENSE_GENERATE} generated, gate fused: wrapper launches "
          f"{g['counts']} == {g['steps']} steps x {step_kernels(cfg)} + the "
          f"gate's tables; {g['tokens'] / g['seconds']:.1f} tokens/s, "
          f"{g['seconds'] / g['steps'] * 1e3:.4f} ms a step ({card})")
    t0 = time.perf_counter()
    dense = drive_dense(run, dev, f"(18{tag})")
    host, device = dense["host"], dense["device"]
    print(f"[18 {tag}] phase 9's {SERVE_REQUESTS} requests (first prompt "
          f"token) x {SERVE_TOKENS} tokens: host batcher == device batcher "
          f"(sync_every {DEVICE_ROUND}, graph) bitwise: "
          f"{len(wave_streams(host))} served, drops "
          f"{first_wave_drops(host)[1]}; {host.steps} steps with work, "
          f"global position {int(host.engine.state['pos'])}; "
          f"{check_dense_launches(dense, run, f'(18{tag})')}")
    eager_s = rec_graph_eager(run, device, dev, f"(18{tag})")
    print(f"[18 {tag}] graph == eager bitwise (eager wave {eager_s:.3f} s); "
          f"{check_dense_no_sync(run, dev, f'(18{tag})')} "
          f"({time.perf_counter() - t0:.1f} s)")
    line, tf_ok = rec_teacher_forced(run, wave_streams(host), dev,
                                     f"(18{tag})")
    print(f"[18 {tag}] {line} ({card})")
    dprof = profile_device(device, run, dev, dense=True, tag=f"(18{tag})",
                           whole=False)
    hprof = rec_profile_host(run, dev)
    bound = w_bytes / PEAK_BYTES * 1e3
    host_tok = sum(len(t) for t in host.done.values())
    print(f"[18 {tag}] profiler over a dense round of {dprof['rsteps']} "
          f"steps and its gate call: {dprof['counts']}, exact on try "
          f"{len(dprof['tries'])} of at most {PROFILE_TRIES} ({card})")
    print(f"[18 {tag} timing] device batcher, warm wave, graph: "
          f"{dprof['tokens']} tokens in {dprof['seconds']:.4f} s, "
          f"{dprof['tokens'] / dprof['seconds']:.1f} tokens/s, "
          f"{dprof['ms_step']:.4f} ms per step run ({dprof['steps']} "
          f"steps); device {dprof['busy_ms_step']:.4f} ms a step "
          f"(profiler, a round, by kernel name: {dprof['by']}), idle "
          f"{dprof['idle']:.3f}; the weights' byte bound {bound:.4f} ms a "
          f"step ({w_bytes / 1e9:.3f} GB / 3.35 TB/s), "
          f"{bound / max(dprof['busy_ms_step'], 1e-9):.3f} of the device "
          f"step; host "
          f"batcher (eager, first wave): {host_tok / dense['host_s']:.1f} "
          f"tokens/s, {dense['host_s'] / host.steps * 1e3:.4f} ms a step; "
          f"eager, {REC_PROFILE_STEPS} steps of 16 live slots: "
          f"{hprof['wall']:.4f} ms a step, device ms a step by class "
          f"{hprof['by']} (busy {hprof['busy']:.4f}), idle "
          f"{hprof['idle']}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({card})")
    if wrap:
        t0 = time.perf_counter()
        print(f"[18 b] {check_wrap(cut_depth(run), dev)} (the first macro, "
              f"full width) ({time.perf_counter() - t0:.1f} s; {card})")
    return dict(cfg=cfg, launches=dense["counts"], dprof=dprof, hprof=hprof,
                bound=bound, tf_ok=tf_ok)


def dense_pa_row(dev, arch: str, launches: int, seed: int) -> Dict[str, Any]:
    """``paged_attention`` at ``arch``'s dense step (18 (c): recurrentgemma-
    9b's hd 256, 16 query heads on 1 KV head; 19 (e): seamless-m4t-large-
    v2's hd 64, 16 on 16): 16 slots x 1,024 ring cells, C = 1,
    ``ring=True``, every row past the wrap; within one bf16 ulp of its
    plain version (``pa_timing``), timed beside gather + SDPA and its
    bound."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    B, S = DENSE["max_batch"], DENSE["cache_len"]
    rng = np.random.default_rng(seed)
    q, k, v, tbl, _, _, _ = pa_case(rng, dev, B, 1, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim_, S, 1,
                                    False, past=False)
    pos = torch.as_tensor(S + rng.integers(0, S, (B, 1)), dtype=torch.int32,
                          device=dev)
    return {"name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
            "replaces": REPLACES["paged_attention"], "launches": launches,
            "bitwise": False, "cell": f"{arch} dense step",
            **pa_timing(q, k, v, tbl, pos, dev, ring=True)}


def attn_linear_units(cfg):
    """The products of an attention layer, its MLP and the head as
    ``linear_timings`` units (name, [(K, N, float32 out)]): the q/k/v
    group, wo, the gate/up group, w_down and the head."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    return [("qkv", [(D, cfg.q_heads * hd, False),
                     (D, cfg.n_kv_heads * hd, False),
                     (D, cfg.n_kv_heads * hd, False)]),
            ("wo", [(cfg.q_heads * hd, D, False)]),
            ("gate_up", [(D, F, False), (D, F, False)]),
            ("w_down", [(F, D, False)]),
            ("head", [(D, cfg.vocab_padded, True)])]


def rec_linear_units(cfg):
    """recurrentgemma-9b's dense-step products as ``linear_timings`` units
    and how many a step launches: the RG-LRU mixer's, then
    ``attn_linear_units``."""
    R = D = cfg.d_model
    kinds = collections.Counter(layer_kinds(cfg))
    units = [("rglru_lin_gate", [(D, R, False), (D, R, False)]),
             ("rglru_rec_in", [(R, R, False), (R, R, False)]),
             ("rglru_out", [(R, D, False)])] + attn_linear_units(cfg)
    count = {"rglru_lin_gate": kinds["rglru"], "rglru_rec_in": kinds["rglru"],
             "rglru_out": kinds["rglru"], "qkv": kinds["attn"],
             "wo": kinds["attn"], "gate_up": cfg.n_layers,
             "w_down": cfg.n_layers, "head": 1}
    return units, count


def rec_linear_weights(cfg):
    """The distinct product shapes of a recurrent config's decode step as
    ``check_linear``'s (name, K, N, float32 out): recurrentgemma-9b's from
    ``rec_linear_units``, xlstm-125m's (the mLSTM's ``w_if``, N = 8 for
    its 2 x 4 gate columns, among them)."""
    from repro_torch.nn.recurrent import GATE_COLS

    if cfg.family == "hybrid":
        units, _ = rec_linear_units(cfg)
        shapes = {}
        for name, members in units:
            for j, m in enumerate(members):
                shapes.setdefault(m, f"{name}{j}" if len(members) > 1
                                  else name)
        return [(name, *m) for m, name in shapes.items()]
    D, H = cfg.d_model, cfg.n_heads
    return [("wq", D, D, False), ("w_if", D, -(-2 * H // GATE_COLS)
                                  * GATE_COLS, False),
            ("w_gates", D, 4 * D, False), ("head", D, cfg.vocab_padded, True)]


def dense_linear_row(dev, arch: str, step_units, launches: int,
                     tag: str) -> Dict[str, Any]:
    """The ``linear`` row of ``arch``'s dense step: each unit of
    ``step_units(cfg)`` (``rec_linear_units``, ``front_linear_units``) at
    M = 16 (one token of each of 16 slots), L2-cold, summed over the
    step's launches, beside cuBLAS (each product one ``x @ w``) and the
    byte bound."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    units, count = step_units(cfg)
    M = DENSE["max_batch"]
    per = linear_timings(cfg, dev, (M,), units=units)
    if sum(count.values()) != step_products(cfg):
        fail(f"{tag} the linear units count {sum(count.values())} launches, "
             f"not {step_products(cfg)}")
    row = {"name": "linear", "route": "cuda", "source": LINEAR_SOURCE,
           "replaces": REPLACES["linear"], "launches": launches,
           "bitwise": False, "cell": f"{arch} dense step",
           "max_abs_err": max(r["max_abs_err"] for r in per),
           "bound_by": "bytes",
           "shape": {"step": f"{sum(count.values())} launches at M = {M}: "
                             f"{count}; L2-cold"},
           "per_product": per}
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms"):
        vals = [r[key] for r in per]
        row[key] = (None if None in vals else
                    sum(r[key] * count[r["weight"]] for r in per))
    return row


def rec_train_config(n_layers: int = 0):
    """xlstm-125m at full width and depth (or cut to ``n_layers``) and the
    launcher's TrainConfig for REC_TRAIN_ARGS."""
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(XLSTM_ARCH)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, TrainConfig(
        microbatches=REC_TRAIN_MICRO, q_block=min(512, REC_TRAIN_SEQ),
        adamw=AdamWConfig(lr=3e-3, warmup_steps=5,
                          total_steps=REC_TRAIN_STEPS))


def rec_train_batches(cfg, dev, seed: int, n: int):
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=REC_TRAIN_SEQ,
        global_batch=REC_TRAIN_BATCH, seed=seed))
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(s).items()} for s in range(n)]


def jax_ckpt_keys(cfg) -> set:
    """The keys the JAX package's ``_flatten`` gives the launcher's
    checkpoint tree ``{"params", "state": {"opt": AdamWState(m, v, count),
    "step"}}`` of a ``block_pattern`` config, from its init functions'
    leaf names: ``macros/m{i}_{kind}/...`` stacked, ``tail/{j}/...``."""
    pat = cfg.block_pattern
    n_tail = cfg.n_layers % len(pat)

    def layer(kind):
        out = ["ln1"] + [f"mixer/{n}" for n in JAX_MIXER_LEAVES[kind]]
        if cfg.d_ff:
            out += ["ln2", "mlp/w_gate", "mlp/w_up", "mlp/w_down"]
        return out

    params = ["embed", "head", "ln_f"]
    params += [f"macros/m{i}_{kind}/{n}" for i, kind in enumerate(pat)
               for n in layer(kind)]
    params += [f"tail/{j}/{n}" for j in range(n_tail) for n in layer(pat[j])]
    keys = {f"params/{k}" for k in params}
    for moment in (".m", ".v"):
        keys |= {f"state/opt/{moment}/{k}" for k in params}
    return keys | {"state/opt/.count", "state/step"}


def drive_rec_train(dev, seed: int, ckpt_dir: Path) -> Dict[str, Any]:
    """(e) ``repro_torch.launch.train.main`` with REC_TRAIN_ARGS and a
    checkpoint directory, the wrapper counts reset just before and read
    just after, at REC_TRAIN_LAYERS: 20 finite losses whose last five's
    mean is below the first five's, ``linear`` launched exactly 20 x 2 x
    (2 x 5 + 1) times (each layer's products in the forward and in its
    recomputation, the head once) and nothing else; the final
    checkpoint's keys those of ``jax_ckpt_keys``, its stacked leaves
    ``[1, ...]`` (one macro)."""
    import io
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg, _ = rec_train_config(REC_TRAIN_LAYERS)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(REC_TRAIN_ARGS + ["--seed", str(seed),
                                              "--ckpt-dir", str(ckpt_dir)])
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    lines = out.getvalue().splitlines()
    step_ms = [float(ln.split()[4]) for ln in lines if ln.startswith("step ")]
    if (len(losses) != REC_TRAIN_STEPS or not np.isfinite(losses).all()
            or len(step_ms) != REC_TRAIN_STEPS):
        fail(f"(18e) the launcher gave {len(losses)} losses {losses}")
    if not (np.mean(losses[-5:]) < np.mean(losses[:5])
            and lines[-1].endswith("(improved)")):
        fail(f"(18e) the loss did not improve: {lines[-1]}")
    fwd = step_products(cfg) - 1
    want = {"linear": REC_TRAIN_STEPS * REC_TRAIN_MICRO * (2 * fwd + 1)}
    if counts != want:
        fail(f"(18e) the launcher launched {counts}, expected {want}")
    manifest = ckpt_dir / f"step_{REC_TRAIN_STEPS:09d}" / "manifest.json"
    stored = json.loads(manifest.read_text())["leaves"]
    keys = jax_ckpt_keys(cfg)
    if set(stored) != keys:
        fail(f"(18e) checkpoint keys differ from the JAX package's: only "
             f"stored {sorted(set(stored) - keys)[:6]}, only JAX "
             f"{sorted(keys - set(stored))[:6]}")
    n_macro = cfg.n_layers // len(cfg.block_pattern)
    wq = stored["params/macros/m0_mlstm/mixer/wq"]["shape"]
    if wq != [n_macro, cfg.d_model, cfg.d_model]:
        fail(f"(18e) a stacked leaf is stored {wq}")
    lo, hi = REC_TIMED
    return dict(cfg=cfg, losses=losses, step_ms=step_ms, counts=counts,
                peak=peak, last=lines[-1], seconds=seconds, n_keys=len(keys),
                ms=statistics.median(step_ms[lo:hi]))


def grad_readings(got: Dict[str, list], want: Dict[str, list]) -> dict:
    """Per gradient leaf: (max |got - want| / max |want|, ||got - want|| /
    ||want||)."""
    out = {}
    for key, parts in want.items():
        a = torch.cat([p.reshape(-1) for p in got[key]])
        c = torch.cat([p.reshape(-1) for p in parts])
        d = a - c
        out[key] = ((d.abs().max() / c.abs().max().clamp_min(1e-30)).item(),
                    (d.norm() / c.norm().clamp_min(1e-30)).item())
    return out


def check_rec_train_parity(dev, seed: int) -> str:
    """(e) xlstm-125m cut to REC_PARITY_LAYERS at full width, the
    launcher's batches: REC_PARITY_STEPS steps, each step's loss and
    gradients taken through the kernel, through ``linear_ref`` and (at
    step 0) through a witness (the plain products' sums in the other
    operand order) from the same masters, then the kernel path's AdamW
    update.  Phase 15's bounds, held by the kernel path and the witness:
    the loss within TRAIN_LOSS_RTOL of the plain path's, every gradient
    leaf within LOGIT_TOL x the plain leaf's largest magnitude (each
    leaf's norm reading printed too).  Two independent trajectories, as
    phase 15 (b) compares, part here: AdamW's first steps move each weight
    by about lr x the sign of its gradient, so at lr 3e-3 the losses of
    the full model drift apart (1.75e-3 at step 1, 1.2e-2 at step 2 on
    the H100) with no fault in either path."""
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state
    from repro_torch.train import optimizer as OPT
    from repro_torch.tree import map_leaves

    cfg, tcfg = rec_train_config(REC_PARITY_LAYERS)
    batches = rec_train_batches(cfg, dev, seed, REC_PARITY_STEPS)
    params, state = init_train_state(cfg, tcfg, seed, dev)
    lines, launched, bad = [], [], []
    for i, b in enumerate(batches):
        ops.reset_launch_counts()
        gk, lk = step_grads(cfg, tcfg, params, b, with_loss=True)
        launched.append(ops.launch_counts()["linear"])
        paths = {"kernel": (gk, lk)}
        with plain_products():
            gp, lp = step_grads(cfg, tcfg, params, b, with_loss=True)
        if i == 0:
            with witness_products():
                paths["witness"] = step_grads(cfg, tcfg, params, b,
                                              with_loss=True)
        if ops.launch_counts()["linear"] != launched[-1] or not launched[-1]:
            fail(f"(18e) linear launched {ops.launch_counts()['linear']} "
                 f"times, the kernel path {launched[-1]}: the plain paths "
                 f"must launch none")
        for name, (g, loss) in paths.items():
            rel = abs(loss - lp) / abs(lp)
            r = grad_readings(g, gp)
            worst = max(r, key=lambda k: r[k][0])
            worst_l2 = max(r, key=lambda k: r[k][1])
            lines.append(
                f"step {i} {name}: loss relative {rel:.3e}; the worst "
                f"gradient leaf {r[worst][0]:.4f} of its largest magnitude "
                f"({worst}), in norm {r[worst_l2][1]:.4f} ({worst_l2})")
            if (not np.isfinite(loss) or rel > TRAIN_LOSS_RTOL
                    or r[worst][0] > LOGIT_TOL):
                bad.append(lines[-1])
        grads = map_leaves(lambda leaf: gk[leaf.key], params)
        with torch.no_grad():
            params, state["opt"] = OPT.update(params, grads, state["opt"],
                                              tcfg.adamw)
        del gk, gp, grads, paths
    del params, state
    torch.cuda.empty_cache()
    line = (f"{REC_PARITY_LAYERS} layers at full width, from the same "
            f"masters at each of {REC_PARITY_STEPS} steps (the kernel "
            f"path's AdamW updates between them; linear launches a step "
            f"{launched}): {'; '.join(lines)}")
    if bad:
        fail(f"(18e) past phase 15's bounds ({TRAIN_LOSS_RTOL} on the loss, "
             f"{LOGIT_TOL} on the gradients): {bad}; {line}")
    return line


def profile_rec_train(dev, seed: int, wall_ms: float) -> Dict[str, Any]:
    """(e) device ms a launcher step (REC_TRAIN_LAYERS) by class over 1
    step after a warm one: ``linear`` forward (the kernel), cuBLAS (the
    backward's products and the mLSTM's and sLSTM's float32 einsums), the
    rest (the recurrences' elementwise kernels, the loss, the optimizer);
    idle = 1 - device / ``wall_ms``; kernels a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import init_train_state, make_train_step

    cfg, tcfg = rec_train_config(REC_TRAIN_LAYERS)
    params, state = init_train_state(cfg, tcfg, seed, dev)
    step = make_train_step(cfg, tcfg)
    batches = rec_train_batches(cfg, dev, seed, 2)
    params, state, loss = step(params, state, batches[0])
    float(loss)
    # the device's kernels only: a step launches about 160,000, and the
    # host ops' records would double what the profiler must sort
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        params, state, loss = step(params, state, batches[1])
        float(loss)
        torch.cuda.synchronize(dev)
    by: Dict[str, float] = collections.Counter()
    kernels = 0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or "spin_kernel" in evt.key):
            continue
        cls = kernel_class(evt.key)
        cls = {"linear": "linear forward", "matmul": "cuBLAS"}.get(cls, "rest")
        by[cls] += evt.self_device_time_total / 1e3
        kernels += evt.count
    del params, state, step
    torch.cuda.empty_cache()
    busy = sum(by.values())
    return {"by": {k: round(v, 4) for k, v in by.items()}, "busy": busy,
            "idle": 1 - busy / wall_ms if busy else None,
            "kernels": kernels}


def phase18(dev, seed: int, card: str, gate) -> list:
    """Phase 18: the recurrent families at full width (SERVE_DEPTH) over the
    dense state ((a)-(d)) and xlstm-125m's training ((e)); returns the new
    JSON rows (``paged_attention`` and ``linear`` at recurrentgemma-9b's
    step)."""
    t_all = time.perf_counter()
    hyb = rec_serve(dev, seed, HYBRID_ARCH, gate, card, "a", wrap=True)
    pa_row = dense_pa_row(dev, HYBRID_ARCH,
                          hyb["launches"]["paged_attention"], SEED + 18)
    print(f"[18 c paged_attention] shape {pa_row['shape']}: within one bf16 "
          f"ulp of its plain version (max |err| {pa_row['max_abs_err']}); "
          f"kernel {pa_row['ms']:.4f} ms (device {pa_row['device_ms']}), "
          f"plain {pa_row['plain_ms']:.4f} ms, gather + SDPA "
          f"{pa_row['library_ms']:.4f} ms (device "
          f"{pa_row['library_device_ms']}), bound {pa_row['bound_ms']:.4f} "
          f"ms ({pa_row['bound_by']}) ({card})")
    lin_row = dense_linear_row(dev, HYBRID_ARCH, rec_linear_units,
                               hyb["launches"]["linear"], "(18c)")
    print(f"[18 c linear step] {lin_row['shape']['step']}: device ms a "
          f"step's products (L2-cold launches summed): kernel "
          f"{lin_row['device_ms']}, cuBLAS {lin_row['library_device_ms']}, "
          f"bound {lin_row['bound_ms']:.4f}; events kernel "
          f"{lin_row['ms']:.4f}, cuBLAS {lin_row['library_ms']} ({card})")
    print(f"[18] (a)-(c) {time.perf_counter() - t_all:.1f} s ({card})")
    tf_ok = {"a": hyb["tf_ok"]}
    del hyb
    gc.collect()
    torch.cuda.empty_cache()
    tf_ok["d"] = rec_serve(dev, seed, XLSTM_ARCH, gate, card, "d",
                           wrap=False)["tf_ok"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[18] (a)-(d) {time.perf_counter() - t_all:.1f} s ({card})")
    t0 = time.perf_counter()
    tr = drive_rec_train(dev, seed, ROOT / "build" / "phase18_ckpt")
    print(f"[18 e train] repro_torch.launch.train {' '.join(REC_TRAIN_ARGS)}"
          f" (examples/train_lm.py's settings) at full width, depth cut to "
          f"{REC_TRAIN_LAYERS} layers, "
          f"float32 masters from seed {seed}: losses "
          f"{[round(x, 4) for x in tr['losses']]}, {tr['last']}; wrapper "
          f"launches {tr['counts']}, no other kernel; the checkpoint's "
          f"{tr['n_keys']} keys == the JAX package's _flatten keys of the "
          f"same tree; {tr['seconds']:.1f} s in all ({card})")
    print(f"[18 e train] {check_rec_train_parity(dev, seed)} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    tprof = profile_rec_train(dev, seed, tr["ms"])
    tokens = REC_TRAIN_BATCH * REC_TRAIN_SEQ
    print(f"[18 e train timing] ms a step (median of steps "
          f"{REC_TIMED[0]}-{REC_TIMED[1] - 1}, host clock): "
          f"{tr['ms']:.4f} ({tokens / tr['ms'] * 1e3:.1f} tokens/s); device "
          f"ms a step by class (profiler, 1 step): {tprof['by']}, busy "
          f"{tprof['busy']:.4f}, idle {tprof['idle']}, "
          f"{tprof['kernels']:.0f} kernels a step; peak memory "
          f"{tr['peak'] / 2**30:.2f} GiB ({card})")
    print(f"[18] phase 18 in {time.perf_counter() - t_all:.1f} s ({card})")
    bad = [k for k, v in tf_ok.items() if not v]
    if bad:
        fail(f"(18{'/'.join(bad)}) teacher-forced: the kernel path or the "
             f"witness past the gate, or the control within it (printed "
             f"above)")
    return [pa_row, lin_row]


# ------------------------------------------------------------ phase 19
VLM_ARCH, ENCDEC_ARCH = "internvl2-2b", "seamless-m4t-large-v2"
FRONT_ARCHS = (VLM_ARCH, ENCDEC_ARCH)
FRONT_INPUT = {"vlm": "patches", "encdec": "frames"}
# (a)/(c): 2 sequences of 64 tokens (the VLM's behind its 256 patches, the
# enc-dec model's over 4,096 frames each)
FRONT_B, FRONT_S = 2, 64
# (d): one train step of 4 sequences of 64 tokens (with their patches or
# frames) in 2 microbatches, lr 1e-3; its parity at 2 layers, full width
FRONT_TRAIN_B, FRONT_TRAIN_MICRO = 4, 2
FRONT_PARITY_LAYERS = 2
# (a)/(c), fixed before any run: the kernel path within one delta
# (LOGIT_TOL x max|reference| a position) of its reference, a control past
# it; unless the witness (the plain path computed otherwise) is itself past
# one delta, and then phase 17's gate (MOE_LOGIT_LIMIT deltas a position,
# MOE_LOGIT_MEAN on average) for the kernel path and the witness, the
# control past it


def front_batch(cfg, dev, seed: int, B: int, S: int) -> Dict[str, Any]:
    """``B`` sequences of ``S`` tokens and their patches or frames ``[B,
    frontend_seq, frontend_dim]`` (N(0, 1), float32) from ``seed``, on the
    card."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S))
    front = rng.normal(0, 1, (B, cfg.frontend_seq, cfg.frontend_dim))
    return {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev),
            FRONT_INPUT[cfg.family]: torch.as_tensor(
                front, dtype=torch.float32, device=dev)}


def deltas(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per position (rows of ``[..., Vp]``): ``max|a - c|`` in deltas of
    LOGIT_TOL x ``max|c|``."""
    a, c = a.reshape(-1, a.shape[-1]), c.reshape(-1, c.shape[-1])
    return (a - c).abs().amax(-1) / (LOGIT_TOL * c.abs().amax(-1))


def front_gate(tag: str, kernel: torch.Tensor, witness: torch.Tensor,
               control: torch.Tensor) -> str:
    """The rule of (a) and (c) on three distance vectors (``deltas``):
    fails unless it holds; returns the readings and the gate applied."""
    def read(r):
        return (f"max {r.max().item():.3f} mean {r.mean().item():.3f} "
                f"delta, {int((r > 1).sum())} of {r.numel()} positions past "
                f"one delta")

    def within(r, limit, mean):
        return bool(r.max() <= limit and r.mean() <= mean)

    line = (f"kernel {read(kernel)}; witness {read(witness)}; control "
            f"{read(control)}")
    if within(witness, 1.0, 1.0):
        gate = (1.0, 1.0)
    else:
        gate = (MOE_LOGIT_LIMIT, MOE_LOGIT_MEAN)
    ok = (within(kernel, *gate) and within(witness, *gate)
          and not within(control, *gate))
    name = ("one delta" if gate == (1.0, 1.0) else
            f"phase 17's gate ({gate[0]} deltas a position, {gate[1]} on "
            f"average; the witness is past one delta)")
    if not ok:
        fail(f"{tag} past {name}, or the control within it: {line}")
    return f"{line}: within {name}, the control past it"


def front_forward(run: ServeRun, dev, seed: int, tag: str) -> Dict[str, Any]:
    """(a) ``forward`` of FRONT_B x FRONT_S tokens with their patches or
    frames at full width (SERVE_DEPTH), under no_grad: the kernel path (every
    product the ``linear`` kernel: exactly the model's launches, no other
    kernel of the repo) against the plain path (``linear_ref``; training's
    attention is plain torch in both), beside a witness (the plain
    products' sums in the other operand order) and a control (the plain
    path with the patches or frames zeroed: a frontend that never reaches
    the model)."""
    from repro_torch.arch import model as M
    from repro_torch.kernels import ops

    cfg = run.cfg
    batch = front_batch(cfg, dev, seed, FRONT_B, FRONT_S)
    key = FRONT_INPUT[cfg.family]
    with torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        kern = M.forward(run.params, batch, cfg)[0]
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        with plain_products():
            plain = M.forward(run.params, batch, cfg)[0]
            control = M.forward(run.params, {**batch, key: torch.zeros_like(
                batch[key])}, cfg)[0]
        with witness_products():
            witness = M.forward(run.params, batch, cfg)[0]
    want = {"linear": forward_products(cfg)}
    if counts != want:
        fail(f"{tag} the forward launched {counts}, expected {want}")
    S = FRONT_S + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    if kern.shape != (FRONT_B, S, cfg.vocab_padded) or not torch.isfinite(
            kern).all():
        fail(f"{tag} forward logits {tuple(kern.shape)}, or not finite")
    line = front_gate(f"{tag} forward", deltas(kern, plain),
                      deltas(witness, plain), deltas(control, plain))
    return dict(line=line, counts=counts, seconds=seconds, logits=kern,
                plain=plain, batch=batch)


def forward_products(cfg) -> int:
    """``linear`` launches of one ``forward``: the frontend product, 4 a
    decoder layer (q/k/v group, wo, gate/up group, w_down) and 4 an
    encoder layer, 3 more a decoder layer with cross-attention (the
    encoder's k/v group, the query, wo), and the head."""
    n = 4 * cfg.n_layers + 1 + bool(cfg.frontend)
    if cfg.family == "encdec":
        n += 4 * cfg.n_encoder_layers + 3 * cfg.n_layers
    return n


def front_linear_weights(cfg):
    """The distinct product shapes of the model's forward and decode step
    as ``check_linear``'s (name, K, N, float32 out): a layer's, the
    frontend's (K = frontend_dim) and the head."""
    return [(n, K, N, f32) for n, K, N, f32 in linear_weights(cfg)
            if n not in ("wv", "w_up")] + [
        ("frontend_proj", cfg.frontend_dim, cfg.d_model, False)]


def check_frontend_rows(run: ServeRun, dev, tag: str) -> str:
    """The frontend product at the forward's M (FRONT_B x frontend_seq
    rows of K = frontend_dim): within ``linear_limit`` of the plain
    version, and each of 16 rows spread over the operand bitwise the same
    row computed in a [16, K] operand."""
    from test_torch_cuda import linear_limit

    from repro_torch.kernels import ops, ref

    cfg = run.cfg
    M, K = FRONT_B * cfg.frontend_seq, cfg.frontend_dim
    x, w = linear_case(dev, M, K, cfg.d_model, SEED + 19)
    got, want = ops.linear(x, w), ref.linear_ref(x, w)
    err = (got.float() - want.float()).abs()
    limit = linear_limit(x, w, want, False)
    if (err > limit).any():
        fail(f"{tag} the frontend product at [{M}, {K}]: "
             f"{int((err > limit).sum())} elements past the limit")
    rows = torch.arange(0, M, M // 16, device=dev)[:16]
    if not torch.equal(ops.linear(x[rows].contiguous(), w), got[rows]):
        fail(f"{tag} frontend rows of a [{M}, {K}] operand differ from the "
             f"same rows in a [16, {K}] one")
    return (f"the frontend product [{M}, {K}] x [{K}, {cfg.d_model}] within "
            f"the plain version's limit (worst "
            f"{(err / limit.clamp_min(1e-30)).max().item():.4f} of it), 16 "
            f"rows bitwise in a [16, {K}] operand")


def front_paged(run: ServeRun, dev, tag: str) -> Dict[str, Any]:
    """(b) the VLM over the paged cache, phase 9's ServeConfig and traffic
    (text prompts of 16-256 tokens): the host batcher (launches exact,
    ``check_serve``), the device batcher at prefill_chunk DEVICE_CHUNK
    (graph) bitwise the host batcher, and paged == dense (phase 14 (b))."""
    cb, seconds, counts = serve_workload(run.cfg, run.params, run.gate,
                                         run.prompts, run.feats, dev)
    paged = ServeRun(run.cfg, run.params, run.gate, run.prompts, run.feats,
                     cb, seconds, counts)
    host_line = check_serve(paged)
    d = drive_device(paged, dev)
    same_run(f"{tag} paged device batcher (chunk {DEVICE_CHUNK}) vs the host "
             f"batcher", d.cb, cb)
    return dict(run=paged, d=d, host_line=host_line,
                device_line=check_device_main(d, paged),
                dense_line=check_paged_vs_dense(cut_depth(run), dev))


def front_decode(run: ServeRun, fwd: Dict[str, Any], dev, tag: str) -> str:
    """(c) the enc-dec model teacher-forced through ``decode_step`` from a
    fresh state over (a)'s tokens, its ``cross`` planes filled by
    ``encode_cross`` over (a)'s frames, against (a)'s forward logits: the
    kernel path (the ``linear`` and ``paged_attention`` kernels) against
    the kernel forward, a witness (the plain path's decode against the
    plain forward) and a control (the zero planes the JAX package's decode
    keeps, ROADMAP C.13), under (a)'s rule."""
    from repro_torch.arch import model as M

    cfg, batch = run.cfg, fwd["batch"]
    toks = batch["tokens"]

    def decode(attn, cross):
        st = M.init_decode_state(cfg, FRONT_B, FRONT_S, device=dev)
        if cross:
            st["cross"] = M.encode_cross(run.params, batch["frames"], cfg)
        rows = []
        with torch.no_grad():
            for t in range(FRONT_S):
                lg, st = M.decode_step(run.params, st, toks[:, t:t + 1], cfg,
                                       attn_impl=attn)
                rows.append(lg)
        return torch.stack(rows, 1)

    kern = decode("auto", True)
    with plain_products():
        witness = decode("torch", True)
    control = decode("auto", False)
    if not torch.isfinite(kern).all():
        fail(f"{tag} decode logits are not finite")
    return (f"{FRONT_B} x {FRONT_S} tokens teacher-forced with cross = "
            f"encode_cross(frames), against the forward: " + front_gate(
                f"{tag} decode", deltas(kern, fwd["logits"]),
                deltas(witness, fwd["plain"]),
                deltas(control, fwd["logits"])))


def front_serve(dev, seed: int, arch: str, gate, card: str,
                tag: str) -> Dict[str, Any]:
    """(a)-(c) for ``arch`` at full width (SERVE_DEPTH): the forward, the
    model's products through phase 8's ``linear`` checks, ``generate()``
    with launches exact, both dense batchers (host == device, graph ==
    eager, launches exact, no sync, the ring's wrap), for the VLM the paged
    batchers, for the enc-dec model the teacher-forced decode; the
    profiler over a dense round (exact) with tokens/s, ms and device ms a
    step by class and idle."""
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    run = rec_run(dev, seed, arch, gate)
    cfg = run.cfg
    n_params = sum(p.numel() for leaf in leaves(run.params)
                   for p in leaf.parts)
    w_bytes = weight_bytes(run.params)
    enc = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
           f"layers with cross-attention" if cfg.family == "encdec" else
           f"{cfg.n_layers} layers")
    print(f"[19 {tag}] {arch} ({cfg.family}) at {width_depth(cfg)} ({enc},"
          f" d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}, "
          f"frontend {cfg.frontend_dim} x {cfg.frontend_seq}), "
          f"{n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, a "
          f"step reads {w_bytes / 1e9:.3f} GB of weights (all but the "
          f"embedding), RANDOM weights from seed {seed} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    line = check_linear(cfg, dev, front_linear_weights(cfg), f"19{tag} linear")
    print(f"[19 {tag} linear] the model's products: {line}; "
          f"{check_frontend_rows(run, dev, f'(19{tag})')} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    fwd = front_forward(run, dev, seed, f"(19{tag} a)")
    print(f"[19 {tag} a] forward of {FRONT_B} x {FRONT_S} tokens with their "
          f"{FRONT_INPUT[cfg.family]}: linear launches {fwd['counts']}, "
          f"{fwd['seconds'] * 1e3:.1f} ms (no_grad); logits against the "
          f"plain path: {fwd['line']} ({time.perf_counter() - t0:.1f} s; "
          f"{card})")
    if cfg.family == "encdec":
        t0 = time.perf_counter()
        print(f"[19 {tag} c] {front_decode(run, fwd, dev, f'(19{tag} c)')} "
              f"({time.perf_counter() - t0:.1f} s; {card})")
    del fwd
    torch.cuda.empty_cache()
    g = rec_generate(run, dev, f"(19{tag} b)")
    print(f"[19 {tag} b] generate(), 16 prompts of 4 tokens + "
          f"{DENSE_GENERATE} generated, gate fused: wrapper launches "
          f"{g['counts']} == {g['steps']} steps x {step_kernels(cfg)} + the "
          f"gate's tables; {g['tokens'] / g['seconds']:.1f} tokens/s, "
          f"{g['seconds'] / g['steps'] * 1e3:.4f} ms a step ({card})")
    t0 = time.perf_counter()
    dense = drive_dense(run, dev, f"(19{tag} b)")
    host, device = dense["host"], dense["device"]
    print(f"[19 {tag} b] {DENSE}, phase 9's {SERVE_REQUESTS} requests (first "
          f"prompt token) x {SERVE_TOKENS} tokens: host batcher == device "
          f"batcher (sync_every {DEVICE_ROUND}, graph) bitwise: "
          f"{len(wave_streams(host))} served, drops "
          f"{first_wave_drops(host)[1]}; {host.steps} steps with work, "
          f"global position {int(host.engine.state['pos'])}; "
          f"{check_dense_launches(dense, run, f'(19{tag} b)')}")
    eager_s = rec_graph_eager(run, device, dev, f"(19{tag} b)")
    print(f"[19 {tag} b] graph == eager bitwise (eager wave {eager_s:.3f} s); "
          f"{check_dense_no_sync(run, dev, f'(19{tag} b)')}; "
          f"{check_wrap(cut_depth(run), dev)} ({SERVE_CUT} layers, full "
          f"width) ({time.perf_counter() - t0:.1f} s; {card})")
    if cfg.family == "encdec":
        for st, who in ((host.engine.state, "host"),
                        (device._decode, "device")):
            if any(t.any() for t in st["cross"]):
                fail(f"(19{tag} b) the {who} batcher wrote its cross planes")
    dprof = profile_device(device, run, dev, dense=True, tag=f"(19{tag} e)",
                           whole=False)
    bound = w_bytes / PEAK_BYTES * 1e3
    host_tok = sum(len(t) for t in host.done.values())
    print(f"[19 {tag} e] profiler over a dense round of {dprof['rsteps']} "
          f"steps and its gate call: {dprof['counts']}, exact on try "
          f"{len(dprof['tries'])} of at most {PROFILE_TRIES} ({card})")
    print(f"[19 {tag} e timing] dense device batcher, warm wave, graph: "
          f"{dprof['tokens']} tokens in {dprof['seconds']:.4f} s, "
          f"{dprof['tokens'] / dprof['seconds']:.1f} tokens/s, "
          f"{dprof['ms_step']:.4f} ms per step run ({dprof['steps']} "
          f"steps); device {dprof['busy_ms_step']:.4f} ms a step "
          f"(profiler, a round, by kernel class: {dprof['by']}), idle "
          f"{dprof['idle']:.3f}; the weights' byte bound {bound:.4f} ms a "
          f"step ({w_bytes / 1e9:.3f} GB / 3.35 TB/s); host batcher (eager, "
          f"first wave): {host_tok / dense['host_s']:.1f} tokens/s, "
          f"{dense['host_s'] / host.steps * 1e3:.4f} ms a step ({card})")
    out = dict(cfg=cfg, launches=dense["counts"], dprof=dprof, bound=bound)
    del dense, host, device
    if cfg.family == "vlm":
        t0 = time.perf_counter()
        p = front_paged(run, dev, f"(19{tag} b)")
        print(f"[19 {tag} b paged] {SERVE}, phase 9's traffic: host batcher "
              f"{p['host_line']}; device batcher {p['device_line']}, "
              f"bitwise the host batcher; {p['dense_line']} "
              f"({time.perf_counter() - t0:.1f} s; {card})")
        pprof = profile_device(p["d"].cb, p["run"], dev, tag=f"(19{tag} e)")
        print(f"[19 {tag} e timing] paged device batcher (chunk "
              f"{DEVICE_CHUNK}), warm wave, graph: "
              f"{pprof['tokens'] / pprof['seconds']:.1f} tokens/s, "
              f"{pprof['ms_step']:.4f} ms per step run; device "
              f"{pprof['busy_ms_step']:.4f} ms a step ({pprof['by']}), idle "
              f"{pprof['idle']:.3f}; launches of a round exact on try "
              f"{len(pprof['tries'])} ({card})")
        del p
    print(f"[19 {tag}] peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({card})")
    return out


def front_train_config(arch: str, n_layers: int = 0):
    """``arch`` at full width, its depth ``served_config``'s (or both
    stacks cut to ``n_layers``), and the step's TrainConfig
    (FRONT_TRAIN_MICRO microbatches, lr 1e-3)."""
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = served_config(arch)
    if n_layers:
        cfg = dataclasses.replace(
            cfg, n_layers=n_layers,
            n_encoder_layers=min(cfg.n_encoder_layers, n_layers))
    return cfg, TrainConfig(microbatches=FRONT_TRAIN_MICRO,
                            adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=10))


def front_train(dev, seed: int, arch: str, tag: str) -> str:
    """(d) ``make_train_step`` at full width (SERVE_DEPTH), two steps of
    FRONT_TRAIN_B x FRONT_S tokens with their patches or frames: finite
    losses, every master finite and moved, ``linear`` launched exactly
    microbatches x 2 x the forward's launches but the frontend's and the
    head's (each layer recomputed in the backward) and nothing else; ms a
    step (the second), peak memory.  Then at FRONT_PARITY_LAYERS (full
    width) the step's loss and gradients through the kernel and through
    ``linear_ref`` from the same masters: phase 15's bounds."""
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg, tcfg = front_train_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, state = init_train_state(cfg, tcfg, seed, dev)
    # layer 0 of each leaf; an enc-dec cross layer's ln2 is zero and no
    # forward reads it, so neither its gradient nor AdamW's decay moves it
    still = {"cross_layers/ln2"} if cfg.family == "encdec" else set()
    keys = [leaf.key for leaf in leaves(params)]
    before = [leaf.parts[0].clone() for leaf in leaves(params)]
    step = make_train_step(cfg, tcfg)
    batches = [front_batch(cfg, dev, seed + i, FRONT_TRAIN_B, FRONT_S)
               for i in range(2)]
    losses, ms = [], []
    for b in batches:
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
    # each layer's products again in its recomputation; the frontend's and
    # the head's once
    want = {"linear": FRONT_TRAIN_MICRO * (2 * forward_products(cfg) - 2)}
    if counts != want:
        fail(f"(19{tag} d) a train step launched {counts}, expected {want}")
    after = [leaf.parts[0] for leaf in leaves(params)]
    if not np.isfinite(losses).all() or not all(
            torch.isfinite(p).all() for p in after):
        fail(f"(19{tag} d) losses {losses}, or a master not finite")
    unmoved = {k for k, a, b in zip(keys, after, before) if torch.equal(a, b)}
    if unmoved != still:
        fail(f"(19{tag} d) leaves unmoved {sorted(unmoved)}, expected "
             f"{sorted(still)}")
    peak = torch.cuda.max_memory_allocated(dev)
    del params, state, step, before, after
    torch.cuda.empty_cache()
    line = (f"{arch} at {width_depth(cfg)}, make_train_step, 2 steps of "
            f"{FRONT_TRAIN_B} x {FRONT_S} tokens with their "
            f"{FRONT_INPUT[cfg.family]} in {FRONT_TRAIN_MICRO} microbatches: "
            f"losses {[round(x, 4) for x in losses]}, every leaf finite and "
            f"moved but {sorted(still) or 'none'}, linear launches {counts} "
            f"a step, no other kernel; "
            f"{ms[1]:.1f} ms the second step (the first {ms[0]:.1f}), peak "
            f"memory {peak / 2**30:.2f} GiB")
    return line + "; " + front_train_parity(dev, seed, arch, tag)


def front_train_parity(dev, seed: int, arch: str, tag: str) -> str:
    """(d) at FRONT_PARITY_LAYERS, full width: one step's loss and every
    gradient leaf through the kernel and through ``linear_ref`` from the
    same masters; phase 15's bounds (TRAIN_LOSS_RTOL, LOGIT_TOL x the
    plain leaf's largest magnitude)."""
    from repro_torch.train import init_train_state

    cfg, tcfg = front_train_config(arch, FRONT_PARITY_LAYERS)
    params, _ = init_train_state(cfg, tcfg, seed, dev)
    b = front_batch(cfg, dev, seed, FRONT_TRAIN_B, FRONT_S)
    gk, lk = step_grads(cfg, tcfg, params, b, with_loss=True)
    with plain_products():
        gp, lp = step_grads(cfg, tcfg, params, b, with_loss=True)
    rel = abs(lk - lp) / abs(lp)
    r = grad_readings(gk, gp)
    worst = max(r, key=lambda k: r[k][0])
    line = (f"at {FRONT_PARITY_LAYERS} layers, full width, kernel vs plain "
            f"from the same masters: loss relative {rel:.3e}, the worst "
            f"gradient leaf {r[worst][0]:.4f} of its largest magnitude "
            f"({worst}), {len(r)} leaves")
    if not np.isfinite(lk) or rel > TRAIN_LOSS_RTOL or r[worst][0] > LOGIT_TOL:
        fail(f"(19{tag} d) past phase 15's bounds ({TRAIN_LOSS_RTOL} on the "
             f"loss, {LOGIT_TOL} on the gradients): {line}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return line


def front_linear_units(cfg):
    """A dense, VLM or enc-dec model's dense step products as
    ``linear_timings`` units (``attn_linear_units``) and how many a step
    launches: the enc-dec cross-attention's query and wo are two more
    ``wo``-shaped products a layer."""
    L = cfg.n_layers
    count = {"qkv": L, "wo": L * (3 if cfg.family == "encdec" else 1),
             "gate_up": L, "w_down": L, "head": 1}
    return attn_linear_units(cfg), count


def phase19(dev, seed: int, card: str, gate) -> list:
    """Phase 19: the VLM and enc-dec families at full width (SERVE_DEPTH)
    ((a)-(c), then (d)'s training); returns the new JSON rows
    (``paged_attention`` at seamless-m4t-large-v2's step, ``linear`` at
    both models' steps)."""
    t_all = time.perf_counter()
    launches = {}
    for arch, tag in ((VLM_ARCH, "vlm"), (ENCDEC_ARCH, "encdec")):
        launches[arch] = front_serve(dev, seed, arch, gate, card,
                                     tag)["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[19] {arch} served in {time.perf_counter() - t_all:.1f} s "
              f"from the phase's start ({card})")
    for arch, tag in ((VLM_ARCH, "vlm"), (ENCDEC_ARCH, "encdec")):
        t0 = time.perf_counter()
        print(f"[19 {tag} d train] {front_train(dev, seed, arch, tag)} "
              f"({time.perf_counter() - t0:.1f} s; {card})")
        gc.collect()
        torch.cuda.empty_cache()
    rows = [dense_pa_row(dev, ENCDEC_ARCH,
                         launches[ENCDEC_ARCH]["paged_attention"], SEED + 19)]
    for arch in FRONT_ARCHS:
        rows.append(dense_linear_row(dev, arch, front_linear_units,
                                     launches[arch]["linear"], "(19e)"))
    for r in rows:
        print(f"[19 e {r['name']}] {r['cell']}, shape {r['shape']}: kernel "
              f"{r['ms']:.4f} ms (device {r.get('device_ms')}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (device "
              f"{r.get('library_device_ms')}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max |err| {r['max_abs_err']} ({card})")
    print(f"[19] phase 19 in {time.perf_counter() - t_all:.1f} s ({card})")
    return rows


# ------------------------------------------------------------ phase 20
# (a): qwen2-moe-a2.7b trained by the launcher at its defaults (phase 15's
# TRAIN_STEPS x TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO microbatches) at
# full width, depth cut to MOE_TRAIN_LAYERS: a layer holds about 605 M
# parameters (64 experts x 3 x 2,048 x 1,408, attention, the shared MLP,
# the router) and each takes about 18 bytes (a float32 master, two
# moments, a float32 gradient and a bf16 copy), so 4 layers and the
# 0.62 B of the embedding and head come to about 55 GB of the card's 80;
# the full 24 layers (15.15 B) wait for ROADMAP queue A item 16
MOE_TRAIN_LAYERS = 4
MOE_PARITY_LAYERS = 2  # (b): kernel vs plain, as phase 15 (b) at TRAIN_CUT
# (c)-(e): the dense configs the card had not run, at full width and
# SERVE_DEPTH, one at a time (each is freed, with its engines and graphs,
# before the next loads); at full depth qwen3-32b's 65.5 GB of bf16
# weights fit beside its caches (PERF.md)
DENSE20 = (("minitron-4b", "c"), ("gemma3-27b", "d"), ("qwen3-32b", "e"))
# teacher-forced streams and their first decode steps: the plain products
# take a call a row, and a 60-layer model's eager steps are host-bound
TF20_STREAMS, TF20_STEPS = 4, 16
# (d): gemma3-27b's window (1,024 on five of every six layers) at full
# width over positions past it: its first WINDOW_LAYERS layers (five local
# and the first global one), a paged cache of WINDOW_SERVE, WINDOW_REQUESTS
# prompts of WINDOW_PROMPTS tokens from the seed, WINDOW_TOKENS generated
WINDOW_ARCH, WINDOW_LAYERS = "gemma3-27b", 6
WINDOW_SERVE = dict(max_batch=4, cache_len=2048, page_size=16)
WINDOW_REQUESTS, WINDOW_TOKENS = 4, 8
WINDOW_PROMPTS = (1100, 1400)


def moe_train_config(n_layers: int):
    """qwen2-moe-a2.7b at full width, depth cut to ``n_layers``, and the
    launcher's TrainConfig at its defaults (``moe_impl="dense"``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)
    return cfg, train_config()[1]


def moe_train_launches(cfg) -> Dict[str, int]:
    """The wrapper launches of the launcher's run, fixed before any run:
    per microbatch each layer's products (``step_products``: the q/k/v
    group, wo, the router, the experts' gate/up group, the shared
    experts' gate/up group and down) and its ``moe_down_combine`` in the
    forward and again when ``"full"`` remat recomputes the layer (the
    backward's products are ``torch.bmm`` / ``torch.matmul``), the head
    once."""
    per = TRAIN_STEPS * TRAIN_MICRO
    return {"linear": per * (2 * (step_products(cfg) - 1) + 1),
            "moe_down_combine": per * 2 * cfg.n_layers}


def drive_moe_train(dev, seed: int) -> Dict[str, Any]:
    """(a) ``repro_torch.launch.train.main`` at its defaults with
    ``--arch qwen2-moe-a2.7b --layers MOE_TRAIN_LAYERS``, the wrapper
    counts reset just before and read just after: TRAIN_STEPS finite
    losses, the last five's mean below the first five's,
    ``moe_train_launches`` exactly and no other kernel of the repo."""
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg, _ = moe_train_config(MOE_TRAIN_LAYERS)
    out = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(["--arch", MOE_ARCH, "--layers",
                             str(MOE_TRAIN_LAYERS), "--seed", str(seed)])
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev)
    lines = out.getvalue().splitlines()
    step_ms = [float(ln.split()[4]) for ln in lines if ln.startswith("step ")]
    if (len(losses) != TRAIN_STEPS or not np.isfinite(losses).all()
            or len(step_ms) != TRAIN_STEPS):
        fail(f"(20a) the launcher gave {len(losses)} losses {losses}")
    if not (np.mean(losses[-5:]) < np.mean(losses[:5])
            and lines[-1].endswith("(improved)")):
        fail(f"(20a) the loss did not improve: {lines[-1]}")
    want = moe_train_launches(cfg)
    if counts != want:
        fail(f"(20a) the launcher launched {counts}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    lo, hi = TRAIN_TIMED
    return dict(cfg=cfg, losses=losses, counts=counts, peak=peak,
                last=lines[-1], seconds=seconds,
                ms=statistics.median(step_ms[lo:hi]))


def check_moe_train_parity(dev, seed: int) -> str:
    """(b) qwen2-moe-a2.7b at full width, MOE_PARITY_LAYERS layers, the
    same masters and the launcher's first batch: one step's loss and
    every gradient leaf through the kernels (``linear``,
    ``moe_down_combine`` and its backward) and through the plain path
    (``linear_ref``, ``ref.moe_down_combine_ref`` and autograd through
    it), phase 15 (b)'s bounds (TRAIN_LOSS_RTOL on the loss, LOGIT_TOL x
    the plain leaf's largest magnitude).  The plain path is held to the
    kernel path's routing (``ForcedRouting``, as phase 17 (d)), so the
    gradients are compared where no token's routing differs; the tokens
    it would have routed otherwise are counted, each a near tie.  Then
    ``moe_down_combine``'s backward alone on every layer's captured ``h,
    W_down, c`` and cotangent (the first microbatch): ``dh``, ``dW_down``
    and the routed pairs' ``dc`` against autograd through
    ``ref.moe_down_combine_ref``, within LOGIT_TOL x the plain gradient's
    largest magnitude."""
    from repro_torch.kernels import ops, ref
    from repro_torch.train import init_train_state

    cfg, tcfg = moe_train_config(MOE_PARITY_LAYERS)
    batch = train_batches(cfg, dev, seed, 1)[0]
    params, _ = init_train_state(cfg, tcfg, seed, dev)
    kernel, calls = ops.moe_down_combine, []

    def capture(h, w, c):
        out = kernel(h, w, c)
        if out.requires_grad:  # the forward's; its recompute fills it in
            i = len(calls)
            calls.append([h.detach(), w.detach(), c.detach(), None])
            out.register_hook(lambda g, i=i: calls[i].__setitem__(
                3, g.detach()))
        return out

    forced = ForcedRouting()
    ops.moe_down_combine = capture
    try:
        with forced.record():
            ops.reset_launch_counts()
            gk, lk = step_grads(cfg, tcfg, params, batch, with_loss=True)
            launched = {k: n for k, n in ops.launch_counts().items() if n}
    finally:
        ops.moe_down_combine = kernel
    want = {"linear": TRAIN_MICRO * (2 * (step_products(cfg) - 1) + 1),
            "moe_down_combine": TRAIN_MICRO * 2 * cfg.n_layers}
    if launched != want:
        fail(f"(20b) the kernel path launched {launched}, expected {want}")
    with plain_products(), plain_moe(), forced.replay():
        gp, lp = step_grads(cfg, tcfg, params, batch, with_loss=True)
    rel = abs(lk - lp) / abs(lp)
    r = grad_readings(gk, gp)
    worst = max(r, key=lambda k: r[k][0])
    flips = (f"{forced.flips} of {forced.rows} token-layer routings would "
             f"have flipped in the plain path, {forced.loose} of them no "
             f"near tie (worst {forced.worst:.3f} of the near-tie bound)")
    line = (f"(b) {MOE_PARITY_LAYERS} layers at full width, one step of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, kernel vs plain from the "
            f"same masters, the plain path on the kernel path's routing "
            f"({flips}): loss {lk:.6f} vs {lp:.6f}, relative {rel:.3e}; "
            f"the worst of {len(r)} gradient leaves {r[worst][0]:.4f} of "
            f"its largest magnitude ({worst})")
    if forced.loose:
        fail(f"(20b) the plain path would have routed a token otherwise "
             f"where its top-k was no near tie: {line}")
    if not np.isfinite(lk) or rel > TRAIN_LOSS_RTOL or r[worst][0] > LOGIT_TOL:
        fail(f"(20b) past phase 15's bounds ({TRAIN_LOSS_RTOL} on the loss, "
             f"{LOGIT_TOL} on the gradients): {line}")
    del params, gk, gp
    torch.cuda.empty_cache()
    got = [c for c in calls if c[3] is not None]
    if len(got) != TRAIN_MICRO * cfg.n_layers:
        fail(f"(20b) captured {len(got)} moe_down_combine cotangents, "
             f"expected {TRAIN_MICRO * cfg.n_layers}")
    got = got[:cfg.n_layers]  # every layer of the first microbatch
    worst_bw = {"dh": 0.0, "dW_down": 0.0, "dc": 0.0}
    for h, w, c, dy in got:
        a = [t.clone().requires_grad_(True) for t in (h, w, c)]
        ops.moe_down_combine(*a).backward(dy)
        b = [t.clone().requires_grad_(True) for t in (h, w, c)]
        ref.moe_down_combine_ref(*b).backward(dy)
        for name, x, y in zip(worst_bw, a, b):
            gx, gy = x.grad.float(), y.grad.float()
            if name == "dc":  # the router reads only the routed pairs'
                gx, gy = gx[c != 0], gy[c != 0]
            e = ((gx - gy).abs().max() / gy.abs().max().clamp_min(1e-30)
                 ).item()
            if not e <= LOGIT_TOL:
                fail(f"(20b) moe_down_combine's {name} on a captured layer "
                     f"lies {e:.4f} of its largest magnitude from autograd "
                     f"through the plain version")
            worst_bw[name] = max(worst_bw[name], e)
        del a, b
    del calls, got
    torch.cuda.empty_cache()
    return (f"{line}; moe_down_combine's backward alone on every layer's "
            f"captured inputs and cotangent (the first microbatch, "
            f"[{TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ}, 64, {cfg.d_ff}]): "
            f"worst "
            f"{ {k: round(v, 5) for k, v in worst_bw.items()} } of the "
            f"plain gradient's largest magnitude (limit {LOGIT_TOL})")


def forgetful_backend() -> str:
    """The control of phase 20's teacher-forced gate (with the kernel
    products): the plain attention over a window of one position, so
    that each step sees its own token's cell alone (a decode that forgot
    its cache); returns its name."""
    from repro_torch.nn import attn_backend as AB

    plain = AB.get("torch")
    AB.register("torch-forgetful", lambda q, kv, *, n_heads, head_dim,
                window: plain(q, kv, n_heads=n_heads, head_dim=head_dim,
                              window=1))
    return "torch-forgetful"


def check_window(run: ServeRun, dev, tag: str) -> str:
    """(d) gemma3-27b's window past position 1,024, at full width and
    WINDOW_LAYERS layers: WINDOW_REQUESTS prompts of WINDOW_PROMPTS tokens
    through the paged device batcher (WINDOW_SERVE) at prefill_chunk
    DEVICE_CHUNK (eager, attention through a capturing backend) and at 1
    (graph): every stream bitwise.  At the first call of each layer with a
    row past position 1,100 the kernel is held within one bf16 ulp of the
    plain version on the captured inputs, and each local
    layer's output against the plain version with no window: it must
    differ, or the window hid no cell that a global layer sees."""
    from repro_torch.arch.model import layer_windows
    from repro_torch.nn import attn_backend as AB
    from repro_torch.serve.engine import (DeviceContinuousBatcher,
                                          ServeConfig, ServeEngine)

    cut = cut_depth(run, WINDOW_LAYERS)
    cfg = cut.cfg
    wins = [int(w) for w in layer_windows(cfg)]
    if not (0 in wins and any(w == 1024 for w in wins)):
        fail(f"({tag}) layer windows {wins}: no local and global layer")
    kernel, plain = AB.get("cuda"), AB.get("torch")
    calls, seen, worst, gap = [0], {}, [0.0], {}

    def capturing(q, kv, *, n_heads, head_dim, window):
        out = kernel(q, kv, n_heads=n_heads, head_dim=head_dim,
                     window=window)
        layer = calls[0] % cfg.n_layers
        calls[0] += 1
        if layer not in seen and int(kv.pos.max()) > WINDOW_PROMPTS[0]:
            want = plain(q, kv, n_heads=n_heads, head_dim=head_dim,
                         window=window)
            worst[0] = max(worst[0], pa_err_ulps(
                f"({tag}) layer {layer} (window {window}) past 1,024", out,
                want))
            seen[layer] = (int(window), int(kv.pos.min()), int(kv.pos.max()))
            if window:
                glob = plain(q, kv, n_heads=n_heads, head_dim=head_dim,
                             window=0)
                gap[layer] = (glob.float() - want.float()).abs().max().item()
        return out

    AB.register("cuda-window-capture", capturing)
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(WINDOW_PROMPTS[0], WINDOW_PROMPTS[1] + 1,
                                     WINDOW_REQUESTS)]
    runs = []
    for chunk, graph, impl in ((DEVICE_CHUNK, False, "cuda-window-capture"),
                               (1, True, "auto")):
        cb = DeviceContinuousBatcher(
            ServeEngine(cfg, cut.params, ServeConfig(**WINDOW_SERVE,
                                                     attn_impl=impl),
                        device=dev),
            eos_token=-1, max_tokens=WINDOW_TOKENS, sync_every=DEVICE_ROUND,
            prefill_chunk=chunk, graph=graph)
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            cb.submit(i, p)
        cb.run(max_steps=20000)
        torch.cuda.synchronize(dev)
        runs.append((dict(cb.done), list(cb.dropped),
                     time.perf_counter() - t0, cb.steps_executed))
        del cb
        torch.cuda.empty_cache()
    (a, da, ta, sa), (b, db, tb, sb) = runs
    if a != b or da != db:
        fail(f"({tag}) window: chunk {DEVICE_CHUNK} and token by token "
             f"differ (drops {da}, {db})")
    if len(a) != WINDOW_REQUESTS or any(len(t) != WINDOW_TOKENS
                                        for t in a.values()):
        fail(f"({tag}) window: {len(a)} streams served, not "
             f"{WINDOW_REQUESTS} of {WINDOW_TOKENS} tokens")
    if sorted(seen) != list(range(cfg.n_layers)):
        fail(f"({tag}) window: captured layers {sorted(seen)} past position "
             f"{WINDOW_PROMPTS[0]}")
    hidden = {k: v for k, v in gap.items() if v > 0}
    if sorted(hidden) != [i for i, w in enumerate(wins) if w]:
        fail(f"({tag}) window: the local layers' outputs {gap} equal the "
             f"same attention with no window")
    return (f"(d) window: {cfg.n_layers} layers at full width (windows "
            f"{wins}), {WINDOW_SERVE}, {WINDOW_REQUESTS} prompts of "
            f"{[len(p) for p in prompts]} tokens x {WINDOW_TOKENS}: chunk "
            f"{DEVICE_CHUNK} ({sa} steps, {ta:.1f} s eager) == token by "
            f"token ({sb} steps, {tb:.1f} s graph) bitwise; each layer's "
            f"attention at its first call past position {WINDOW_PROMPTS[0]} "
            f"(window, first and last position: {seen}) within one bf16 ulp "
            f"of the plain version (worst {worst[0]:.2f} ulp); every local "
            f"layer's output moves by "
            f"{ {k: round(v, 4) for k, v in gap.items()} } against the same "
            f"inputs with no window: its window hides cells a global layer "
            f"sees")


def paged_wave(run: ServeRun, dev, tag: str) -> str:
    """(c)-(e) the paged device batcher at C = DEVICE_CHUNK over phase 9's
    ServeConfig and traffic at (c)-(e)'s depth: ``check_device_main`` (terminal
    states, the gate's verdicts, the pool, the path's kernels); the
    wrapper counts of the first wave, which tick at the eager warm-up and
    at the capture of each shape key (the graph replays exactly what it
    captured), exactly 2 x ``step_kernels`` a key; then a warm wave timed
    on the host clock."""
    d = drive_device(run, dev)
    line = check_device_main(d, run)
    n_keys = len(d.cb._steps)
    want = {k: 2 * n_keys * n for k, n in step_kernels(run.cfg).items()}
    got = {k: d.launches[k] for k in want}
    if got != want:
        fail(f"({tag} paged) the captured step launched {got} for {n_keys} "
             f"shape keys, expected 2 x {step_kernels(run.cfg)} a key")
    s0 = d.cb.steps_executed
    wall = device_wave(d.cb, run, dev, tag="timed")
    steps = d.cb.steps_executed - s0
    n_tok = sum(len(t) for r, t in d.cb.done.items()
                if isinstance(r, tuple) and r[0] == "timed")
    del d
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{line}; the step's launches {got} == 2 x "
            f"{step_kernels(run.cfg)} for each of its {n_keys} shape keys "
            f"(eager warm-up and capture); warm wave, graph: {n_tok} tokens "
            f"in {wall:.4f} s, {n_tok / wall:.1f} tokens/s, "
            f"{wall / steps * 1e3:.4f} ms per step run ({steps} steps)")


def dense_serve20(dev, seed: int, arch: str, gate, card: str,
                  tag: str) -> Dict[str, Any]:
    """(c)-(e) ``arch`` at full width (SERVE_DEPTH), random weights from
    ``seed``: the model's product shapes through phase 8's ``linear``
    checks; the dense host batcher == the dense device batcher (graph)
    bitwise on phase 9's traffic (first prompt token), the host batcher's
    launches exact; TF20_STREAMS served streams teacher-forced over their
    first TF20_STEPS decode steps, kernel vs
    plain beside a witness and a control (``forgetful_backend``), phase
    17's gate; the profiler over a dense round (exact; its device ms a
    step by class) with tokens/s, ms a step and idle from a timed wave;
    the paged device batcher (``paged_wave``).  The repeated checks at
    SERVE_CUT layers: graph == eager, a round of the eager and the
    replayed dense step without a synchronising call, paged == dense.
    For gemma3-27b ``check_window``.
    Every batcher is freed (with its graphs and cache) before the next is
    made (at full depth gemma3-27b's 57 GB and qwen3-32b's 65.5 GB left
    room for two dense caches)."""
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    run = rec_run(dev, seed, arch, gate)
    cfg = run.cfg
    n_params = sum(p.numel() for leaf in leaves(run.params)
                   for p in leaf.parts)
    w_bytes = weight_bytes(run.params)
    T = f"20 {tag}"
    print(f"[{T}] {arch} at {width_depth(cfg)} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd "
          f"{cfg.head_dim_}, qk_norm {cfg.qk_norm}, window "
          f"{cfg.local_window or 'none'}, d_ff {cfg.d_ff} {cfg.act}, vocab "
          f"{cfg.vocab_padded}), {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, a "
          f"step reads {w_bytes / 1e9:.3f} GB of weights (all but the "
          f"embedding), RANDOM weights from seed {seed}; {DENSE} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    line = check_linear(cfg, dev, linear_weights(cfg), f"20{tag} linear")
    print(f"[{T} linear] the model's products: {line} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    dense = drive_dense(run, dev, f"(20{tag})")
    host, device = dense["host"], dense["device"]
    print(f"[{T}] phase 9's {SERVE_REQUESTS} requests (first prompt token) "
          f"x {SERVE_TOKENS} tokens: host batcher == device batcher "
          f"(sync_every {DEVICE_ROUND}, graph) bitwise: "
          f"{len(wave_streams(host))} served, drops "
          f"{first_wave_drops(host)[1]}; {host.steps} steps with work, "
          f"global position {int(host.engine.state['pos'])}; "
          f"{check_dense_launches(dense, run, f'(20{tag})')} "
          f"({time.perf_counter() - t0:.1f} s)")
    streams = wave_streams(host)
    host_tok = sum(len(t) for t in host.done.values())
    host_ms = dense["host_s"] / host.steps * 1e3
    host_tps = host_tok / dense["host_s"]
    counts = dense["counts"]
    del dense, host
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths = {"kernel": TF_PATHS["kernel"], "plain": TF_PATHS["plain"],
             "witness": TF_PATHS["witness"],
             "control": ("kernel", forgetful_backend(), None)}
    heads = {r: t[:TF20_STEPS] for r, t in streams.items()}
    line, tf_ok = rec_teacher_forced(run, heads, dev, f"(20{tag})", paths,
                                     TF20_STREAMS)
    print(f"[{T}] {line} ({time.perf_counter() - t0:.1f} s; {card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dprof = profile_device(device, run, dev, dense=True, tag=f"(20{tag})",
                           whole=False)
    bound = w_bytes / PEAK_BYTES * 1e3
    print(f"[{T}] profiler over a dense round of {dprof['rsteps']} steps and "
          f"its gate call: {dprof['counts']}, exact on try "
          f"{len(dprof['tries'])} of at most {PROFILE_TRIES} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    print(f"[{T} timing] dense device batcher, warm wave, graph: "
          f"{dprof['tokens']} tokens in {dprof['seconds']:.4f} s, "
          f"{dprof['tokens'] / dprof['seconds']:.1f} tokens/s, "
          f"{dprof['ms_step']:.4f} ms per step run ({dprof['steps']} steps); "
          f"device {dprof['busy_ms_step']:.4f} ms a step (profiler, a "
          f"round, by kernel class: {dprof['by']}), idle "
          f"{dprof['idle']:.3f}; the weights' byte bound {bound:.4f} ms a "
          f"step ({w_bytes / 1e9:.3f} "
          f"GB / 3.35 TB/s), "
          f"{bound / max(dprof['busy_ms_step'], 1e-9):.3f} of the device "
          f"step; host batcher (eager, first wave): {host_tps:.1f} "
          f"tokens/s, {host_ms:.4f} ms a step ({card})")
    del device
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"[{T} paged] {SERVE}, phase 9's traffic (prompts "
          f"{PROMPT_LENS[0]}-{PROMPT_LENS[1]} tokens), {cfg.n_layers} "
          f"layers: device "
          f"batcher {paged_wave(run, dev, f'20{tag}')} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    t0 = time.perf_counter()
    cut = cut_depth(run)
    dense = drive_dense(cut, dev, f"(20{tag} cut)")
    del dense["host"]
    gc.collect()
    eager_s = rec_graph_eager(cut, dense["device"], dev, f"(20{tag} cut)")
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{T}] at {SERVE_CUT} layers, full width: the dense device "
          f"batcher's graph == eager bitwise (eager wave {eager_s:.3f} s); "
          f"{check_dense_no_sync(cut, dev, f'(20{tag} cut)')}; "
          f"{check_paged_vs_dense(cut, dev)} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    gc.collect()
    torch.cuda.empty_cache()
    if arch == WINDOW_ARCH:
        t0 = time.perf_counter()
        print(f"[{T}] {check_window(run, dev, f'20{tag}')} "
              f"({time.perf_counter() - t0:.1f} s; {card})")
    print(f"[{T}] peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({card})")
    return dict(launches=counts, tf_ok=tf_ok)


def window_pa_row(dev, launches: int, seed: int) -> Dict[str, Any]:
    """``paged_attention`` at gemma3-27b's local layers past their window:
    hd 128, 32 query heads on 16 KV heads, 16 slots of a 2,048-position
    paged cache (pages of 16), one row a slot at positions drawn in
    WINDOW_PROMPTS, window 1,024 (a row sees its last 1,024 positions of
    up to 1,400); within one bf16 ulp of its plain version
    (``pa_timing``), timed beside gather + SDPA (masked to the window) and
    its bound."""
    from repro_torch.configs import get_config

    cfg = get_config(WINDOW_ARCH)
    B, page = DENSE["max_batch"], WINDOW_SERVE["page_size"]
    n_ps = WINDOW_SERVE["cache_len"] // page
    rng = np.random.default_rng(seed)
    q, k, v, tbl, _, _, _ = pa_case(rng, dev, B, 1, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim_, page, n_ps,
                                    False, past=False)
    pos = torch.as_tensor(rng.integers(WINDOW_PROMPTS[0], WINDOW_PROMPTS[1]
                                       + 1, (B, 1)), dtype=torch.int32,
                          device=dev)
    return {"name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
            "replaces": REPLACES["paged_attention"], "launches": launches,
            "bitwise": False, "cell": f"{WINDOW_ARCH} local layer past its "
            f"window", **pa_timing(q, k, v, tbl, pos, dev,
                                   window=cfg.local_window)}


def phase20(dev, seed: int, card: str, gate) -> tuple:
    """Phase 20: qwen2-moe-a2.7b trained on the card ((a) the launcher at
    its defaults, MOE_TRAIN_LAYERS layers; (b) kernel vs plain at
    MOE_PARITY_LAYERS), then minitron-4b, gemma3-27b and qwen3-32b served
    at full width, SERVE_DEPTH ((c)-(e), ``dense_serve20``); returns (the
    new JSON rows: ``linear`` at each config's dense step,
    ``paged_attention`` at 3:1, 8:1 and 2:1 with the window; the
    training run's ``moe_down_combine`` launches)."""
    t_all = time.perf_counter()
    tr = drive_moe_train(dev, seed)
    cfg = tr["cfg"]
    print(f"[20 a train] repro_torch.launch.train --arch {MOE_ARCH} --layers "
          f"{MOE_TRAIN_LAYERS} at its defaults: full width ({cfg.d_model}, "
          f"{cfg.n_experts} experts padded to {cfg.n_experts_padded}, "
          f"top-{cfg.n_experts_active}, expert d_ff {cfg.d_ff}, shared "
          f"{cfg.shared_d_ff}, vocab {cfg.vocab_padded}), depth cut to "
          f"{cfg.n_layers} of 24 layers, float32 masters from seed {seed}, "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{TRAIN_MICRO} microbatches: losses "
          f"{[round(x, 4) for x in tr['losses']]}, {tr['last']}; wrapper "
          f"launches {tr['counts']} (moe_down_combine forward and recomputed "
          f"a layer a microbatch, its backward torch.bmm), no other kernel; "
          f"{tr['seconds']:.1f} s in all ({card})")
    t0 = time.perf_counter()
    tprof = profile_train(dev, seed, tr["ms"],
                          moe_train_config(MOE_TRAIN_LAYERS))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[20 a train timing] ({time.perf_counter() - t0:.1f} s) ms a step "
          f"(median of steps {TRAIN_TIMED[0]}-{TRAIN_TIMED[1] - 1}, host "
          f"clock): {tr['ms']:.4f} ({tokens / tr['ms'] * 1e3:.1f} "
          f"tokens/s); device ms a step by class (profiler, 2 steps): "
          f"{tprof['by']}, busy {tprof['busy']:.4f}, idle {tprof['idle']}, "
          f"{tprof['kernels']:.0f} kernels a step; aten ops' device ms "
          f"{tprof['mm_ops']}; peak memory {tr['peak'] / 2**30:.2f} GiB "
          f"(max_memory_allocated) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"[20 b train] {check_moe_train_parity(dev, seed)} "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[20] (a)-(b) {time.perf_counter() - t_all:.1f} s ({card})")
    launches, tf_ok = {}, {}
    for arch, tag in DENSE20:
        r = dense_serve20(dev, seed, arch, gate, card, tag)
        launches[arch], tf_ok[tag] = r["launches"], r["tf_ok"]
        del r
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[20] {arch} served in {time.perf_counter() - t_all:.1f} s "
              f"from the phase's start ({card})")
    rows = [dense_linear_row(dev, arch, front_linear_units,
                             launches[arch]["linear"], f"(20{tag})")
            for arch, tag in DENSE20]
    for arch in ("qwen3-32b", "minitron-4b"):
        rows.append(dense_pa_row(dev, arch,
                                 launches[arch]["paged_attention"],
                                 SEED + 20))
    rows.append(window_pa_row(dev, launches[WINDOW_ARCH]["paged_attention"],
                              SEED + 20))
    for r in rows:
        print(f"[20 {r['name']}] {r['cell']}, shape {r['shape']}: kernel "
              f"{r['ms']:.4f} ms (device {r.get('device_ms')}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (device "
              f"{r.get('library_device_ms')}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max |err| {r['max_abs_err']} ({card})")
    print(f"[20] phase 20 in {time.perf_counter() - t_all:.1f} s ({card})")
    bad = [k for k, v in tf_ok.items() if not v]
    if bad:
        fail(f"(20{'/'.join(bad)}) teacher-forced: the kernel path or the "
             f"witness past the gate, or the control within it (printed "
             f"above)")
    return rows, tr["counts"]["moe_down_combine"]


# ------------------------------------------------------------ phase 21
DOTS_TIMED = (2, 6)  # (a): steps whose median wall time is a step's
# (a)/(c): kernel vs plain and the pipeline at full width, depth cut, as
# phase 15 (b) cuts qwen2
PHASE21_CUT = 4
# (b): xlstm-125m at full width, one macro (mLSTM + sLSTM) of its 12
# layers: its checkpoint with the moments is about 1 GB (qwen2-1.5b's about
# 6 GB at one layer); train_lm's batch of 8 in 2 microbatches, lr 3e-3, at
# DRILL_SEQ tokens: the sLSTM's steps run one a token on the host, and at
# train_lm's 128 the drill took 51 s of the run
DRILL_LAYERS, DRILL_SEQ = 2, 32
DRILL_STEPS, DRILL_CKPT_EVERY = 12, 3
DRILL_PLAN = "slow:1:9.0:5@1, corrupt:manifest@6, lost:2@7"
DRILL_FLEET = dict(n_workers=4, model_parallel=2, chips_per_host=2)
PREEMPT_STEPS = 6  # (b): the launcher's --elastic run under "preempt@4"
# (c): the GPipe step against loss_fn's microbatches, fixed before any run:
# the same launches on the same rows give each microbatch's loss bitwise,
# summed in the same order (the loss within PIPE_LOSS_RTOL), and the
# microbatches' float32 gradient contributions meet at the masters in
# another order (each leaf within PIPE_GRAD_TOL of its largest magnitude)
PIPE_STAGES, PIPE_MICRO = 2, 4
PIPE_LOSS_RTOL = 1e-6
PIPE_GRAD_TOL = 1e-5


def dots_step_launches(cfg, policy: str) -> int:
    """``linear`` launches of one launcher step, fixed from the code: per
    microbatch each layer's four products and the head in the forward;
    ``"full"`` launches the layers' products again when it recomputes
    them, ``"dots"`` saves their outputs (``arch.model._dots_policy``)."""
    fwd = 4 * cfg.n_layers + 1
    return TRAIN_MICRO * (fwd + (4 * cfg.n_layers if policy == "full"
                                 else 0))


def timed_steps(cfg, tcfg, dev, seed: int, n: int) -> Dict[str, Any]:
    """``n`` launcher steps from ``seed``'s masters (phase 15 (a)'s run
    without the launcher), the counts reset just before the first step
    and read just after the last: wall ms a step (host clock, each step
    ending in its loss's read), the losses, the counts, and the peak
    memory over what was allocated before the masters were made."""
    from repro_torch.kernels import ops
    from repro_torch.train import init_train_state, make_train_step

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params, state = init_train_state(cfg, tcfg, seed, dev)
    batches = train_batches(cfg, dev, seed, n)
    step = make_train_step(cfg, tcfg)
    ops.reset_launch_counts()
    ms, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    del params, state, step
    torch.cuda.empty_cache()
    lo, hi = DOTS_TIMED
    return dict(step_ms=ms, ms=statistics.median(ms[lo:hi]), counts=counts,
                peak=peak, before=before, losses=losses)


def check_dots(dev, seed: int, full=None) -> Dict[str, Any]:
    """(a) ``remat_policy="dots"`` at qwen2-1.5b's published width and depth,
    the launcher's defaults: one step's loss and every gradient bitwise
    ``"full"``'s on the kernel path; DOTS_TIMED[1] steps of each policy,
    the losses bitwise and the ``linear`` launches a step exactly
    ``dots_step_launches``; at PHASE21_CUT layers one step's loss and
    gradients under ``"dots"`` through the kernel and the plain products
    within phase 15's TRAIN_LOSS_RTOL and LOGIT_TOL.  ``full`` is phase 15
    (a)'s launcher run (the same steps from the same masters, its launches
    counted exactly there), read in place of a ``"full"`` run of its own
    (the full run's room)."""
    from repro_torch.train import init_train_state

    cfg, tcfg_full = train_config()
    batch = train_batches(cfg, dev, seed, 1)[0]
    params = init_train_state(cfg, tcfg_full, seed, dev)[0]
    got = {}
    for policy in ("full", "dots"):
        tcfg = dataclasses.replace(tcfg_full, remat_policy=policy)
        got[policy] = step_grads(cfg, tcfg, params, batch, with_loss=True)
    (gf, lf), (gd, ld) = got["full"], got["dots"]
    if ld != lf:
        fail(f"(21a) the dots loss {ld!r} is not the full loss {lf!r}")
    for key in gf:
        if not all(torch.equal(a, b) for a, b in zip(gf[key], gd[key])):
            fail(f"(21a) the dots gradient of {key} is not the full one's")
    n_leaves = len(gf)
    del params, got, gf, gd
    torch.cuda.empty_cache()
    runs = {}
    if full is not None:
        lo, hi = DOTS_TIMED
        n = len(full["losses"])
        runs["full"] = dict(
            full, ms=statistics.median(full["step_ms"][lo:hi]),
            counts={k: v * DOTS_TIMED[1] // n
                    for k, v in full["counts"].items()},
            losses=full["losses"][:DOTS_TIMED[1]])
    for policy in ("full", "dots"):
        if policy in runs:
            continue
        tcfg = dataclasses.replace(tcfg_full, remat_policy=policy)
        runs[policy] = timed_steps(cfg, tcfg, dev, seed, DOTS_TIMED[1])
    for policy in ("full", "dots"):
        want = {"linear": DOTS_TIMED[1] * dots_step_launches(cfg, policy)}
        if runs[policy]["counts"] != want:
            fail(f"(21a) {policy}: launched {runs[policy]['counts']}, "
                 f"expected {want}")
    if runs["full"]["losses"] != runs["dots"]["losses"]:
        fail(f"(21a) the trajectories differ: full {runs['full']['losses']}"
             f" dots {runs['dots']['losses']}")
    # kernel vs plain at PHASE21_CUT layers under "dots"
    cut, tcut = train_config(PHASE21_CUT)
    tcut = dataclasses.replace(tcut, remat_policy="dots")
    masters = init_train_state(cut, tcut, seed, dev)[0]
    kernel = step_grads(cut, tcut, masters, batch, with_loss=True)
    with plain_products():
        plain = step_grads(cut, tcut, masters, batch, with_loss=True)
    rel = abs(kernel[1] - plain[1]) / abs(plain[1])
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"(21a) {PHASE21_CUT} layers: loss kernel {kernel[1]} vs plain "
             f"{plain[1]}: {rel} past {TRAIN_LOSS_RTOL}")
    worst = 0.0
    for key, parts in plain[0].items():
        ref_max = max(p.abs().max().item() for p in parts)
        err = max((a - b).abs().max().item()
                  for a, b in zip(kernel[0][key], parts))
        if not err <= LOGIT_TOL * ref_max:
            fail(f"(21a) {PHASE21_CUT} layers: gradient {key} {err} past "
                 f"{LOGIT_TOL} x {ref_max}")
        worst = max(worst, err / ref_max if ref_max else 0.0)
    del masters, kernel, plain
    torch.cuda.empty_cache()
    return dict(cfg=cfg, runs=runs, n_leaves=n_leaves, loss=lf, rel=rel,
                worst=worst)


def drill_config():
    """xlstm-125m at full width, depth DRILL_LAYERS, train_lm's settings
    (phase 18 (e)'s TrainConfig over DRILL_STEPS)."""
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg, _ = rec_train_config(DRILL_LAYERS)
    return cfg, TrainConfig(
        microbatches=REC_TRAIN_MICRO, q_block=min(512, DRILL_SEQ),
        adamw=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=DRILL_STEPS))


def check_drill(dev, seed: int) -> Dict[str, Any]:
    """(b) ``tests/test_elastic.py``'s drill on the card at xlstm-125m's
    width: DRILL_PLAN over DRILL_FLEET (logical chips on the card), the
    counts reset just before the run and read just after: segments init,
    straggler, host-loss; DRILL_STEPS steps completed, 2 workers left, the
    fallback past the corrupted manifest counted; ``linear`` launched
    exactly the executed steps x 2 x (2 x 5 + 1) and nothing else; every
    recovered segment's losses bitwise its ``replay``'s."""
    import shutil

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.dist.elastic import TrainFaultPlan
    from repro_torch.kernels import ops
    from repro_torch.obs import Metrics
    from repro_torch.train.elastic import ElasticTrainer

    cfg, tcfg = drill_config()
    ckpt = ROOT / "build" / "phase21_drill"
    shutil.rmtree(ckpt, ignore_errors=True)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=DRILL_SEQ,
        global_batch=REC_TRAIN_BATCH, seed=seed))
    metrics, log = Metrics(), []
    trainer = ElasticTrainer(
        cfg, tcfg, pipe, CheckpointManager(str(ckpt), keep=0),
        steps=DRILL_STEPS, plan=TrainFaultPlan.parse(DRILL_PLAN),
        min_strikes=3, ckpt_every=DRILL_CKPT_EVERY, seed=seed,
        metrics=metrics, log=log.append, device=dev, **DRILL_FLEET)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.run()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    causes = [s.cause for s in res.segments]
    counters = metrics.snapshot()["counters"]
    if (causes != ["init", "straggler", "host-loss"] or not res.completed
            or res.steps_completed != DRILL_STEPS
            or len(res.workers_final) != 2
            or counters.get("train.ckpt_fallback") != 1
            or counters.get("train.straggler_evicted") != 1):
        fail(f"(21b) the drill gave segments {causes}, "
             f"{res.steps_completed} steps, workers {res.workers_final}, "
             f"counters {counters}; log {log}")
    fwd = step_products(cfg) - 1
    want = {"linear": res.executed_steps * REC_TRAIN_MICRO * (2 * fwd + 1)}
    if counts != want:
        fail(f"(21b) the drill launched {counts}, expected {want}")
    if not np.isfinite(res.losses).all():
        fail(f"(21b) losses {res.losses}")
    replays = []
    for seg in res.segments[1:]:
        t1 = time.perf_counter()
        ref = trainer.replay(seg.ckpt_step, seg.device_ids, seg.mesh_shape,
                             seg.n_steps)
        if ref != seg.losses:
            fail(f"(21b) the {seg.cause} segment's losses {seg.losses} are "
                 f"not its replay's {ref}")
        replays.append(time.perf_counter() - t1)
    step_dir = ckpt / f"step_{DRILL_CKPT_EVERY:09d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(cfg=cfg, res=res, counts=counts, counters=counters,
                seconds=seconds, replays=replays, ckpt_bytes=ckpt_bytes)


def check_preempt_launcher(dev, seed: int) -> Dict[str, Any]:
    """(b) ``repro_torch.launch.train --elastic`` on (b)'s model under
    ``preempt@4``: a real SIGTERM through the handler at the boundary after
    step 4, the drained checkpoint, a warm restart on the same mesh, and
    every step completed."""
    import io
    import shutil

    from repro_torch.launch import train

    snap = ROOT / "build" / "phase21_snap"
    shutil.rmtree(snap, ignore_errors=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main([
            "--arch", XLSTM_ARCH, "--layers", str(DRILL_LAYERS), "--batch",
            str(REC_TRAIN_BATCH), "--seq", str(DRILL_SEQ),
            "--microbatches", str(REC_TRAIN_MICRO), "--lr", "3e-3",
            "--steps", str(PREEMPT_STEPS), "--seed", str(seed),
            "--elastic", "--workers", "4", "--model-parallel", "2",
            "--chips-per-host", "2", "--ckpt-every", str(PREEMPT_STEPS + 1),
            "--fault-plan", "preempt@4", "--snapshot-dir", str(snap)])
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    want = ["segment 0 (init): steps 0..5 on mesh 4x2",
            f"segment 1 (preempt): steps 5..{PREEMPT_STEPS} on mesh 4x2",
            f"elastic run: {PREEMPT_STEPS}/{PREEMPT_STEPS} steps, "
            f"{PREEMPT_STEPS} executed, workers 4 -> 4"]
    if (not all(w in lines for w in want) or len(losses) != PREEMPT_STEPS
            or not np.isfinite(losses).all()):
        fail(f"(21b) launch.train --elastic under preempt@4 printed {lines}")
    shutil.rmtree(snap, ignore_errors=True)
    return dict(seconds=seconds, lines=[ln for ln in lines
                                        if ln.startswith(("segment",
                                                          "elastic"))])


def check_pipeline(dev, seed: int) -> Dict[str, Any]:
    """(c) the GPipe step at qwen2-1.5b's width, PHASE21_CUT layers,
    PIPE_STAGES stages and PIPE_MICRO microbatches on the launcher's first
    batch, the counts reset just before and read just after: ``linear``
    launched exactly PIPE_MICRO x (4 x layers + 1) times; the loss within
    PIPE_LOSS_RTOL of the mean of ``loss_fn`` over the same microbatches
    and every gradient within PIPE_GRAD_TOL of its largest magnitude; ms a
    step of both."""
    from repro_torch.dist import pipeline as PP
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import init_train_state
    from repro_torch.tree import leaves

    cfg, tcfg = train_config(PHASE21_CUT)
    masters = init_train_state(cfg, tcfg, seed, dev)[0]
    batch = train_batches(cfg, dev, seed, 1)[0]
    mesh = make_production_mesh(multi_pod=True, chips=512, device=dev)
    step, _ = PP.make_pipeline_step(
        cfg, mesh, SH.param_pspecs(masters, mesh), n_stages=PIPE_STAGES,
        n_micro=PIPE_MICRO, q_block=tcfg.q_block)
    staged = PP.split_layers_for_stages(masters, PIPE_STAGES)
    ops.reset_launch_counts()
    loss, grads = step(staged, batch)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"linear": PIPE_MICRO * (4 * cfg.n_layers + 1)}
    if counts != want:
        fail(f"(21c) the pipeline step launched {counts}, expected {want}")
    ref_tcfg = dataclasses.replace(tcfg, microbatches=PIPE_MICRO)
    ref, ref_loss = step_grads(cfg, ref_tcfg, masters, batch, with_loss=True)
    rel = abs(float(loss) - ref_loss) / abs(ref_loss)
    if not rel <= PIPE_LOSS_RTOL:
        fail(f"(21c) pipeline loss {float(loss)} vs loss_fn {ref_loss}: "
             f"{rel} past {PIPE_LOSS_RTOL}")
    got: Dict[str, list] = collections.defaultdict(list)
    for leaf in leaves(grads):  # stage after stage, under the layers' keys
        key = leaf.key
        if key.startswith("stages/"):
            key = "layers/" + key.split("/", 2)[2]
        got[key].extend(leaf.parts)
    worst = 0.0
    for key, parts in ref.items():
        ref_max = max(p.abs().max().item() for p in parts)
        err = max((a - b).abs().max().item()
                  for a, b in zip(got[key], parts))
        if len(got[key]) != len(parts) or not err <= PIPE_GRAD_TOL * ref_max:
            fail(f"(21c) pipeline gradient {key}: {err} past "
                 f"{PIPE_GRAD_TOL} x {ref_max}")
        worst = max(worst, err / ref_max if ref_max else 0.0)
    ms = {}
    for name, fn in (("pipeline", lambda: step(staged, batch)),
                     ("loss_fn", lambda: step_grads(cfg, ref_tcfg, masters,
                                                     batch))):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize(dev)
        ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    del masters, staged, grads, ref
    torch.cuda.empty_cache()
    return dict(cfg=cfg, loss=float(loss), ref_loss=ref_loss, rel=rel,
                worst=worst, counts=counts, ms=ms)


def phase21(dev, seed: int, card: str, full=None) -> None:
    """Phase 21: ``remat_policy="dots"`` (a), the elastic drill and the
    launcher's ``--elastic`` (b), the GPipe step (c); every check a hard
    failure.  ``full``: phase 15 (a)'s run, for (a)'s ``"full"`` side."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    a = check_dots(dev, seed, full)
    cfg, runs = a["cfg"], a["runs"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[21 a dots] qwen2-1.5b at full width and depth ({cfg.n_layers} "
          f"layers), the launcher's defaults ({TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, {TRAIN_MICRO} microbatches): one step's loss "
          f"{a['loss']!r} and all {a['n_leaves']} gradient leaves under "
          f"\"dots\" bitwise \"full\"'s; {DOTS_TIMED[1]} steps each, the "
          f"trajectories bitwise; linear launches a step: full "
          f"{runs['full']['counts']['linear'] // DOTS_TIMED[1]}, dots "
          f"{runs['dots']['counts']['linear'] // DOTS_TIMED[1]} (exact); "
          f"at {PHASE21_CUT} layers dots kernel vs plain: loss relative "
          f"{a['rel']:.3e} (limit {TRAIN_LOSS_RTOL}), worst gradient "
          f"{a['worst']:.4f} of max|g_plain| (limit {LOGIT_TOL}) "
          f"({time.perf_counter() - t0:.1f} s; {card})")
    src = ("phase 15 (a)'s launcher run" if full is not None
           else "its own run")
    mem = {k: (r["peak"] - r["before"]) / 2**30 for k, r in runs.items()}
    print(f"[21 a dots timing] ms a step (median of steps {DOTS_TIMED[0]}-"
          f"{DOTS_TIMED[1] - 1}, host clock): full {runs['full']['ms']:.4f} "
          f"({tokens / runs['full']['ms'] * 1e3:.1f} tokens/s; {src}), dots "
          f"{runs['dots']['ms']:.4f} ({tokens / runs['dots']['ms'] * 1e3:.1f}"
          f" tokens/s); peak memory over the run's start (masters, moments, "
          f"copies, activations): full {mem['full']:.2f} GiB, dots "
          f"{mem['dots']:.2f} GiB (max_memory_allocated) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b = check_drill(dev, seed)
    res, dcfg = b["res"], b["cfg"]
    segs = "; ".join(
        f"{s.cause} from {s.ckpt_step} at step {s.start}, mesh "
        f"{s.mesh_shape[0]}x{s.mesh_shape[1]} chips {s.device_ids}, "
        f"{s.n_steps} steps in {s.seconds:.2f} s" for s in res.segments)
    print(f"[21 b elastic] xlstm-125m at full width (d {dcfg.d_model}, vocab "
          f"{dcfg.vocab_padded}), {dcfg.n_layers} of 12 layers, "
          f"{REC_TRAIN_BATCH} x {DRILL_SEQ} tokens in {REC_TRAIN_MICRO} "
          f"microbatches, plan {DRILL_PLAN!r}, {DRILL_FLEET}: {segs}; "
          f"{res.steps_completed}/{DRILL_STEPS} steps ({res.executed_steps} "
          f"executed), workers 4 -> {res.workers_final}, counters "
          f"{b['counters']}; wrapper launches {b['counts']} (exact); both "
          f"recovered segments bitwise their replays ("
          f"{', '.join(f'{x:.2f}' for x in b['replays'])} s); a checkpoint "
          f"{b['ckpt_bytes']} bytes; the run "
          f"{b['seconds']:.2f} s ({time.perf_counter() - t0:.1f} s; {card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre = check_preempt_launcher(dev, seed)
    print(f"[21 b elastic] launch.train --elastic --fault-plan preempt@4 "
          f"(4 workers of 2 chips, model parallel 2): {pre['lines']} "
          f"({pre['seconds']:.1f} s; {card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = check_pipeline(dev, seed)
    print(f"[21 c pipeline] GPipe step, qwen2-1.5b at full width, "
          f"{c['cfg'].n_layers} layers in {PIPE_STAGES} stages, "
          f"{PIPE_MICRO} microbatches of the launcher's first batch: loss "
          f"{c['loss']!r} vs loss_fn {c['ref_loss']!r} (relative "
          f"{c['rel']:.3e}, limit {PIPE_LOSS_RTOL}), worst gradient "
          f"{c['worst']:.3e} of max|g| (limit {PIPE_GRAD_TOL}); wrapper "
          f"launches {c['counts']} (exact); ms a step (host clock, mean of "
          f"3): pipeline {c['ms']['pipeline']:.4f}, loss_fn's microbatches "
          f"{c['ms']['loss_fn']:.4f} ({time.perf_counter() - t0:.1f} s; "
          f"{card})")
    print(f"[21] phase 21 in {time.perf_counter() - t_all:.1f} s ({card})")


def starts(t_run: float, phase: str) -> None:
    """Print how far into the run ``phase`` starts (the run's budget)."""
    print(f"[{phase}] starts {time.perf_counter() - t_run:.1f} s into the "
          f"run")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the serve phases' weights and traffic")
    ap.add_argument("--phase17", action="store_true",
                    help="build the kernels and run phase 17 alone (a "
                         "quick MoE run); prints no result line")
    ap.add_argument("--phase18", action="store_true",
                    help="build the kernels and run phase 18 alone (the "
                         "recurrent families); prints no result line")
    ap.add_argument("--phase19", action="store_true",
                    help="build the kernels and run phase 19 alone (the "
                         "VLM and enc-dec families); prints no result line")
    ap.add_argument("--phase20", action="store_true",
                    help="build the kernels and run phase 20 alone (MoE "
                         "training, qwen3-32b, gemma3-27b and minitron-4b); "
                         "prints no result line")
    ap.add_argument("--phase21", action="store_true",
                    help="build the kernels and run phase 21 alone (the "
                         "dots remat policy, the elastic drill and the "
                         "GPipe step); prints no result line")
    ap.add_argument("--phase22", action="store_true",
                    help="build the kernels and run phase 22 alone "
                         "(serving over a mesh of logical chips, the "
                         "dry-run planner); prints no result line")
    args = ap.parse_args()
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # the card tests' input makers
    try:
        from repro_torch import card_info, resolve_device
        from repro_torch.kernels import _build
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script ({exc})")
    dev = resolve_device("cuda")
    # the plain versions' float32 products run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = ", ".join(card_info())
    global PEAK_INT32_OPS, PEAK_FP32_FLOPS
    PEAK_INT32_OPS = peak_int32_ops(dev)
    PEAK_FP32_FLOPS = 2 * PEAK_INT32_OPS * FP32_LANES_PER_SM / \
        INT32_LANES_PER_SM
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}; "
          f"int32 peak {PEAK_INT32_OPS:.4e} ops/s ({INT32_LANES_PER_SM} "
          f"lanes x {torch.cuda.get_device_properties(dev).multi_processor_count}"
          f" SMs x clocks.max.sm)")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[1 build] {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        print(f"  {name}.cu ptxas:\n" + "\n".join(
            "    " + ln for ln in log.splitlines() if ln.strip()))

    if args.phase17:
        moe_row, _ = phase17(dev, args.seed, card)
        print(json.dumps({"kernels": [moe_row]}))
        print(card)
        return
    if args.phase18:
        print(json.dumps({"kernels": phase18(dev, args.seed, card,
                                             serve_gate(dev))}))
        print(card)
        return
    if args.phase19:
        print(json.dumps({"kernels": phase19(dev, args.seed, card,
                                             serve_gate(dev))}))
        print(card)
        return
    if args.phase20:
        print(json.dumps({"kernels": phase20(dev, args.seed, card,
                                             serve_gate(dev))[0]}))
        print(card)
        return
    if args.phase21:
        phase21(dev, args.seed, card)
        print(card)
        return
    if args.phase22:
        phase22(serve_run(dev, args.seed), dev, card)
        print(card)
        return
    starts(t_run, "2")
    n = check_kernels(dev)
    print(f"[2 kernels] {n} cases bitwise equal to their plain versions")

    starts(t_run, "3")
    staged = drive("L", dev, BATCH)
    fused = drive("M", dev, BATCH)
    for phase, run, size, backend, kernels in (
            ("3 main path", staged, "L", "cuda", ("bucketize", "ternary_match")),
            ("4 fused path", fused, "M", "cuda_fused", ("fused_eb",))):
        if run.backend != backend:
            fail(f"rf-{size} auto picked {run.backend}, expected {backend}")
        for k in kernels:
            if run.launches[k] <= 0:
                fail(f"rf-{size} path did not launch {k}: {run.launches}")
        print(f"[{phase}] rf-EB {size}: {run.res.mapped.resources().entries} "
              f"entries, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, labels == plain == numpy == native")

    rows = kernel_rows(staged, fused, dev)
    for path, run in (("staged", staged), ("fused", fused)):
        predict_ms = time_ms(lambda: run.fn(run.x), reps=10)
        kernel_ms = time_ms(kernels_only(run, dev), reps=10)
        print(f"[5 throughput] {path} ({run.backend}): "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s; one predict of "
              f"{BATCH} flows {predict_ms:.4f} ms on the card, of which its "
              f"kernel launches {kernel_ms:.4f} ms; plain on the card: "
              f"{flows_per_s(run.plain, run.x[:CHUNK]):.0f} flows/s ({card})")

    starts(t_run, "6")
    lb_runs = drive_lb(dev, BATCH)
    from repro_torch.kernels.lb_lookup import plan as lb_plan
    for model, run in lb_runs.items():
        lb = run.res.mapped.predict_np.__self__
        F, V, K = lb.luts.shape
        print(f"[6 LB path] {model}-LB L: LUT {list(lb.luts.shape)} mode "
              f"{lb.mode}, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, == plain == numpy; "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s, one predict "
              f"{time_ms(lambda: run.fn(run.x), reps=10):.4f} ms (device "
              f"{device_ms(lambda: run.fn(run.x))}), of which its kernel "
              f"launch {time_ms(lb_dm_kernels_only(run, dev)):.4f} ms; "
              f"{check_lb_one_kernel(model, run)}; launch plan "
              f"{lb_plan(BATCH, F, V, K, lb.mode)} ({card})")
    dm_runs = drive_dm(dev, BATCH)
    for model, run in dm_runs.items():
        print(f"[7 DM path] {model}-DM L: {run.res.mapped.resources().entries} "
              f"entries, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, labels == numpy == native"
              f"{' == plain' if model == 'bnn' else ''}, train "
              f"{run.res.train_seconds:.2f} s; "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s, one predict "
              f"{time_ms(lambda: run.fn(run.x), reps=10):.4f} ms"
              + (f", of which its kernel launches "
                 f"{time_ms(lb_dm_kernels_only(run, dev)):.4f} ms"
                 if model == "bnn" else " (no kernel)") + f" ({card})")
    rows += lb_dm_kernel_rows(lb_runs, dm_runs, dev)
    for r in rows[-3:-1]:
        print(f"[6 lb_lookup {r['shape']['mode']}] kmeans-LB L shape "
              f"{r['shape']}: {r['ms']:.4f} ms (device {r['device_ms']}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['n_bytes']} bytes, {r['n_ops']} ops), plain "
              f"{r['plain_ms']:.4f} ms, library (embedding_bag) "
              f"{r['library_ms']} ms (device {r['library_device_ms']}) "
              f"({card})")
    for f in rows[-1]["fused"]:
        print(f"[7 bnn fused layer {f['layer']}] {f['shape']['mode']}: "
              f"{f['ms']:.4f} ms (device {f['device_ms']}), bound "
              f"{f['bound_ms']:.4f} ms ({f['bound_by']}), plain "
              f"{f['plain_ms']:.4f} ms; counts mode {rows[-1]['ms']:.4f} ms "
              f"(device {rows[-1]['device_ms']}), bf16 matmul "
              f"{rows[-1]['library_ms']:.4f} ms (device "
              f"{rows[-1]['library_device_ms']}) ({card})")

    starts(t_run, "8")
    print(f"[8 paged_attention] {check_paged_attention(dev)}")
    pa_row = paged_attention_row(dev)
    for t in (pa_row, pa_row["skip"], pa_row["c8"], pa_row["ring"]):
        print(f"[8 paged_attention timing] shape {t['shape']}: "
              f"kernel {t['ms']:.4f} ms (device {t['device_ms']}), plain "
              f"{t['plain_ms']:.4f} ms, gather + SDPA {t['library_ms']:.4f} "
              f"ms (device {t['library_device_ms']}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}) ({card})")
    from repro_torch.configs import get_config

    qwen = get_config("qwen2-1.5b")
    print(f"[8 linear] {check_linear(qwen, dev)}")
    print(f"[8 linear] {check_linear_groups(qwen, dev)}")
    linear_per = linear_timings(qwen, dev)
    for t in linear_per:
        print(f"[8 linear timing] {t['weight']} [{t['M']}, {t['K']}] x "
              f"[{t['K']}, {t['N']}], L2-cold over {t['copies']} copies: "
              f"kernel {t['ms']:.4f} ms (device {t['device_ms']}), cuBLAS "
              f"{t['library_ms']} ms (device {t['library_device_ms']}), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) ({card})")
    lin_row = linear_step_row(qwen, linear_per, 0)
    for tag, r in (("C = 8", lin_row), ("C = 1", lin_row["c1"])):
        print(f"[8 linear step] {tag}, device ms a step's products "
              f"(phase 8's L2-cold launches summed): kernel "
              f"{r['device_ms']}, cuBLAS {r['library_device_ms']}, bound "
              f"{r['bound_ms']:.4f} ({card})")
    starts(t_run, "9")
    serve = drive_serve(dev, args.seed)
    cfg = serve.cfg
    print(f"[9 serve] qwen2-1.5b at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"KV, hd {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}), RANDOM weights from seed {args.seed} "
          f"(nothing downloaded), {SERVE}, rf-S gate on unsw, "
          f"{SERVE_REQUESTS} requests (prompts {PROMPT_LENS[0]}-"
          f"{PROMPT_LENS[1]} tokens, seed {args.seed}) x {SERVE_TOKENS} "
          f"tokens: {check_serve(serve)} ({card})")
    print(f"[9 serve profile] {profile_serve(serve, dev)} ({card})")
    print(f"[10 serve parity] {check_captured_attention(cut_depth(serve), dev)}"
          f" ({SERVE_CUT} layers, full width)")
    print(f"[10 serve parity] {check_teacher_forced(serve, dev)}")
    print(f"[10 serve parity] {check_shared_and_int8(cut_depth(serve), dev)}"
          f" ({SERVE_CUT} layers, full width)")
    starts(t_run, "11")
    d = drive_device(serve, dev)
    d_steps = d.cb.steps  # the first wave's
    print(f"[11 device batcher] {check_device_main(d, serve)} ({card})")
    tbt = device_batcher(serve, dev, chunk=1)
    device_wave(tbt, serve, dev)
    same_run("(b) prefill_chunk 1 vs the host batcher", tbt, serve.cb)
    print(f"[11 device batcher] (b) prefill_chunk 1 == phase 9's host "
          f"batcher bitwise: {len(serve.cb.done)} streams, drops "
          f"{serve.cb.drop_reasons}; {tbt.steps} steps with work (host: "
          f"{serve.cb.steps}), {tbt.steps_executed} run")
    eager = device_batcher(serve, dev, graph=False)
    eager_s = device_wave(eager, serve, dev)
    one = device_batcher(serve, dev, sync_every=1)
    device_wave(one, serve, dev)
    same_run("(c) graph vs eager", d.cb, eager)
    same_run("(c) sync_every 1 vs 16", d.cb, one)
    print(f"[11 device batcher] (c) graph == eager == sync_every 1, "
          f"bitwise ({len(d.cb.done)} streams; sync_every 1: "
          f"{one.steps_executed} steps run, {one.steps_wasted} wasted)")
    print(f"[11 device batcher] {check_chunked(d.cb, tbt, serve, dev)}")
    print(f"[11 device batcher] {check_no_sync(serve, dev)}")
    prof = profile_device(d.cb, serve, dev)
    n_tok = sum(len(t) for t in serve.cb.done.values())
    print(f"[11 device batcher] (f) profiler over a round of "
          f"{prof['rsteps']} steps and its gate call: {prof['counts']}, "
          f"exact on try {len(prof['tries'])} of at most {PROFILE_TRIES} "
          f"(each try's counts: {prof['tries']}), "
          f"no other kernel of the repo (over a whole run of "
          f"{prof['psteps']} "
          f"steps, {prof['events']} device events: {prof['wcounts']}, not "
          f"gated) ({card})")
    print(f"[11 device batcher timing] warm wave, graph: {prof['tokens']} "
          f"tokens in {prof['seconds']:.4f} s, "
          f"{prof['tokens'] / prof['seconds']:.1f} tokens/s, "
          f"{prof['ms_step']:.4f} ms per step run ({prof['steps']} steps); "
          f"device {prof['busy_ms_step']:.4f} ms a step (profiler: "
          f"{prof['by']}), idle "
          f"{prof['idle']:.3f} of the step; eager (first wave, no graph): "
          f"{sum(len(t) for t in eager.done.values()) / eager_s:.1f} "
          f"tokens/s, "
          f"{eager_s / eager.steps_executed * 1e3:.4f} ms per step run; "
          f"phase 9's host batcher: {n_tok / serve.seconds:.1f} tokens/s, "
          f"{serve.seconds / serve.cb.steps * 1e3:.4f} ms per step ({card})")
    starts(t_run, "12")
    spec = drive_spec(serve, d, dev)
    st = spec["stats"]
    print(f"[12 spec] spec_k {SPEC_K}, bigram draft from a pilot wave "
          f"({spec['draft'].meta['coverage']:.3f} of the vocabulary seen): "
          f"every greedy stream and drop bitwise phase 11's; drafted "
          f"{st['drafted']}, accepted {st['accepted']}, acceptance "
          f"{st['acceptance_rate']:.4f}; {spec['first_steps']} steps with "
          f"work (phase 11's first wave: {d_steps})")
    if st["accepted"] <= 0:
        fail("(12) no draft was accepted")
    no_sync = check_no_sync(serve, dev, "(12)", spec_k=SPEC_K,
                            draft=spec["draft"])
    print(f"[12 spec] {no_sync}")
    print(f"[12 spec timing] warm wave, graph: {spec['tokens']} tokens in "
          f"{spec['seconds']:.4f} s, {spec['tokens'] / spec['seconds']:.1f} "
          f"tokens/s, {spec['seconds'] / spec['steps'] * 1e3:.4f} ms per "
          f"step run ({spec['steps']} steps); phase 11's warm wave "
          f"{prof['tokens'] / prof['seconds']:.1f} tokens/s ({card})")
    print(f"[13 obs] {check_traced(serve, d, dev)} ({card})")
    print(f"[13 faults] {check_faults(serve, d, dev)}")
    starts(t_run, "14")
    dense = drive_dense(serve, dev)
    host = dense["host"]
    print(f"[14 dense] (a) {DENSE}, phase 9's {SERVE_REQUESTS} requests "
          f"(first prompt token) x {SERVE_TOKENS} tokens: host batcher == "
          f"device batcher (sync_every {DEVICE_ROUND}, graph) bitwise: "
          f"{len(wave_streams(host))} served, drops "
          f"{first_wave_drops(host)[1]}; {host.steps} steps with work, "
          f"global position {int(host.engine.state['pos'])} ({card})")
    print(f"[14 dense] {check_dense_launches(dense, serve)}")
    print(f"[14 dense] {check_paged_vs_dense(cut_depth(serve), dev)} "
          f"({SERVE_CUT} layers, full width)")
    print(f"[14 dense] {check_wrap(cut_depth(serve), dev)} ({SERVE_CUT} "
          f"layers, full width; {card})")
    print(f"[14 dense] {check_dense_no_sync(serve, dev)}")
    dprof = profile_device(dense["device"], serve, dev, dense=True,
                           tag="(14e)", whole=False)
    print(f"[14 dense] (e) profiler over a dense round of "
          f"{dprof['rsteps']} steps and its gate call: {dprof['counts']}, "
          f"exact on try {len(dprof['tries'])} of at most {PROFILE_TRIES} "
          f"(each try's counts: {dprof['tries']}) ({card})")
    hprof = profile_serve(serve, dev, scfg=DENSE)
    dev_tok = sum(len(t) for t in wave_streams(dense["device"]).values())
    host_tok = sum(len(t) for t in host.done.values())
    print(f"[14 dense timing] device batcher, warm wave, graph: "
          f"{dprof['tokens']} tokens in {dprof['seconds']:.4f} s, "
          f"{dprof['tokens'] / dprof['seconds']:.1f} tokens/s, "
          f"{dprof['ms_step']:.4f} ms per step run ({dprof['steps']} steps); "
          f"device {dprof['busy_ms_step']:.4f} ms a step (profiler, a "
          f"round: {dprof['by']}), idle {dprof['idle']:.3f}; first wave with the "
          f"capture {dev_tok / dense['device_s']:.1f} tokens/s; host "
          f"batcher: {host_tok / dense['host_s']:.1f} tokens/s, "
          f"{dense['host_s'] / host.steps * 1e3:.4f} ms per step "
          f"({host.steps} steps), {hprof}; phase 11's paged device batcher "
          f"{prof['tokens'] / prof['seconds']:.1f} tokens/s, "
          f"{prof['ms_step']:.4f} ms per step run, device "
          f"{prof['busy_ms_step']:.4f} ms a step ({prof['by']}) ({card})")
    del dense, host
    torch.cuda.empty_cache()
    starts(t_run, "15")
    tr = drive_train(dev, args.seed)
    tr_full = {k: tr[k] for k in ("step_ms", "losses", "counts", "peak",
                                  "before")}  # phase 21 (a)'s "full" side
    tcfg = tr["cfg"]
    print(f"[15 train] (a) repro_torch.launch.train at its defaults: "
          f"qwen2-1.5b at full width and depth ({tcfg.n_layers} layers, d "
          f"{tcfg.d_model}, vocab {tcfg.vocab_padded}), float32 masters "
          f"from seed {args.seed}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches: losses "
          f"{[round(x, 4) for x in tr['losses']]}, {tr['last']}; wrapper "
          f"launches {tr['counts']} == {TRAIN_STEPS} x {TRAIN_MICRO} x "
          f"(2 x 4 x {tcfg.n_layers} + 1), no other kernel; "
          f"{tr['seconds']:.1f} s in all ({card})")
    for check in (lambda: check_train_parity(dev, args.seed),
                  lambda: check_linear_backward(qwen, dev),
                  lambda: check_resume(dev, args.seed)):
        t0 = time.perf_counter()
        line = check()
        print(f"[15 train] {line} ({time.perf_counter() - t0:.1f} s; "
              f"{card})")
    t0 = time.perf_counter()
    tprof = profile_train(dev, args.seed, tr["ms"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(tcfg)
    lin_row["train"] = train_linear_row(
        qwen, dev, tr["counts"]["linear"],
        tprof["by"].get("backward matmuls"))
    lt = lin_row["train"]
    print(f"[15 train timing] ({time.perf_counter() - t0:.1f} s) "
          f"ms a step (median of steps {TRAIN_TIMED[0]}-"
          f"{TRAIN_TIMED[1] - 1}, host clock): {tr['ms']:.4f} "
          f"({tokens / tr['ms'] * 1e3:.1f} tokens/s); device ms a step by "
          f"class (profiler, 2 steps): {tprof['by']}, busy "
          f"{tprof['busy']:.4f}, idle {tprof['idle']}, "
          f"{tprof['kernels']:.0f} kernels a step; aten ops' device ms "
          f"{tprof['mm_ops']}; peak memory "
          f"{tr['peak'] / 2**30:.2f} GiB (max_memory_allocated); model FLOPs "
          f"a step {flops:.4e}, {flops / (tr['ms'] / 1e3) / PEAK_BF16_FLOPS:.4f}"
          f" of the bf16 peak; linear forward at M = {lt['M']} (one "
          f"forward's {4 * qwen.n_layers + 1} launches, L2-cold): kernel "
          f"{lt['ms']} ms (device {lt['device_ms']}), cuBLAS "
          f"{lt['library_ms']} (device {lt['library_device_ms']}), bound "
          f"{lt['bound_ms']:.4f} (bytes) ({card})")
    starts(t_run, "16")
    two = phase16(serve, d, prof, dev, card)
    starts(t_run, "22")
    phase22(serve, dev, card, two)
    pa_row["launches"] = serve.launches["paged_attention"]
    rows.append(pa_row)
    lin_row["launches"] = serve.launches["linear"]
    rows.append(lin_row)
    # phase 17 runs alone on the card: every earlier model is freed
    gate = serve.gate
    del serve, d, tbt, eager, one, spec, tr
    gc.collect()
    torch.cuda.empty_cache()
    starts(t_run, "17")
    moe_row, lin_row["moe_products"] = phase17(dev, args.seed, card)
    rows.append(moe_row)
    gc.collect()
    torch.cuda.empty_cache()
    starts(t_run, "18")
    rows += phase18(dev, args.seed, card, gate)
    gc.collect()
    torch.cuda.empty_cache()
    starts(t_run, "19")
    rows += phase19(dev, args.seed, card, gate)
    gc.collect()
    torch.cuda.empty_cache()
    starts(t_run, "20")
    rows20, moe_row["train_launches"] = phase20(dev, args.seed, card, gate)
    rows += rows20
    gc.collect()
    torch.cuda.empty_cache()
    starts(t_run, "21")
    phase21(dev, args.seed, card, tr_full)
    starts(t_run, "the result")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
