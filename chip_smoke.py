#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (also printed as a line of their own);
2. build   -- every CUDA kernel built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together),
   timed as set-up; the Hopper flash kernel's registers, spills and any
   ptxas warning about it (``-Xptxas -v``): two instances a head dim (32,
   64, 80, 128), without and with the lse output, none spilling; every
   attention backward instance (``bwd_dq_wgmma``, ``bwd_dkdv_wgmma`` a
   head dim, ``bwd_dkdv_sum``, the float32 ``bwd_dq`` and ``bwd_dkdv``),
   none spilling; the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
   instructions in ``cuobjdump -sass`` of ``libflash_attention.so`` and
   ``libflash_attention_bwd.so``; the atomic instructions in the SASS of
   ``libhist.so`` by kind (native ``ATOMS.ADD`` / ``REDG`` or a
   compare-and-swap loop, ``ATOMS.CAS*``, of which there must be none)
   (the SASS counts are null where ``cuobjdump`` is missing);
3. check   -- each kernel held against its plain PyTorch version on the
   card over a sweep of shapes: both traversal forms and split gain with
   ``torch.equal`` (bit-identical; NaN rows, passthrough padding trees,
   out-of-range feature ids, empty bins, NaN gains; the forest sum at
   1 to 50 000 rows, 1 to 500 trees (24, 25, 26 among them), depths 0, 1,
   6, 9 and 13, 600 features, the affine step, a first tree of -0.0
   leaves; split gain at 1 to 8192 bins and on the timed training
   panel); the histogram
   (direct and child mode, up to 257 bins at 32 nodes and 6 levels)
   with ``torch.equal`` against ``ref.hist_levels_fixed`` (the kernel's
   fixed-point arithmetic in plain PyTorch, run on the card) on every
   case, with ``torch.equal`` against the plain version on integer-valued
   g/h, and within ``ref.hist_rounding_bound(..., quantum=ref.
   hist_quanta(gh))`` of it on real g/h (the worst share of the bound is
   printed), child mode's row counts with ``torch.equal``; the exact
   inputs that phase 4 times are checked too.  Each kernel is launched
   twice on one input and the two results held with ``torch.equal``:
   that is its ``deterministic`` flag in the kernels line;
4. time    -- each kernel timed with CUDA events at the shape its path
   gives it (serving: 4096 rows x 32 features, the whole 500-tree forest
   of depth 6 for the forest sum, a chunk of 25 trees for the per-tree
   form; training: 1M rows x 28 features, 32 nodes, 33 bins, one level),
   beside the plain version, one library call where one computes the
   same function, the least time the card could take (bound) and the
   launch floor (an empty kernel, ``torch.cuda._sleep(0)``, timed the
   same way: what a kernel of a few microseconds can still reach); the
   forest sum also on one block's 32 rows alone; the
   histogram also beside its fixed-point emulation and the times of the
   float-atomic kernel it replaced (a constant of this script, from the
   kernel table in PERF.md);
5. serve   -- the serving entry point (``serve_gbdt.main``) on the
   500 trees x depth 6 x 32 features (k = 32) synthetic forest, 32
   requests of 4096 rows, raw and binned; the launch counts are reset
   just before each run and read just after: one forest-sum launch a
   request and no per-tree launch; margins and bin ids checked bit for
   bit against the same model on the CPU, NaN rows included; a profile
   of raw requests by kernel;
6. train   -- ``repro_torch.fit(device="cuda")`` on the higgs-like
   ``gaussian_classification`` (28 features, 1M training rows, 100k held
   out; HIGGS has 11M rows, the one cut), ``GBDTConfig(n_trees=20,
   max_depth=6, n_candidates=32)``, direct and ``subtract=True``; the
   launch counts are reset just before each fit and read just after, and
   must be max_depth histogram and max_depth split-gain launches a tree;
   fit wall-clock, first and last train logloss, holdout accuracy
   through the traversal kernel, and a profile of a fit by kernel;
   train_repeat: the same fit again from the same seed, every forest
   field ``torch.equal`` to the first (the histogram and the leaf sums
   add in fixed point);
7. train_check -- a 4000 x 6 fit (6 trees, depth 4, k = 16) on the card
   and on the CPU from one injected grid, direct and subtract: structure
   exact; leaves within 1e-5 of the CPU's beyond the CPU's own rounding
   (``boosting.leaf_rounding``: the distance of its row-order float32
   leaf sums from the exact sums, which the card's fixed-point sums do
   not share), and the card's leaves within 1e-6 of their exact sums;
   train_vs_cpu (reported, not checked: the
   CPU sums in row order, the card in fixed point, so near-ties may
   split apart): two depth-4 trees at 1M rows from one injected grid on
   the card and on the CPU, the share of equal split features and, at
   each tree's first differing node, the gap between the two choices'
   gains on the CPU's histogram;
8. propose_check -- the device strategies' grids on the card against the
   CPU port's, bit for bit (``weighted_quantile`` and ``uniform_range``,
   compared as int32 bit patterns, any NaN equal to any NaN): at the
   training cell (1M x 28, k =
   32) with the hessian after one logistic round, and on a 50 000 x 4 set
   with heavy ties, -0.0, NaN of either sign and zero weights (k = 32 and
   255); the card's raw stable sort against the CPU's on that set (the
   signed-zero question) and ``sketch.stable_order`` equal on both;
9. propose_time -- each strategy's proposal alone: random,
   weighted_quantile and uniform_range at 1M x 28 with CUDA events beside
   the launch floor; gk_quantile at 100 000 x 4 and exact at 100 000 x 28
   on the host clock (``bench_proposal_time.py``'s cuts), beside random
   on the card at the same cuts; T(Q)/T(S) (Table 2's T column); a
   weighted-quantile proposal's device time by op;
10. table2 -- a fit per strategy (20 trees, depth 6, k = 32, direct):
   random, weighted_quantile and uniform_range at the training cell,
   random, gk_quantile and exact at 100 000 rows (the host strategies'
   cut); counts reset just before each fit and read just after (max_depth
   histogram and split-gain launches a tree); fit seconds, proposal
   seconds (the device strategies' from ``fit_reference``, whose forest
   must equal ``fit``'s), holdout accuracy and logloss;
   train_repeat for weighted_quantile; a weighted-quantile round's device
   time by kernel and by op; the accuracy gap of random against
   weighted_quantile;
11. telemetry -- fits at the training cell with telemetry off, on, on,
   off: the forest with it equal to the forest without it, both fit
   times, ``report.summarize()``, histogram updates direct against
   subtract;
12. rank_error -- ``rank_error.fig2_experiment(seed=0, n=1024, ks=[4, 16,
   64], trials=16)`` on the card (twice; the first is cold), within
   tests/test_rank_error.py's bounds of Theorem 1 (rel 0.5 random, 0.6
   quantile);
13. quickstart -- ``launch/quickstart.py`` on the card;
14. dist_check -- the histogram kernel on a grid shared with other ranks
   (``bits``: a larger maximum; ``log2n``: more rows) and with raw int64
   sums, ``torch.equal`` to ``ref.hist_levels_fixed`` given the same,
   direct and child mode with counts, and three slices' raw sums (a NaN g
   in one) adding up to one launch; then ``fit_distributed`` on ranks
   that share the card (``launch.distributed.run``: NCCL at 1 rank, gloo
   over CUDA tensors above), 4000 x 6, 6 trees, depth 4, k = 16,
   uniform_range, direct and subtract, at 1, 3 (padded) and 8 ranks:
   every forest field equal across them, structure equal to the
   single-card ``fit`` and leaves within 1e-4 of it
   (tests/test_distributed.py's bound; the base score is float32 here,
   float64 there); 24 + 24 launches on every rank;
15. dist_train -- the training cell at 1 and 8 ranks (one start of ranks
   with dist_check's): uniform_range direct and subtract equal across
   them; at 8 ranks random twice from one seed (equal) and
   weighted_quantile with telemetry, holdout accuracy within 0.03 of the
   single-card ``table2`` fit, fit seconds on every rank, 120 + 120
   launches on every rank (counts reset just before each fit and read
   just after, in each rank), bytes a round through the collectives
   beside ``collective_bytes_per_round``'s estimate, and the host ms of
   one all-reduce of the training panel alone; dist_profile -- a round on
   rank 0 of 8 by kernel, its collectives' host time and its idle share;
16. dist_serve -- ``serve(data_shards=2)`` from 2 ranks on the serving
   cell: p50 and p99, one forest-sum launch a request on each rank, and
   all 32 requests' margins bit-identical to unsharded serving;
17. dist_example -- ``launch/distributed_gbdt.py`` on 8 ranks at the
   example's sizes (32 768 / 8 192 rows, 10 trees, depth 5);
18. attn_check -- the flash-attention kernels held against their plain
   version (``ref.attention_ref``) on the card: MHA, GQA, MQA and a
   group of 16; causal, window 128, window 200 (not a tile multiple),
   window 1 and none; head dims 32, 64, 80, 128; 128 and 384 tokens, 2048
   (16 K/V tiles), and 1024 at 32:32 heads (512 work items, more than
   the card has SMs); each case one launch of the variant the dispatch
   names (every bf16 call on the Hopper kernel); ragged
   causal lengths through ``ops.flash_attention(..., ragged=True)`` (the
   ``xla_chunked`` path: padded to a multiple of 128, sliced back): 1000
   and 1500 tokens, GQA, float32 and bf16, and window 200 at 1000; the
   key-length bound (``kv_len_check``): both kernels at every head dim,
   K/V padded to a multiple of 128 with random padding, ``kv_len`` 1, 63,
   64, 65, 127, 129 and 1500 with no mask, 4096 queries over 1536 keys at
   ``kv_len`` 1500, causal over 1536 at ``kv_len`` 1500 and 1536 and
   with a window of 200 at ``kv_len`` 1000 (bands that keep no key), each
   against the plain version with the same ``kv_len`` and on the
   unpadded tensors, and a ragged length with no mask (q 1000 over k/v
   1500) through ``ops.flash_attention(..., ragged=True)``; float32
   within 2e-4 abs and rel (the JAX package's tolerance) and bf16 within
   that plus one bf16 rounding step (2^-7 of the value) plus
   ``ref.attention_rounding_bound`` (the Hopper kernel rounds P to bf16
   before its product with V); and the prefills' own shapes, causal,
   bf16: glm4-9b's, q (2, 32, 4096, 128), k/v (2, 2, 4096, 128), and
   deepseek-moe-16b's (MHA), q, k, v (2, 16, 4096, 128), and zamba2-2.7b's
   (MHA at head dim 80: three column chunks of 32, the last half zeros),
   q, k, v (2, 32, 4096, 80), each a launch of the Hopper kernel, the
   last two repeated bit for bit;
19. attn_time -- the Hopper kernel at glm4-9b's and at zamba2-2.7b's
   shapes, at head dim 64 at internvl2-1b's prefill (q (2, 14, 4352, 64),
   k/v (2, 2, 4352, 64), causal), whisper-tiny's encoder ((2, 6, 1536,
   64), ``kv_len`` 1500, no mask; its bound and SDPA over the 1500 real
   rows) and its cross-attention (q (2, 6, 4096, 64) over those K/V),
   each first held to the plain version; and the float32 kernel (on the check paths only) at q (1, 32,
   2048, 128), k/v (1, 2, 2048, 128), causal, with CUDA events, beside
   the plain version, ``F.scaled_dot_product_attention`` (the library
   yardstick, never called by the port; in float32 also held to the
   float32 contract) and the bound (bf16: the tensor cores' 989 TFLOP/s;
   float32: the CUDA cores' 67, since TF32 breaks the contract); TFLOP/s
   and share of the bound;
20. prefill -- glm4-9b at full width and depth (40 layers, random bf16
   weights from a seeded generator on the card) through
   ``make_prefill_step``: one warm-up request, then 4 requests of 2 x
   4096 tokens; p50 ms, tokens/s (all the tokens over the sum of the
   requests' walls), peak memory, 40 flash launches a
   request, all of the Hopper kernel (counts reset just before, read
   just after), the greedy next token;
21. prefill_profile -- one request's device time by kernel (flash,
   GEMMs, the rest) and the device's idle share;
22. prefill_check -- glm4-9b at full width with 2 layers, 1 x 256 tokens,
   ``attn_impl="pallas"``, the card against the port on the CPU with the
   same weights.  With float32 activations (the same modules, no bf16
   rounding between them) the logits agree within 2e-4 abs and rel.  The
   prefill step itself (bf16) rounds differently on the two sides, so
   each side is measured against the CPU's float32 logits: the card's
   bf16 logits lie within twice the CPU's own bf16 error of the CPU's,
   the card's own error is at most 1.25 times the CPU's, and a position
   whose argmax differs is a near tie (within twice that error in the
   float32 logits); the bf16 step on the Hopper kernel, the float32 one
   on the CUDA-core kernel; and a ragged case, 1 x 1000 tokens through
   ``xla_chunked`` (blockwise, padded on the card), float32 activations,
   card against CPU within 2e-4 abs and rel; none of it launched by the
   CPU run (``prefill_check``, shared with vlm_check and audio_check);
23. decode -- ``serve.generate("glm4-9b", smoke=False, batch=4,
   prompt_len=32, gen=16)``, at full width and depth (random bf16 weights
   from seed 0): the prompt token by token through the serve step into a
   KV cache, then greedy decode; the prefill-into-cache seconds, each
   decode step's ms (p50), tokens/s (all decoded tokens over the sum of
   the steps' walls), peak memory, the greedy tokens, one
   profiled step's device time, idle share and top ops, and no launch of
   any kernel of the port (decode attention is plain torch,
   as in the JAX package).  The decode path's logits at the prompt
   positions (the prompt through ``prefill_into_cache`` once more,
   keeping every position's logits, which ``generate`` does not) are held to the card's own prefill step over the prompt
   under the prefill's contract: against the float32 logits, the decode
   path's error at most 1.25 times the prefill step's, the two within
   twice it, the argmax differing only at near ties;
24. decode_time -- the serve step at the dry-run's ``decode_32k`` cache
   length (32 768 slots, every row at position 32 767; the cache filled
   with seeded bf16 values), batch 32 (the one cut: 128 would need 172 GB
   of K/V), 3 warm-up and 20 timed steps: p50 ms, tokens/s (over the sum
   of the timed walls), peak memory,
   the bytes bound (weights and K/V read once a step over the HBM rate),
   and one profiled step's device time by group (``decode_attention``:
   the cache writes, scores, softmax and P V of ``attention.decode_attend``;
   GEMMs; the rest) and the device's idle share;
25. decode_check -- glm4-9b at full width with 2 layers, 2 rows at
   different positions (0 and 3 ahead), the card against the port on the
   CPU with the same weights and float32 activations and caches: every
   step's logits within 2e-4 abs and rel, and the caches within the same
   bound with the same slots written; without a window over 24 tokens and
   with window 16 over 40 (the ring buffer wraps twice);
26. moe_decode -- ``serve.generate("deepseek-moe-16b", smoke=False, ...)``
   with decode's arguments: p50 a step, tokens/s, peak memory, a profiled
   step's device time and idle share, the bound of reading every weight
   once (every expert runs on its slots, empty
   or not), no kernel launch of the port;
27. moe_prefill -- deepseek-moe-16b at full width and depth (28 layers;
   generate's model) through ``make_prefill_step``: one warm-up and 4
   requests of 2 x 4096 tokens (the cut of ``prefill_32k`` that glm4-9b
   takes); p50 ms, tokens/s, peak memory, 28 flash launches a request,
   all of the Hopper kernel; the dropped assignments of each layer in the
   last timed request (960 slots an expert, ``MoE.n_dropped``); one request's device time by group (the experts'
   products and activation, ``moe_experts``; the router, dispatch and
   combine; the shared experts; flash attention; the other GEMMs; the
   rest) and the device's idle share;
28. moe_check -- deepseek-moe-16b at full width with 2 layers, 1 x 256
   tokens, the card against the port on the CPU with the same weights and
   float32 activations: logits within 2e-4 abs and rel, the dropped
   assignments of each layer equal (capacity factor 1.25); on the card
   ``onehot`` and ``sort`` dispatch give equal logits at capacity factor
   8.0;
29. ssm_check -- xlstm-125m at full width with 8 layers (2 groups), the
   card against the port on the CPU with the same weights and float32
   activations: each block of the prefill over 1 x 512 tokens (2 chunks
   of 256), run on the card from the CPU's input to it, within 2e-4 abs
   and rel; the logits within 2e-4, or within 4 times the model's own
   response to a rounding at each block where that is larger (the CPU's
   logits with every block's input moved by one float32 step: at random
   init the mLSTM's normalised outputs carry a rounding some 30-fold a
   layer, and the card reorders every sum besides); the bf16 prefill step finite; on the card the decode
   path over the same 512 tokens (the serving prefill, token by token)
   against the chunked prefill's logits within the JAX package's
   chunked-vs-sequential tolerance (rtol 2e-2, atol 2e-3), every logit
   finite (the JAX package's mLSTM prefill is NaN at this width: ROADMAP,
   Reference conditions); then 16 decode steps from that state on both
   devices: every step's logits and the recurrent states as the
   prefill's logits;
30. hybrid_check -- the same for zamba2-2.7b with 12 layers (2 groups,
   ``attn_impl="pallas"``): the shared block launches the flash kernel
   once a group, on the CUDA-core float32 kernel in the float32 prefill
   and on the Hopper kernel (head dim 80) in the bf16 step; the Mamba
   states
   and the per-group KV caches within 2e-4, the same slots written;
31. hybrid_decode -- ``serve.generate("zamba2-2.7b", smoke=False, ...)``
   with decode's arguments, at full width and depth (54 layers): as
   ``decode`` (the prefill-into-cache seconds, step p50, tokens/s, peak,
   a profiled step's device time and idle share, no kernel launch of the
   port, the prompt logits under the prefill contract);
32. hybrid_prefill -- its model through ``make_prefill_step``: one
   warm-up and 4 requests of 2 x 4096 tokens (glm4-9b's cut); p50,
   tokens/s, peak, 9 flash launches a request (one a group), all on the
   Hopper kernel; one request's device time by group (the chunked
   SSD scan, ``ssd_scan``: ``ssm.chunked_decay_attention``; flash; GEMMs;
   the rest) and the idle share;
33. hybrid_long -- the serve step at the dry-run's ``long_500k``: batch 1
   at position 524 287 of a 524 288-slot cache a group (a recurrent arch
   has no window), the caches seeded bf16 and the Mamba states float32
   (48.39 GB of state), the peak reckoned first (the slots halved until
   it fits, each cut listed); 2 warm-up and 5 timed steps: p50, peak, the
   bytes bound (weights and state read once), a profiled step's device
   time by group (``decode_attention``) and idle share;
34. ssm_decode -- ``serve.generate("xlstm-125m", smoke=False, ...)`` as
   ``decode``, at full width and depth (12 layers), no kernel launch;
35. ssm_prefill -- its model through ``make_prefill_step``: one warm-up
   and 2 requests of 2 x 4096 tokens; p50, tokens/s, peak, no flash
   launch; a request of 2 x 512 tokens (the sLSTM loop's ~200 000 launches
   at 2 x 4096 take the profiler minutes) profiled by group (the sLSTM
   time loop, ``slstm_scan``; ``ssd_scan``; GEMMs; the rest), the labels'
   host time, the idle share against the same request unprofiled;
36. vlm_check -- internvl2-1b at full width with 2 layers over 256
   seeded patches and 256 tokens (``pallas``), the card against the port
   on the CPU with the same weights (``prefill_check``): float32 logits
   within 2e-4; the bf16 prefill step under ``bf16_contract`` (each side
   against the CPU's float32 logits, the card's error at most 1.25 times
   the CPU's, the two within twice it), the argmax differing only at near
   ties; 2 launches each on the Hopper (bf16) and the CUDA-core (float32)
   kernel; and 256 + 1000 tokens through ``xla_chunked`` (padded to 1280)
   in float32 within 2e-4;
37. vlm_decode -- ``serve.generate("internvl2-1b", ...)`` as ``decode``
   (served without patches, as in the JAX package; the prompt contract's
   prefill step takes an image of none);
38. vlm_prefill -- its model through ``make_prefill_step``: one warm-up
   and 4 requests of 2 x (256 seeded patches + 4096 tokens); p50,
   tokens/s, peak, 24 flash launches a request on the Hopper kernel,
   device time by group;
39. audio_check -- whisper-tiny at full width and depth over 1500 seeded
   frames and 256 tokens (``xla_chunked``: the encoder's and the
   cross-attention's K/V padded to 1536, bounded by ``kv_len``), as
   vlm_check (8 launches each), and the encoder's output and the cross
   K/V in float32 within 2e-4, the bf16 cross K/V cache that
   ``prefill_into_cache`` fills under ``bf16_contract``;
40. audio_decode -- ``serve.generate("whisper-tiny", ...)`` as ``decode``:
   the frames encoded once (4 flash launches a generate, at 1536 with
   ``kv_len`` 1500), decode attention and the cross-attention against the
   cached K/V plain torch;
41. audio_prefill -- its model through ``make_prefill_step``: 2 x 4096
   tokens over 2 x 1500 seeded frames, 12 flash launches a request (4
   encoder, 4 decoder, 4 cross-attention: the timed requests count the
   launches inside ``encode_audio`` and ``CrossBlock.forward``), device
   time by group (``audio_encoder``, ``cross_attention``: the aten work
   inside them);
42. attn_bwd_check -- the attention backward kernels
   (``flash_attention_bwd_cuda``: bf16 ``bwd_dq_wgmma``, ``bwd_dkdv_wgmma``
   and, where a group's heads are split, ``bwd_dkdv_sum``; float32
   ``bwd_dq`` then ``bwd_dkdv``) against ``ref.attention_bwd_ref`` at every
   head dim (32, 64, 80, 128), float32 and bf16, causal, window, no mask
   with sq != sk, ragged ``kv_len``, GQA 16:2 and MHA, the moe prefill's
   shape, and q 1000 over K/V 1000 and 1500 through
   ``ops.flash_attention(..., ragged=True)`` under autograd: float32
   within 2e-4 of max(1, max|want|), bf16 within that plus one bf16 step
   of the value plus ``ref.attention_bwd_rounding_bound``; a second call
   the same bits; at every bf16 case the forward's lse (``with_lse``, the
   training path) against ``ref.attention_lse`` within 2e-4 of max(1,
   |want|), the rows that keep no key +inf in both, the forward's output
   the same bits with and without it, and the backward given it the same
   bits as without; groups split among the dK/dV work items (7:1, 16:2)
   and not (MHA), each call's kernels counted, twice the same bits;
43. attn_bwd_time -- the backward at internvl2-1b's training shape (q 2 x
   14 x 4352 x 64, k/v 2 x 2 heads) and glm4-9b's (q 1 x 32 x 4096 x
   128, k/v 2 heads), causal bf16: CUDA events beside the forward kernel,
   the plain version and the backward of
   ``F.scaled_dot_product_attention`` (``enable_gqa``; timed only, never
   on the path), given the forward's lse as training gives it, launches a
   call by kernel, the instances' registers, and the bound (the five
   products' operations, 2.5 times the forward's, at 989 TFLOP/s);
44. lm_train_check -- one ``make_train_step`` step of internvl2-1b at full
   width with 2 layers, float32 weights from a seed and float32
   activations, on the card and on the CPU: 2 x (256 patches + 256
   tokens) on the naive path (no flash launch) and 1 x (256 + 1000) on the
   kernels (padded to 1280: 2 forward launches a layer with remat, 1
   backward call); loss and gnorm within 1e-4 relative, m and v within
   2e-4 of each leaf's largest, the parameters within 2 lr (a gradient
   near 0 may take Adam's first step the other way) plus 1e-6;
45. lm_train -- internvl2-1b at full width and depth (24 layers, 494.6 M
   float32 parameters, remat, ``xla_chunked``), 2 x (256 patches + 4096
   tokens) a step from ``launch.train.make_batch_fn``, nothing cut: one
   warm-up and 10 steps; the losses (the last below the first), step p50
   and p99, text tokens/s, peak memory, the flash launches a step
   (forward, backward calls, backward kernels) counted in the run, no
   call of the plain attention or its backward; one profiled step's idle
   share (of its own wall and of the unprofiled p50) and device ms by
   group (``attention_backward``,
   ``flash_attention``, ``xent``, ``optimizer``, GEMMs, the rest);
46. lm_pretrain -- xlstm-125m at full size through
   ``launch.lm_pretrain.pretrain``: 10 steps of 8 x 256 tokens with a
   checkpoint at 5 and 10, then again from the checkpoint at 5: the
   resumed losses and the final parameters and moments bit for bit the
   first run's;
47. roofline -- the prefill's step (glm4-9b, 2 x 4096) and lm_train's
   (internvl2-1b, 2 x (256 + 4096)) counted on the meta device
   (``launch.roofline.count_step``, the flash calls as the kernel does
   the work) with the card's peaks imported from ``launch.roofline``:
   model FLOPs and counted FLOPs, the compute and memory terms, the
   measured p50 and ``model_flops / (p50 x 989 TFLOP/s)``, the peak
   estimate beside the step's own ``max_memory_allocated`` (prefill: the
   peak reset before each timed request and read before its logits are
   checked; lm_train: over the timed steps), ``nvidia-smi``'s name and
   power limit; the flash calls counted must equal the launches the phase
   counted a request or a step, and the estimate must lie within
   ``launch.roofline.PEAK_MARGIN`` of the measured peak (the margin
   ``fits_one_card`` leaves);
48. sharded -- the JAX package's sharding plan applied as DTensor
   placements on two ranks of the card (``launch.distributed.run``: gloo,
   a ``FileStore``; DTensor's collectives through ``GlooCollectives``,
   which ``logical_rules`` enters on such a mesh), tensor-parallel over
   'model' on ``make_debug_mesh(1, 2)``: (a) internvl2-1b's train step
   at full width, 2 x (256 + 4096), held at 2 layers in float32 to the
   one-process card step (loss and gnorm within 1e-4 relative, m and v
   within 2e-4 of each leaf's largest), then at full depth in bf16: a
   warm-up and 3 timed steps; (b) glm4-9b's prefill, 2 x 4096, held at 2
   layers in float32 within 2e-4, then at full depth in bf16: a warm-up
   and 2 timed requests; the flash forward and backward kernels must run
   on each rank's local heads (7:1 and 16:1 query:kv) and launch 48 + 24
   a step and 40 a request on rank 0; (c) the collective operand bytes
   each rank's counter saw in one step and one request must equal the
   fake-group meta count of the same steps on the same mesh
   (``launch.dryrun.measure_sharded``); ``nvidia-smi``'s line beside;
49. total -- the script's seconds; kernels -- one line listing every
   ported kernel with its launches,
   error, times, bound, launch floor and ``deterministic`` flag (and for
   flash attention the variant, and under ``variants``, keyed by variant
   and head dim, each one's time, registers and launches by path:
   ``wgmma_bf16_d128`` at glm4-9b's prefill shape, ``wgmma_bf16_d80`` at
   zamba2's, ``wgmma_bf16_d64_*`` at the vlm and whisper shapes,
   ``cuda_core_f32_d128`` at attn_time's float32 shape, its
   error measured there, with its launches on the check paths; its SASS
   counts and its launches on every prefill and decode path;
   for the histogram and
   split gain also their launches on each path of phases 10, 11, 14
   and 15, per rank on the distributed paths).  The
   per-tree traversal is on no path any more (``launches`` 0,
   ``on_main_path`` false): it is listed as the counterpart of
   ``ops.traverse_chunk``.  The attention backward's entry has its
   launches on ``lm_train`` and its times at both training shapes.  The
   flash entries count rank 0's launches on the sharded paths too.

Each LM is freed before the next is built (glm4-9b's 17.6 GB,
deepseek-moe-16b's 33.3 GB, zamba2-2.7b's 4.6 GB, internvl2-1b's 1.0 GB
and whisper-tiny's 0.07 GB of weights are never resident together).
The new phases print their seconds.  Precision: float32 matrix products
in full float32 (``allow_tf32`` off) and bf16 products reduced in float32
(``allow_bf16_reduced_precision_reduction`` off), set and printed first.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits non-zero before any result.  Every check raises on failure.
"""

import contextlib
import copy
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the card's peaks (H100 SXM: HBM bytes/s, float32 and bf16 FLOP/s)
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, PEAK_MARGIN)

TREES, DEPTH, FEATURES, CANDIDATES = 500, 6, 32, 32
MICROBATCH, REQUESTS, WARMUP_REQUESTS, TREE_CHUNK = 4096, 32, 2, 25

# training: higgs-like rows (HIGGS has 28 features and 11M rows)
TRAIN_ROWS, HOLDOUT_ROWS, TRAIN_FEATURES = 1_000_000, 100_000, 28
TRAIN_TREES, TRAIN_DEPTH, TRAIN_CANDIDATES = 20, 6, 32
TRAIN_NODES = 2 ** (TRAIN_DEPTH - 1)          # frontier width
# train_vs_cpu's trees: depth 4, shallower than the training phases' 6,
# which keeps the script's total time in bounds beside the sharded phase
VS_CPU_DEPTH = 4
TRAIN_BINS = TRAIN_CANDIDATES + 1

# the proposal strategies: the ties set of propose_check, and the cut of
# the host strategies (pure-Python numpy; bench_proposal_time.py's cuts)
TIES_ROWS, TIES_FEATURES = 50_000, 4
HOST_ROWS, GK_FEATURES = 100_000, 4
FIG2 = dict(n=1024, ks=[4, 16, 64], trials=16)     # the quickstart's

# prefill: glm4-9b; the dry-run's prefill_32k shape (32 x 32768) cut to
# 2 x 4096, since its bf16 logits alone would be 318 GB
LM_ARCH, LM_BATCH, LM_SEQ, LM_REQUESTS = "glm4-9b", 2, 4096, 4
# serving: serve.generate's own defaults (4 prompts of 32 tokens, 16
# generated); the dry-run's decode_32k shape (128 x 32768) cut to batch 32,
# since its bf16 K/V alone would be 172 GB at 128
DECODE = dict(batch=4, prompt_len=32, gen=16)
DECODE_TIME_BATCH, DECODE_TIME_LEN, DECODE_TIME_STEPS = 32, 32_768, 20
MOE_ARCH = "deepseek-moe-16b"
ATTN_F32_TOL = 2e-4               # the JAX package's flash-attention test
BF16_STEP = 2.0 ** -7             # one bf16 rounding: at most 2^-7 of x
SASS_OPS = ("HGMMA", "UTMALDG")   # wgmma and TMA loads in cuobjdump -sass
# the times of the float-atomic histogram kernel this one replaced, direct
# and child mode, at the timed shape (this script on an H100 80GB HBM3 at
# 700 W; PERF.md, kernel table)
REPLACED_HIST_MS = {"direct": 0.3170, "left": 0.2552}
# training: the backward at internvl2-1b's and glm4-9b's shapes, (batch, q
# heads, kv heads, seq, head dim), causal bf16; the training cell
BWD_SHAPES = {"internvl2_1b": (2, 14, 2, 4352, 64),
              "glm4_9b": (1, 32, 2, 4096, 128)}
TRAIN_ARCH, TRAIN_BATCH, TRAIN_TEXT, TRAIN_STEPS = "internvl2-1b", 2, 4096, 10
PRETRAIN = dict(arch="xlstm-125m", steps_n=10, batch=8, seq=256,
                ckpt_every=5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 10) -> tuple[float, float]:
    """Time ``iters`` back-to-back calls of ``fn()`` with CUDA events.

    Returns (device ms, issue ms) per call.  For the device time the
    stream is first held by a ~0.2 s spin kernel while the host queues
    every call, so the events bracket the kernels alone and not the
    host's launch overhead; the issue time is the same loop with the
    stream free, where a call that is shorter than its launch waits on
    the host.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold in (True, False):
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(400_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out[0], out[1]


def make_chunk(rng, *, n, C, depth, binned, f=FEATURES, k=CANDIDATES,
               out_of_range=False, device="cuda"):
    """A random tree chunk and rows in the mode's dtype, with passthrough
    nodes, passthrough zero-leaf padding trees (the last C // 8) and, on
    the raw path, NaN cells and a NaN row; ``out_of_range`` puts feature
    ids past the last feature and below -1 into every third node."""
    n_inner = 2 ** depth - 1
    feature = rng.integers(0, f, size=(C, n_inner)).astype(np.int32)
    passthrough = rng.random(size=(C, n_inner)) < 0.15
    leaf = rng.normal(size=(C, n_inner + 1)).astype(np.float32)
    pad = C // 8
    if binned:
        values = rng.integers(0, k + 1, size=(n, f)).astype(np.int32)
        cmp = rng.integers(0, k, size=(C, n_inner)).astype(np.int32)
        cmp[passthrough] = k
        pad_cmp = 2 ** 20
    else:
        values = rng.normal(size=(n, f)).astype(np.float32)
        values[::7, 5] = np.nan
        values[n // 2, :] = np.nan
        cmp = rng.normal(size=(C, n_inner)).astype(np.float32)
        cmp[passthrough] = np.inf
        pad_cmp = np.inf
    feature[passthrough] = -1
    if out_of_range:
        feature[:, ::3] = rng.integers(f, f + 8, size=feature[:, ::3].shape)
        feature[:, 1::6] = -3
    if pad:
        feature[C - pad:] = -1
        cmp[C - pad:] = pad_cmp
        leaf[C - pad:] = 0.0
    return tuple(torch.from_numpy(a).to(device)
                 for a in (values, feature, cmp, leaf))


def bound_ms(nbytes, ops) -> tuple[float, str]:
    """The least time of a launch: its bytes at the HBM rate against its
    float32 operations at the card's rate; the larger bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traverse_bound_ms(n, f, C, depth, out_per_row=None) -> tuple[float, str]:
    """Each input read once and the output written once (C values a row,
    or ``out_per_row``: 1 for the forest sum), against one compare per
    (row, tree, level)."""
    n_inner = 2 ** depth - 1
    out = C if out_per_row is None else out_per_row
    nbytes = 4 * (n * f + 2 * C * n_inner + C * (n_inner + 1) + n * out)
    return bound_ms(nbytes, n * C * depth)


def hist_bound_ms(bins, node, n_nodes, nbins, child) -> tuple[float, str]:
    """What these inputs need: every node id read once; the bin ids and
    g/h of the rows that add (every valid row; in child mode the rows
    routed left), two adds per (level, row, feature) and, in child mode,
    one count; the panel (and the counts) written once."""
    n, f = bins.shape
    L = node.shape[0]
    adds = (node >= 0) & (node % 2 == 0) if child else (
        (node >= 0) & (node < n_nodes))
    rows_read = int(adds.any(dim=0).sum())
    per_bucket = 12 if child else 8
    nbytes = (4 * L * n + rows_read * (4 * f + 8)
              + per_bucket * L * n_nodes * f * nbins)
    return bound_ms(nbytes, (3 if child else 2) * int(adds.sum()) * f)


def split_gain_bound_ms(rows, nbins) -> tuple[float, str]:
    """The histogram read once and (gain, bin) written once, against ~14
    float operations a bin (two prefix adds, two subtractions, two
    scores of three operations, the gain's four)."""
    return bound_ms(8 * rows * nbins + 8 * rows, 14 * rows * nbins)


def hist_case(gen, *, n, f, nbins, n_nodes, L, child):
    """Bin ids, node ids with masked (-1) rows (child frontier ids in
    child mode), integer-valued g/h and real g/h, made on the card."""
    dev = "cuda"
    bins = torch.randint(0, nbins, (n, f), generator=gen, device=dev,
                         dtype=torch.int32)
    hi = 2 * n_nodes if child else n_nodes
    node = torch.randint(-1, hi, (L, n), generator=gen, device=dev,
                         dtype=torch.int32)
    gh_int = torch.randint(-3, 4, (n, 2), generator=gen,
                           device=dev).to(torch.float32)
    gh_real = torch.randn((n, 2), generator=gen, device=dev)
    for gh in (gh_int, gh_real):
        gh[:, 1].abs_()
    return bins, node, gh_int, gh_real


def gain_case(gen, n_nodes, f, nbins):
    """A histogram with 30 % empty bins and an all-empty node."""
    h = torch.randn((n_nodes, f, nbins, 2), generator=gen, device="cuda")
    h[..., 1].abs_()
    empty = torch.rand((n_nodes, f, nbins), generator=gen,
                       device="cuda") < 0.3
    h[empty] = 0.0
    h[0] = 0.0
    return h


def by_kernel(prof, per: int, key: str, ops: bool = False) -> list[dict]:
    """Device time of each kernel of a profile, per ``key`` unit; with
    ``ops``, of each host op (``aten::sum``, ...) by the kernels it
    launched itself."""
    want = (torch.autograd.DeviceType.CPU if ops
            else torch.autograd.DeviceType.CUDA)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != want:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if ops and not dev_us:
            continue
        rows.append({"name": ev.key[:60], "count": ev.count,
                     f"device_us_per_{key}": dev_us / per})
    rows.sort(key=lambda r: -r[f"device_us_per_{key}"])
    return rows


def attn_bound_ms(b, hq, hkv, sq, sk, d, itemsize, causal) -> tuple:
    """The unmasked (query, key) pairs at 4d operations each over the
    peak rate of the dtype (bf16: the tensor cores; float32: the CUDA
    cores, since TF32 would break the 2e-4 contract), against q, k, v
    read once and o written once over the HBM rate.  ``sk`` is the real
    keys (a call's ``kv_len``), not its padding."""
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * sk)
    rate = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    t_ops = pairs * 4 * d / rate * 1e3
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


KV_LENS = (1, 63, 64, 65, 127, 129, 1500)   # attn_check's key-length bounds


def attn_within(got, q, k, v, **mask) -> tuple[bool, float, float]:
    """Kernel against plain version on the same inputs: float32 within
    2e-4 abs and rel; bf16 within that plus one bf16 rounding step of the
    value, since both round a float32 result (of their own order of adds)
    to bf16, plus ``ref.attention_rounding_bound``, since the Hopper
    kernel rounds P to bf16 before its product with V.  Returns (within,
    max abs error, largest share of the tolerance used)."""
    from repro_torch.kernels import ref
    want = ref.attention_ref(q, k, v, **mask).float()
    tol = ATTN_F32_TOL + ATTN_F32_TOL * want.abs()
    if got.dtype == torch.bfloat16:
        tol += BF16_STEP * want.abs() + ref.attention_rounding_bound(
            q, k, v, **mask)
    diff = (got.float() - want).abs()
    return (bool((diff <= tol).all()), float(diff.max()),
            float((diff / tol).max()))


def kv_len_check(gen) -> dict:
    """The flash kernels' key-length bound on the card, both variants at
    every head dim: K/V padded to a multiple of 128 beyond ``kv_len`` (the
    padding random, so that a key past the bound that were attended to
    would show); no mask at each bound of ``KV_LENS`` (inside a tile, at
    its edges, past the first tile, whisper's 1500 frames in 1536), 4096
    queries over 1536 keys (sq != sk), causal over 1536 at ``kv_len`` 1500
    and at ``kv_len`` = sk, causal with a window of 200 over 1536 at
    ``kv_len`` 1000 (the last query tiles' bands keep no key: their rows
    get 0); each against the plain version with the same
    ``kv_len`` and against it on the unpadded tensors (the rows that exist
    there).  Then a ragged length with no mask on ``xla_chunked``'s
    blockwise path (``ops.flash_attention(..., ragged=True)``): q 1000
    over k/v 1500, padded by their own lengths, one launch.  Returns the
    ``attn_check`` fields."""
    from repro_torch.kernels import flash_attention as flash, ops
    cases = [(256, -(-n // 128) * 128, n, False, 0) for n in KV_LENS]
    cases += [(4096, 1536, 1500, False, 0), (1536, 1536, 1500, True, 0),
              (1536, 1536, 1536, True, 0), (1536, 1536, 1000, True, 200)]
    err_by, share_by = (dict.fromkeys(flash.VARIANTS, 0.0) for _ in range(2))
    n = 0
    for sq, sk, kv_len, causal, window in cases:
        for d in flash.HEAD_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((1, 6, sq, d), generator=gen,
                                device="cuda").to(dtype)
                k, v = (torch.randn((1, 2, sk, d), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                name = flash.variant(dtype, d)
                before = flash.launches_by_variant[name]
                mask = dict(causal=causal, window=window)
                got = flash.flash_attention_cuda(q, k, v, kv_len=kv_len,
                                                 **mask)
                torch.cuda.synchronize()
                rows = kv_len if causal else sq
                ok, err, share = attn_within(got, q, k, v, kv_len=kv_len,
                                             **mask)
                ok_u, err_u, share_u = attn_within(
                    got[:, :, :rows], q[:, :, :rows], k[:, :, :kv_len],
                    v[:, :, :kv_len], **mask)
                check(ok and ok_u and got.shape == q.shape
                      and flash.launches_by_variant[name] == before + 1,
                      f"flash kernel ({name}) with kv_len {kv_len} != plain "
                      f"version (sq={sq}, sk={sk}, causal={causal}, window="
                      f"{window}, d={d}, {dtype}, max_abs_err={err} / "
                      f"{err_u} unpadded, share of tolerance {share} / "
                      f"{share_u})")
                err_by[name] = max(err_by[name], err, err_u)
                share_by[name] = max(share_by[name], share, share_u)
                n += 1
    q = torch.randn((1, 6, 1000, 64), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, 6, 1500, 64), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    before = flash.launches
    got = ops.flash_attention(q, k, v, causal=False, ragged=True)
    torch.cuda.synchronize()
    ok, no_mask_err, no_mask_share = attn_within(got, q, k, v, causal=False)
    check(ok and flash.launches == before + 1 and got.shape == q.shape,
          f"ragged flash with no mask (q 1000, k/v 1500) != plain version "
          f"(max_abs_err={no_mask_err}, share {no_mask_share})")
    return {"cases": n + 1, "kv_lens": list(KV_LENS), "max_abs_err": err_by,
            "max_share_of_tolerance": share_by,
            "ragged_no_mask_q1000_kv1500": {
                "max_abs_err": no_mask_err,
                "share_of_tolerance": no_mask_share}}


def attn_time(q, k, v, *, variant: str, causal: bool = True,
              kv_len: int | None = None, q_len: int | None = None,
              name: str | None = None) -> dict:
    """The flash kernel at q, k, v (K/V padded beyond ``kv_len``, q beyond
    ``q_len``) with CUDA events, beside the plain version on the same
    inputs, ``F.scaled_dot_product_attention`` (the library yardstick,
    never called by the port) on the unpadded tensors, and the bound of
    the real queries' and keys' work; emits one ``attn_time`` line and
    returns its numbers."""
    from repro_torch.kernels import flash_attention as flash, ref
    t_phase = time.perf_counter()
    b, hq, _, d = q.shape
    sk = k.shape[2] if kv_len is None else kv_len
    sq = q.shape[2] if q_len is None else q_len
    ms, issue_ms = cuda_ms(lambda: flash.flash_attention_cuda(
        q, k, v, causal=causal, kv_len=kv_len), iters=10, warmup=2)
    plain_ms, _ = cuda_ms(lambda: ref.attention_ref(
        q, k, v, causal=causal, kv_len=kv_len), iters=3, warmup=1)
    gqa = hq != k.shape[1]
    qu, ku, vu = q[:, :, :sq], k[:, :, :sk], v[:, :, :sk]
    library_ms, _ = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, ku, vu, is_causal=causal, enable_gqa=gqa), iters=10,
        warmup=2)
    bound_ms, bound_by = attn_bound_ms(b, hq, k.shape[1], sq, sk, d,
                                       q.element_size(), causal)
    flops = b * hq * (sq * (sq + 1) // 2 if causal else sq * sk) * 4 * d
    out = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / (ms * 1e-3) / 1e12,
               library_tflops=flops / (library_ms * 1e-3) / 1e12,
               share_of_bound=bound_ms / ms, gflop=flops / 1e9)
    emit("attn_time", kernel="flash_attention", variant=variant, name=name,
         shape=dict(q=list(q.shape), kv=list(k.shape), q_len=sq,
                    kv_len=sk, causal=causal, dtype=str(q.dtype)[6:]),
         kernel_us=ms * 1e3, **out,
         bound_peak_tflops=(BF16_OPS_PER_S if q.element_size() == 2
                            else FP32_OPS_PER_S) / 1e12,
         seconds=time.perf_counter() - t_phase)
    return out


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel (by mangled name) from
    ``-Xptxas -v`` output, and the ptxas warnings that name it
    (``setmaxnreg ignored``, ``wgmma ... serialized``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"warnings": []}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    for line in log.splitlines():
        if "arning" in line or "C75" in line:
            for n in out:
                if n in line:
                    out[n]["warnings"].append(line.strip())
    return out


def sass_text(lib: Path) -> str | None:
    """``cuobjdump -sass`` of ``lib``; None where the toolkit has no
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_counts(lib: Path) -> dict | None:
    """Instructions of ``SASS_OPS`` in the SASS of ``lib``."""
    sass = sass_text(lib)
    if sass is None:
        return None
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def sass_atomics(lib: Path) -> dict | None:
    """Atomic instructions in the SASS of ``lib`` by their full opcode
    (``ATOMS.ADD``, ``ATOMS.CAST.SPIN.64``, ``REDG.E.ADD.64...``)."""
    sass = sass_text(lib)
    if sass is None:
        return None
    ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass)
    return {op: ops.count(op) for op in sorted(set(ops))}


def float32_logits(model, cfg, tokens, **extra) -> torch.Tensor:
    """The prefill's logits with float32 activations: the same modules and
    weights (bf16 weights widen exactly), no bf16 rounding in between;
    ``extra`` the request's patches or frames."""
    with torch.inference_mode():
        x, _ = model.hidden({"tokens": tokens, **extra}, cfg=cfg,
                            dtype=torch.float32)
        return model.logits(x).float().cpu()


def float32_decode(model, cfg, state, tokens, pos, *, window=0):
    """A decode step with float32 activations: the embedding widened, then
    the layer stack's decode over ``state`` (updated in place), ``ln_f``
    and the logits, as ``decode_step`` runs them in bf16."""
    with torch.inference_mode():
        device = model.embed.table.device
        x = model.embed(torch.as_tensor(tokens, device=device),
                        dtype=torch.float32)
        x = model.decode_backbone(cfg, x, state,
                                  torch.as_tensor(pos, device=device),
                                  window=window)
        return model.logits(model.ln_f(x)).float().cpu()


def _stack_blocks():
    """(owner, name) of the functions that run one block of the ssm and
    hybrid stacks, over the full sequence and over one token; each takes
    the block's input x as its third argument."""
    from repro_torch.models import model as model_lib, ssm
    return [(ssm.MLSTM, "forward"), (ssm.SLSTM, "forward"),
            (ssm.Mamba2, "forward"), (model_lib.DecoderBlock, "forward"),
            (model_lib.DecoderBlock, "decode"), (ssm, "mlstm_step"),
            (ssm, "slstm_step"), (ssm, "mamba2_step")]


@contextlib.contextmanager
def rounded_blocks():
    """Run the ``with`` block with every block's input x moved by one
    float32 rounding step (2^-23 of each value, a seeded random sign):
    how far the model itself carries the roundings of its blocks, the
    scale of the float32 differences that two devices' orders of
    operations leave."""
    saved = []
    for owner, name in _stack_blocks():
        real = getattr(owner, name)

        def wrapped(a, b, x, *rest, _real=real, **kw):
            sign = torch.randint(0, 2, x.shape, generator=torch.Generator()
                                 .manual_seed(0)).to(x.device) * 2 - 1
            return _real(a, b, x * (1 + 2.0 ** -23 * sign), *rest, **kw)
        saved.append((owner, name, real))
        setattr(owner, name, wrapped)
    try:
        yield
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def per_block_check(phase, card, host, cfg, tokens) -> dict:
    """Each block of ``host``'s float32 prefill over ``tokens`` (its
    output and, in the ssm blocks, its final state) against the same
    block of ``card`` run on the card from the CPU's input to it: within
    2e-4 abs and rel.  Returns the largest error a block kind."""
    from repro_torch.models import model as model_lib, ssm
    kinds = (ssm.MLSTM, ssm.SLSTM, ssm.Mamba2, model_lib.DecoderBlock)
    records = []
    hooks = [mod.register_forward_hook(
        lambda m, args, kwargs, out, name=name: records.append(
            (name, args, kwargs, out)), with_kwargs=True)
        for name, mod in host.named_modules() if isinstance(mod, kinds)]
    try:
        float32_logits(host, cfg, tokens)
    finally:
        for h in hooks:
            h.remove()
    on_card = dict(card.named_modules())
    worst: dict = {}

    def to_card(a):
        return a.cuda() if isinstance(a, torch.Tensor) else a
    with torch.inference_mode():
        for name, args, kwargs, out in records:
            got = on_card[name](*map(to_card, args),
                                **{k: to_card(v) for k, v in kwargs.items()})
            kind = type(on_card[name]).__name__
            for g, w in zip(_tensors(got), _tensors(out)):
                ok, err = within_f32(g, w)
                check(ok, f"{phase}: block {name} ({kind}) on the card, from "
                      f"the CPU's input, differs from the CPU's beyond "
                      f"{ATTN_F32_TOL} (max_abs_err={err})")
                worst[kind] = max(worst.get(kind, 0.0), err)
    return worst


def argmax_agreement(got, want) -> tuple[float, torch.Tensor, torch.Tensor]:
    """Share of positions whose argmax agrees, and where they differ the
    gap in ``want`` between its top token and ``got``'s."""
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    differ = a_got != a_want
    gap = (want.gather(-1, a_want[..., None])
           - want.gather(-1, a_got[..., None]))[..., 0]
    return 1.0 - float(differ.float().mean()), differ, gap


def within_f32(got, want) -> tuple[bool, float]:
    """float32 results within ATTN_F32_TOL abs and rel of ``want``."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    tol = ATTN_F32_TOL + ATTN_F32_TOL * want.float().cpu().abs()
    return bool((diff <= tol).all()), float(diff.max())


@contextlib.contextmanager
def labelled(patches, launches: dict | None = None):
    """Run the ``with`` block with each ``(module, name, label)``'s
    function wrapped in ``torch.profiler.record_function(label)``, or,
    given ``launches``, adding to ``launches[label]`` the flash launches
    made inside the function."""
    from repro_torch.kernels import flash_attention as flash
    saved = []
    for mod, name, label in patches:
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _label=label, **kw):
            if launches is None:
                with torch.profiler.record_function(_label):
                    return _real(*a, **kw)
            before = flash.launches
            out = _real(*a, **kw)
            launches[_label] = launches.get(_label, 0) + flash.launches \
                - before
            return out
        saved.append((mod, name, real))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def kernel_class(name: str) -> str:
    name = name.lower()
    if "bwd_dq" in name or "bwd_dkdv" in name:
        return "attention_backward"
    return ("flash_attention" if "flash_kernel" in name else "gemm"
            if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet",
                                       "sm90")) else "other")


def device_ms_by_group(prof, labels) -> tuple[dict, float]:
    """Device ms of a profile's kernels by group: the innermost of
    ``labels`` (``record_function`` ranges) around the aten op that
    launched the kernel; else ``flash_attention``, ``gemm`` or ``other`` by
    the kernel's name (a kernel launched outside an aten op, as the port's
    own kernels are through ctypes, is never inside a label here).
    Returns (groups, busy ms)."""
    groups = dict.fromkeys([*labels, "flash_attention", "gemm", "other"],
                           0.0)
    classes = [kernel_class(ev.key) for ev in prof.key_averages()]
    if "attention_backward" in classes:
        groups["attention_backward"] = 0.0
    for ev in prof.key_averages():
        # a label's range also shows on the device's timeline: not a kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.key not in labels:
            dev_us = getattr(ev, "self_device_time_total", None)
            groups[kernel_class(ev.key)] += (
                ev.self_cuda_time_total if dev_us is None else dev_us) / 1e3
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        label, up = None, ev
        while up is not None and label is None:
            label = up.name if up.name in labels else None
            up = up.cpu_parent
        if label is None:
            continue
        for k in ev.kernels:
            groups[label] += k.duration / 1e3
            groups[kernel_class(k.name)] -= k.duration / 1e3
    return groups, sum(groups.values())


def shares(groups: dict, busy: float) -> dict:
    """Each group's share of the busy time (None where the profile saw no
    device time)."""
    return {g: v / busy if busy else None for g, v in groups.items()}


def serve_step_profile(model, cfg, batch, cache_len, pos) -> tuple:
    """One serve step of ``batch`` rows at position ``pos`` of a
    ``cache_len``-slot cache, after one warm-up step, profiled: (device ms,
    the top aten ops by device time)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state
    state = init_decode_state(cfg, batch, cache_len, device="cuda")
    step = make_serve_step(cfg)
    tokens = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
    at = torch.full((batch,), pos, device="cuda")
    step(model, state, tokens, at)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(model, state, tokens, at)
        torch.cuda.synchronize()
    _, busy = device_ms_by_group(prof, [])
    return busy, by_kernel(prof, 1, "step", ops=True)[:8]


def lm_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def split_gains64(h, *, l2, gamma, min_child_weight) -> torch.Tensor:
    """(f, nbins) gain of every split bin of a one-node histogram
    (f, nbins, 2), in float64, -inf where illegal: the formula of
    ``ref.split_gain_ref`` without its float32 association."""
    h = h.double()
    gl, hl = h[..., 0].cumsum(-1), h[..., 1].cumsum(-1)
    g, hh = gl[..., -1:], hl[..., -1:]
    gain = 0.5 * (gl ** 2 / (hl + l2) + (g - gl) ** 2 / (hh - hl + l2)
                  - g ** 2 / (hh + l2)) - gamma
    ok = (hl >= min_child_weight) & (hh - hl >= min_child_weight)
    ok[..., -1] = False
    return torch.where(ok, gain, float("-inf"))


def first_difference(card, model, t, x, y) -> dict:
    """Where tree ``t`` of the card's forest first departs from the CPU
    model's (heap order), and how far apart the two choices' gains lie
    there: both evaluated on the CPU's rows and g/h at that node, with the
    CPU's row-order histogram and with the fixed-point one."""
    from repro_torch.core import binning, boosting, tree as tree_lib
    from repro_torch.kernels import ref
    cpu = model.forest
    differ = ((card.feature[t] != cpu.feature[t])
              | (card.split_bin[t] != cpu.split_bin[t]))
    if not bool(differ.any()):
        return {"tree": t, "equal": True}
    i = int(differ.to(torch.uint8).argmax())
    depth = (i + 1).bit_length() - 1
    cfg = model.config
    margin = torch.full((x.shape[0],), model.base_score)
    for s in range(t):
        one = tree_lib.Tree(*(a[s] for a in cpu))
        margin = margin + cfg.learning_rate * tree_lib.predict_raw(
            one, x, max_depth=cfg.max_depth)
    g, h = boosting.grad_hess(margin, y, cfg.objective)
    gh = torch.stack([g, h], 1)
    bins = binning.bin_features(x, model.candidates[min(
        t, model.candidates.shape[0] - 1)])
    node = torch.zeros(x.shape[0], dtype=torch.long)
    for d in range(depth):                 # the same ancestors on both sides
        heap = 2 ** d - 1 + node
        go_left = (torch.gather(bins, 1, cpu.feature[t][heap].clamp(min=0)
                                .long()[:, None])[:, 0]
                   <= cpu.split_bin[t][heap])
        node = 2 * node + (~go_left).long()
    at = torch.where(node == i - (2 ** depth - 1), 0, -1).to(torch.int32)
    kw = dict(l2=cfg.l2, gamma=cfg.gamma,
              min_child_weight=cfg.min_child_weight)
    out = {"tree": t, "equal": False, "heap_node": i, "depth": depth,
           "rows": int((at == 0).sum()),
           "card": [int(card.feature[t][i]), int(card.split_bin[t][i])],
           "cpu": [int(cpu.feature[t][i]), int(cpu.split_bin[t][i])]}
    nbins = model.candidates.shape[-1] + 1
    for name, panel in (
            ("row_order", ref.hist_ref(bins, at, gh, n_nodes=1,
                                       nbins=nbins)[0]),
            ("fixed_point", ref.hist_levels_fixed(bins, at[None], gh,
                                                  n_nodes=1,
                                                  nbins=nbins)[0, 0])):
        gains = split_gains64(panel, **kw)

        def gain(f, b):
            return 0.0 if f < 0 else float(gains[f, b])
        g_cpu, g_card = gain(*out["cpu"]), gain(*out["card"])
        out[f"gain_{name}"] = {"cpu_choice": g_cpu, "card_choice": g_card,
                               "gap": g_cpu - g_card}
    return out


def ties_case(n, f, seed):
    """Half-integer values (heavy ties), 5 % -0.0 and 5 % +0.0, 1 % NaN and
    1 % NaN with its sign bit set; uniform weights with 1 % zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, size=(n, f)) * 0.5).astype(np.float32)
    z = rng.random((n, f))
    x[z < 0.05] = -0.0
    x[(z >= 0.05) & (z < 0.1)] = 0.0
    nan = rng.random((n, f))
    x[nan < 0.01] = np.nan
    x[(nan >= 0.01) & (nan < 0.02)] = -np.float32(np.nan)
    h = rng.random(n).astype(np.float32)
    h[rng.random(n) < 0.01] = 0.0
    return x, h


def sort_stats(rows: torch.Tensor) -> dict:
    """Of sorted rows: those whose first value is NaN, and those whose
    zeros come as all -0.0 then all +0.0 (a stable sort that takes the two
    as equal keeps their input order instead)."""
    nan_first = grouped = 0
    for r in rows:
        nan_first += bool(torch.isnan(r[0]))
        sign = torch.signbit(r[r == 0]).to(torch.int8)
        grouped += bool((torch.diff(sign) <= 0).all())
    return {"rows_nan_first": nan_first,
            "rows_zeros_grouped_by_sign": grouped}


def grid_differences(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of two candidate grids that differ in their bits (so in the
    sign of a zero too), where not both NaN: IEEE leaves the sign and
    payload of a NaN that an operation returns open, and the card's
    column minimum returns another NaN than the CPU's."""
    both_nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~both_nan)
               .sum())


def logloss(margin, y) -> float:
    return float(torch.nn.functional.binary_cross_entropy_with_logits(
        margin, y))


# ---------------------------------------------------------------------------
# The distributed phases: what each rank runs (``launch.distributed.run``
# starts the ranks with ``spawn`` and pickles these functions by name).
# ---------------------------------------------------------------------------

DIST_CHECK = dict(rows=4000, features=6, n_trees=6, max_depth=4,
                  n_candidates=16)
DIST_WORLDS = (1, 3, 8)
DIST_SERVE_SHARDS = 2
EXAMPLE_WORKERS = 8


def _counters() -> tuple:
    from repro_torch.kernels import flash_attention as flash, hist, \
        split_gain, traverse
    return ((hist, "launches"), (hist, "left_launches"),
            (split_gain, "launches"), (traverse, "launches"),
            (traverse, "forest_launches"), (flash, "launches"))


def reset_counts() -> None:
    """Every launch count of the port to 0 (flash's by variant too)."""
    from repro_torch.kernels import flash_attention as flash
    for mod, name in _counters():
        setattr(mod, name, 0)
    for name in flash.launches_by_variant:
        flash.launches_by_variant[name] = 0
    flash.bwd_launches = 0
    for name in flash.bwd_launches_by_kernel:
        flash.bwd_launches_by_kernel[name] = 0


def read_counts() -> list:
    """[hist, hist_left, split_gain, traverse, forest_sum, flash]."""
    return [getattr(mod, name) for mod, name in _counters()]


def training_counts() -> dict:
    from repro_torch.kernels import hist, split_gain
    return {"hist_levels": hist.launches,
            "hist_levels_left": hist.left_launches,
            "split_gain": split_gain.launches}


def reset_training_counts() -> None:
    from repro_torch.kernels import hist, split_gain
    hist.launches = hist.left_launches = split_gain.launches = 0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, with a float32 NaN equal to a NaN of the same bits."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def per_rank(values: list) -> list:
    """Every rank's ``values`` (all int, or all float), in rank order."""
    from repro_torch.launch import distributed as dist_lib
    dtype = (torch.int64 if all(isinstance(v, int) for v in values)
             else torch.float64)
    t = torch.tensor(values, dtype=dtype, device="cuda")
    return [p.tolist() for p in dist_lib.all_gather(t)]


def dist_fit(x, y, cfg, *, seed=0):
    """One distributed fit with the launch counts reset just before it and
    read just after, and the bytes its collectives moved on this rank."""
    import torch.distributed as dist
    from repro_torch import fit_distributed
    from repro_torch.launch import distributed as dist_lib
    torch.cuda.synchronize()
    dist.barrier()
    reset_training_counts()
    before = dist_lib.collective_bytes
    t0 = time.perf_counter()
    model = fit_distributed(x, y, cfg, seed=seed, device="cuda")
    wall = time.perf_counter() - t0
    counts = training_counts()
    return model, dict(wall=wall, counts=counts,
                       bytes=dist_lib.collective_bytes - before)


def dist_check_rank() -> dict:
    """The 4000 x 6 uniform_range fits, direct and subtract (padded at 3
    ranks): the forests, and the launches of each rank."""
    from repro_torch import GBDTConfig
    rng = np.random.default_rng(0)
    c = DIST_CHECK
    xs = rng.normal(size=(c["rows"], c["features"])).astype(np.float32)
    ys = (xs @ rng.normal(size=c["features"]) > 0).astype(np.float32)
    out = {}
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=c["n_trees"], max_depth=c["max_depth"],
                         n_candidates=c["n_candidates"],
                         strategy="uniform_range", subtract=subtract)
        model, run = dist_fit(xs, ys, cfg)
        counts = run["counts"]
        mode = "hist_levels_left" if subtract else "hist_levels"
        out[subtract] = dict(
            forest=[a.cpu() for a in model.forest],
            launches=per_rank([counts[mode], counts["split_gain"],
                               sum(counts.values())]))
    return out


def dist_train_rank() -> dict:
    """The training cell on the ranks: uniform_range direct and subtract;
    at 8 ranks also random (twice from one seed) and weighted_quantile
    with telemetry, holdout accuracy on rank 0, and one round profiled on
    rank 0."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch import GBDTConfig, accuracy, fit_distributed
    from repro_torch.data import tabular
    from repro_torch.kernels import traverse
    world, rank = dist.get_world_size(), dist.get_rank()
    x, y = tabular.gaussian_classification(TRAIN_ROWS + HOLDOUT_ROWS,
                                           TRAIN_FEATURES, seed=0)
    x_tr = torch.from_numpy(x[:TRAIN_ROWS]).cuda()
    y_tr = torch.from_numpy(y[:TRAIN_ROWS]).cuda()
    x_ho = torch.from_numpy(x[TRAIN_ROWS:]).cuda()
    y_ho = torch.from_numpy(y[TRAIN_ROWS:]).cuda()
    base = GBDTConfig(n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
                      n_candidates=TRAIN_CANDIDATES)
    # warm-up: the allocator's first growth and the first launches
    fit_distributed(x_tr, y_tr, dc.replace(base, n_trees=1,
                                           strategy="uniform_range"),
                    device="cuda")
    runs = [("uniform_range", False, False), ("uniform_range", True, False)]
    if world == EXAMPLE_WORKERS:
        runs += [("random", False, True), ("random/again", False, True),
                 ("weighted_quantile", False, True)]
    out = {}
    for name, subtract, telemetry in runs:
        cfg = dc.replace(base, strategy=name.split("/")[0],
                         subtract=subtract, telemetry=telemetry)
        model, run = dist_fit(x_tr, y_tr, cfg, seed=0)
        mode = "hist_levels_left" if subtract else "hist_levels"
        row = dict(forest=[a.cpu() for a in model.forest],
                   fit_seconds=[v[0] for v in per_rank([model.fit_seconds])],
                   launches=per_rank([run["counts"][mode],
                                      run["counts"]["split_gain"],
                                      sum(run["counts"].values())]),
                   collective_bytes_per_round=run["bytes"] / cfg.n_trees)
        if telemetry:
            row["summary"] = model.report.summarize()
            row["estimate_bytes_per_round"] = float(
                (model.report.all_gather_bytes + model.report.psum_bytes)
                .double().mean())
        if rank == 0:
            traverse.forest_launches = 0
            row["holdout_accuracy"] = accuracy(model, x_ho, y_ho)
            row["holdout_forest_sum_launches"] = traverse.forest_launches
        out[f"{name}/{'subtract' if subtract else 'direct'}"] = row
    if world == EXAMPLE_WORKERS:
        out["profile"] = dist_profile(x_tr, y_tr, dc.replace(
            base, n_trees=2, strategy="random"))
    out["collective_ms"] = collective_ms()
    return out


def collective_ms(iters: int = 20) -> dict:
    """Host ms of one collective as a round calls it, alone: an all-reduce
    of the training panel's int64 sums (32 x 28 x 33 x 2) on the card and
    (gloo only) on the host, of one value, and an all-gather of a pool
    (28 x 32)."""
    import torch.distributed as dist
    from repro_torch.launch import distributed as dist_lib
    panel = TRAIN_NODES * TRAIN_FEATURES * TRAIN_BINS * 2
    cases = {"all_reduce_panel_int64_card": (dist_lib.all_reduce, torch.ones(
                 panel, dtype=torch.int64, device="cuda")),
             "all_reduce_one_int64_card": (dist_lib.all_reduce, torch.ones(
                 1, dtype=torch.int64, device="cuda")),
             "all_gather_pool_card": (dist_lib.all_gather, torch.ones(
                 TRAIN_FEATURES * TRAIN_CANDIDATES, device="cuda"))}
    if dist.get_backend() == "gloo":
        cases["all_reduce_panel_int64_host"] = (dist_lib.all_reduce,
                                                torch.ones(panel,
                                                           dtype=torch.int64))
    out = {}
    for name, (fn, t) in cases.items():
        for _ in range(3):
            fn(t)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(t)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


def dist_profile(x, y, cfg) -> dict | None:
    """Rounds of a random fit on every rank: wall ms a round (unprofiled),
    then rank 0's device time by kernel, its collectives' host time by op
    and its idle share (profiled)."""
    import torch.distributed as dist
    from repro_torch import fit_distributed
    _, run = dist_fit(x, y, cfg)
    wall_ms = run["wall"] / cfg.n_trees * 1e3
    torch.cuda.synchronize()
    dist.barrier()
    prof = None
    if dist.get_rank() == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    fit_distributed(x, y, cfg, device="cuda")
    torch.cuda.synchronize()
    if prof is None:
        return None
    prof.__exit__(None, None, None)
    rows = by_kernel(prof, cfg.n_trees, "round")
    busy_ms = sum(r["device_us_per_round"] for r in rows) / 1e3
    coll = [{"name": ev.key, "count": ev.count / cfg.n_trees,
             "host_us_per_round": ev.cpu_time_total / cfg.n_trees}
            for ev in prof.key_averages()
            if re.search(r"all_?reduce|all_?gather|broadcast|barrier",
                         ev.key, re.IGNORECASE)]
    coll.sort(key=lambda r: -r["host_us_per_round"])
    return dict(rounds=cfg.n_trees, wall_ms_per_round=wall_ms,
                device_ms_per_round=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                by_kernel=rows[:10], collectives=coll[:8])


def dist_serve_rank() -> dict:
    """``serve`` with ``data_shards`` on the serving cell, then every
    request's margins sharded against unsharded."""
    from repro_torch.kernels import traverse
    from repro_torch.launch import serve_gbdt
    model = serve_gbdt.synthetic_gbdt(
        n_trees=TREES, max_depth=DEPTH, n_features=FEATURES,
        n_candidates=CANDIDATES, seed=0, device="cuda")
    traverse.launches = traverse.forest_launches = 0
    report = serve_gbdt.serve(model, microbatch=MICROBATCH,
                              n_requests=REQUESTS,
                              data_shards=DIST_SERVE_SHARDS)
    launches = per_rank([traverse.forest_launches, traverse.launches])
    equal = []
    for xb in serve_gbdt.request_batches(model, microbatch=MICROBATCH,
                                         n_requests=REQUESTS, seed=0):
        got = serve_gbdt.shard_predict(model, xb, output="margin")
        want = model.predict(xb, output="margin")
        equal.append(same_bits(got, want) and got.shape == (MICROBATCH,)
                     and bool(torch.isfinite(got).all()))
    return dict(engine=report.engine, summary=report.summarize(),
                launches=launches, margins_equal=equal)


def dist_rank(tasks: tuple) -> dict:
    """The tasks of one start of the ranks, in order."""
    fns = {"check": dist_check_rank, "train": dist_train_rank}
    return {task: fns[task]() for task in tasks}


# ---------------------------------------------------------------------------
# the ssm and hybrid families (xlstm-125m, zamba2-2.7b)
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "xlstm-125m", "zamba2-2.7b"
VLM_ARCH, AUDIO_ARCH = "internvl2-1b", "whisper-tiny"
# vlm_check / audio_check: text tokens after the 256 patches (pallas:
# 512 in all) or beside the 1500 frames; the vlm's ragged causal case
CHECK_TEXT, RAGGED_TEXT = 256, 1000
# ssm_check / hybrid_check: 2 chunks of 256 tokens, then decode steps
RECURRENT_TOKENS, RECURRENT_STEPS = 512, 16
# the JAX package's chunked-vs-sequential tolerance (tests/test_ssm.py)
SSM_SEQ_TOL = {"rtol": 2e-2, "atol": 2e-3}
SSM_REQUESTS = 2
# xlstm's profiled request: 2 x 512 tokens (its sLSTM loop launches ~16
# kernels a token a layer, and the profiler takes minutes over 2 x 4096)
SSM_PROFILE_SEQ = 512
# long_500k: batch 1 at position 524 287; a recurrent arch has no window
LONG_LEN, LONG_WARMUP, LONG_STEPS = 524_288, 2, 5
# the card reorders every sum of every product, where ``rounded_blocks``
# rounds each block's input once: a float32 difference through the stack
# is held to this many times the CPU's response to the latter
NOISE_FACTOR = 4


def prompt_contract(phase: str, model, cfg, run) -> dict:
    """The decode path's logits at the prompt positions of ``run`` (a
    ``serve.generate``: the prompt once more through
    ``prefill_into_cache``, keeping every position's logits) against the
    card's own prefill step over the prompt, under the prefill's
    contract (``bf16_contract``, the prefill step in the CPU's place).  A
    vlm request is served without patches, so its prefill step takes an
    image of none."""
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch.steps import make_prefill_step
    s, gen = run.prompts.shape[1], run.tokens.shape[1]
    extra = {k: t for k, t in run.batch.items() if k != "tokens"}
    if cfg.family == "vlm":
        extra["patches"] = torch.zeros((run.prompts.shape[0], 0,
                                        cfg.d_model), device="cuda")
    prefill_logits = make_prefill_step(cfg)(
        model, {"tokens": run.prompts, **extra}).float().cpu()
    f32 = float32_logits(model, cfg, run.prompts, **extra)
    seen: list = []
    last, _, _ = serve_lm.prefill_into_cache(
        model, cfg, run.batch, s + gen, prompt_logits=seen)
    check(torch.equal(last, run.last_logits),
          f"{phase}: the prompt's second pass into a cache differs from the "
          "first")
    dec = torch.cat(seen, 1).float().cpu()
    return bf16_contract(phase, "prompt logits of the decode path", dec,
                         prefill_logits, f32, argmax=True)


def recurrent_check(phase: str, arch: str, n_layers: int, seed: int,
                    rng) -> dict:
    """``arch`` at full width with ``n_layers`` (2 groups), the card
    against the port on the CPU with the same weights, float32
    activations: the prefill over 1 x 512 tokens (2 chunks; zamba2's
    shared block through the flash kernel, ``attn_impl="pallas"``, once a
    group on the CUDA-core float32 kernel), each block from the CPU's
    input to it within 2e-4 abs and rel, the logits within 2e-4 or, where
    the model itself carries the roundings of its blocks further
    (``rounded_blocks``), within ``NOISE_FACTOR`` times that; the bf16 prefill step finite
    (once a group on the Hopper kernel);
    on the card the decode path over the same 512 tokens (the serving
    prefill, token by token) against the chunked prefill's logits within
    the JAX package's chunked-vs-sequential tolerance, every logit
    finite; then 16 decode steps from that state on both devices: every
    step's logits, the recurrent states and the KV caches as the prefill's
    logits, the same slots written."""
    from repro_torch.checkpoint import npz
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_decode_state, init_params
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              attn_impl="pallas")
    card = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    host = init_params(cfg, device="meta", dtype=torch.float32)
    host.load_state_dict({k: v.to("cpu", torch.float32) for k, v in
                          card.state_dict().items()}, assign=True,
                         strict=True)
    n, steps = RECURRENT_TOKENS, RECURRENT_STEPS
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=(1, n + steps)))
    prompt = tokens[:, :n]
    groups = n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    reset_counts()
    card_f32 = float32_logits(card, cfg, prompt)
    f32_launches = dict(flash.launches_by_variant)
    check(sum(read_counts()) == groups
          and f32_launches["cuda_core_f32"] == groups,
          f"{phase}: float32 prefill launches {read_counts()} "
          f"({f32_launches}), want {groups} on cuda_core_f32 and no other")
    host_f32 = float32_logits(host, cfg, prompt)
    # each block from the same input: the card's rounding alone
    block_err = per_block_check(phase, card, host, cfg, prompt)
    # through the stack the model carries each block's rounding further:
    # the CPU's logits again with every block's input moved by one
    # rounding step; where that passes 2e-4 the card is held within
    # NOISE_FACTOR times it
    with rounded_blocks():
        noise = float((float32_logits(host, cfg, prompt)
                       - host_f32).abs().max())
    ok, f32_err = within_f32(card_f32, host_f32)
    check((ok or f32_err <= NOISE_FACTOR * noise)
          and bool(torch.isfinite(card_f32).all()),
          f"{phase}: float32 prefill logits on the card differ from the "
          f"CPU's beyond {ATTN_F32_TOL} and beyond {NOISE_FACTOR} times the "
          f"model's own response to a rounding at each block ({noise}) "
          f"(max_abs_err="
          f"{f32_err}), or are not finite")
    reset_counts()
    bf16 = make_prefill_step(cfg)(card, {"tokens": prompt})
    torch.cuda.synchronize()
    bf16_launches = dict(flash.launches_by_variant)
    bf16_variant = flash.variant(torch.bfloat16, cfg.head_dim)
    check(bf16.shape == (1, n, cfg.vocab_size)
          and bool(torch.isfinite(bf16).all())
          and read_counts()[-1] == groups
          and bf16_launches[bf16_variant] == groups,
          f"{phase}: bf16 prefill {tuple(bf16.shape)}, not finite, or "
          f"launches {bf16_launches}, want {groups} on {bf16_variant}")
    del bf16
    # the serving prefill: the decode path over the prompt, on the card
    state = init_decode_state(cfg, 1, n + steps, device="cuda",
                              dtype=torch.float32)
    seq = torch.cat([float32_decode(card, cfg, state, prompt[:, t:t + 1],
                                    [t]) for t in range(n)], 1)
    seq_err = float((seq - card_f32).abs().max())
    check(bool(torch.isfinite(seq).all()) and torch.allclose(
              seq, card_f32, **SSM_SEQ_TOL),
          f"{phase}: the decode path's logits over the prompt differ from "
          f"the chunked prefill's beyond {SSM_SEQ_TOL} (max_abs_err="
          f"{seq_err}), or are not finite")
    # 16 steps from that state on both devices, and on the CPU once more
    # with every block's input moved by one rounding step (the noise)
    host_state, moved_state = (npz.decode_state_from_numpy(
        cfg, npz.decode_state_to_numpy(state), device="cpu")
        for _ in range(2))
    got, want, moved = [], [], []
    for t in range(n, n + steps):
        tok = tokens[:, t:t + 1]
        got.append(float32_decode(card, cfg, state, tok, [t]))
        want.append(float32_decode(host, cfg, host_state, tok, [t]))
        with rounded_blocks():
            moved.append(float32_decode(host, cfg, moved_state, tok, [t]))
    got, want, moved = (torch.cat(x, 1) for x in (got, want, moved))
    step_noise = float((moved - want).abs().max())
    ok, step_err = within_f32(got, want)
    check((ok or step_err <= NOISE_FACTOR * step_noise)
          and bool(torch.isfinite(got).all()),
          f"{phase}: {steps} decode steps: logits on the card differ from the "
          f"CPU's beyond {ATTN_F32_TOL} and {NOISE_FACTOR} x {step_noise} "
          f"(max_abs_err="
          f"{step_err})")
    state_err, state_noise = {}, {}
    want_state = npz.flat_state(host_state)
    moved = npz.flat_state(moved_state)
    for key, got in npz.flat_state(state).items():
        got, want = got.cpu(), want_state[key]
        ok, err = within_f32(got, want)
        state_err[key] = err
        state_noise[key] = float((moved[key] - want).abs().max())
        check((ok or err <= NOISE_FACTOR * state_noise[key])
              and torch.equal(got != 0, want != 0),
              f"{phase}: state {key} on the card differs from the CPU's "
              f"beyond {ATTN_F32_TOL} and {NOISE_FACTOR} x {state_noise[key]} "
              f"(max_abs_err={err}) or writes other slots")
    out = dict(arch=arch, n_layers=n_layers, tokens=[1, n],
               decode_steps=steps, weights=f"random bf16, seed {seed}",
               flash_launches_f32=f32_launches,
               flash_launches_bf16=bf16_launches,
               f32_logits_max_abs_err=f32_err,
               f32_tolerance={"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL,
                              "or_max_abs": NOISE_FACTOR * noise},
               block_max_abs_err=block_err,
               cpu_response_to_block_rounding=noise,
               decode_vs_prefill_max_abs_err=seq_err,
               decode_vs_prefill_tolerance=SSM_SEQ_TOL,
               step_logits_max_abs_err=step_err,
               step_cpu_response_to_block_rounding=step_noise,
               state_max_abs_err=state_err,
               state_cpu_response_to_block_rounding=state_noise,
               all_finite=True, seconds=time.perf_counter() - t_phase)
    emit(phase, **out)
    del card, host, state, host_state
    torch.cuda.empty_cache()
    return out


def bf16_contract(phase: str, what: str, card, host, host_f32, *,
                  argmax: bool = False) -> dict:
    """The card's bf16 result against the CPU's under the prefill's
    contract: each side against the CPU's float32 result, the card's
    error at most 1.25 times the CPU's, the two within twice it; for
    logits (``argmax``) the argmax of the two differing only at near ties
    (a gap in the float32 logits within that bound)."""
    card, host, host_f32 = card.float(), host.float(), host_f32.float()
    cpu_err = float((host - host_f32).abs().max())
    card_err = float((card - host_f32).abs().max())
    diff = float((card - host).abs().max())
    check(bool(torch.isfinite(card).all()) and diff <= 2 * cpu_err
          and card_err <= 1.25 * cpu_err,
          f"{phase}: bf16 {what} on the card {diff} from the CPU's (bound "
          f"{2 * cpu_err}: twice the CPU's own bf16 error against its "
          f"float32 result); the card's error {card_err} (bound "
          f"{1.25 * cpu_err}), or not finite")
    out = {"max_abs_err": diff, "bound": 2 * cpu_err,
           "card_err_vs_f32": card_err, "cpu_err_vs_f32": cpu_err}
    if argmax:
        agree, differ, _ = argmax_agreement(card, host)
        _, _, gap_f32 = argmax_agreement(card, host_f32)
        tie_gap = float(gap_f32[differ].abs().max()) if bool(differ.any()) \
            else 0.0
        check(tie_gap <= 2 * cpu_err, f"{phase}: an argmax of the {what} "
              f"differs beyond a near tie ({tie_gap}, agreement {agree})")
        out.update(argmax_agreement=agree,
                   argmax_agreement_vs_f32={
                       "card": argmax_agreement(card, host_f32)[0],
                       "cpu": argmax_agreement(host, host_f32)[0]},
                   max_argmax_tie_gap_f32=tie_gap)
    return out


def prefill_check(phase: str, arch: str, seed: int, rng) -> dict:
    """The prefill step at full width, the card against the port on the
    CPU with the same weights (the CPU's a float32 copy of the card's bf16
    weights: each product rounds them to the activations' dtype, so its
    bf16 run is the bf16 model's): glm4-9b or internvl2-1b with 2 layers
    over ``CHECK_TEXT`` tokens (``pallas``; internvl2-1b's 256 seeded
    patches before them), whisper-tiny at full depth over 1500 seeded
    frames (``xla_chunked``: the encoder and the cross-attention
    blockwise, K/V padded to 1536 and bounded by ``kv_len``).  float32
    logits within 2e-4; the bf16 prefill step under ``bf16_contract``;
    the flash launches of each (the bf16 step on the Hopper kernel,
    float32 on the CUDA-core one), none on the CPU.  glm4-9b and
    internvl2-1b also at a ragged causal length (``RAGGED_TEXT`` text
    tokens through ``xla_chunked``: 1000 padded to 1024, 256 + 1000 to
    1280), float32 within 2e-4; whisper-tiny also the encoder's output
    and the cross K/V in float32 within 2e-4, and the bf16 cross K/V
    cache that ``serve.prefill_into_cache`` fills under
    ``bf16_contract``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if cfg.family != "audio":
        cfg = dataclasses.replace(cfg, n_layers=2, attn_impl="pallas")
    card = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    host = init_params(cfg, device="meta", dtype=torch.float32)
    host.load_state_dict({k: v.to("cpu", torch.float32) for k, v in
                          card.state_dict().items()}, assign=True,
                         strict=True)
    tokens = rng.integers(0, cfg.vocab_size, size=(1, CHECK_TEXT))
    extra = frontend(cfg, 1, seed)
    host_extra = {k: t.cpu() for k, t in extra.items()}
    launches = flash_per_request(cfg)
    if cfg.family == "audio":       # the decoder's 256 x 256: naive
        launches -= cfg.n_layers
    step = make_prefill_step(cfg)
    reset_counts()
    card_bf16 = step(card, {"tokens": tokens, **extra}).float().cpu()
    bf16_launches = dict(flash.launches_by_variant)
    reset_counts()
    card_f32 = float32_logits(card, cfg, tokens, **extra)
    f32_launches = dict(flash.launches_by_variant)
    check(bf16_launches == {"wgmma_bf16": launches, "cuda_core_f32": 0}
          and f32_launches == {"wgmma_bf16": 0, "cuda_core_f32": launches},
          f"{phase}: flash launches bf16 {bf16_launches}, float32 "
          f"{f32_launches}, want {launches} each on its kernel")
    ragged_cfg = dataclasses.replace(cfg, attn_impl="xla_chunked")
    if cfg.family != "audio":
        ragged = rng.integers(0, cfg.vocab_size, size=(1, RAGGED_TEXT))
        reset_counts()
        card_ragged = float32_logits(card, ragged_cfg, ragged, **extra)
        ragged_launches = dict(flash.launches_by_variant)
    card_total = flash.launches
    t_cpu = time.perf_counter()
    host_f32 = float32_logits(host, cfg, tokens, **host_extra)
    host_bf16 = step(host, {"tokens": tokens, **host_extra}).float()
    if cfg.family != "audio":
        host_ragged = float32_logits(host, ragged_cfg, ragged, **host_extra)
    cpu_seconds = time.perf_counter() - t_cpu
    check(flash.launches == card_total,
          f"{phase}: the CPU run launched the flash kernel")
    ok, f32_err = within_f32(card_f32, host_f32)
    check(ok and bool(torch.isfinite(card_f32).all()),
          f"{phase}: float32 logits on the card differ from the CPU's "
          f"beyond {ATTN_F32_TOL} (max_abs_err={f32_err})")
    logits = bf16_contract(phase, "logits", card_bf16, host_bf16, host_f32,
                           argmax=True)
    out = dict(arch=arch, n_layers=cfg.n_layers, attn_impl=cfg.attn_impl,
               tokens=list(tokens.shape),
               frontend={k: list(t.shape) for k, t in extra.items()},
               weights=f"random bf16, seed {seed}",
               flash_launches_bf16=bf16_launches,
               flash_launches_f32=f32_launches,
               f32_logits_max_abs_err=f32_err,
               f32_tolerance={"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
               bf16_logits=logits, cpu_seconds=cpu_seconds)
    if cfg.family != "audio":
        n_front = sum(t.shape[1] for t in extra.values())
        ok, ragged_err = within_f32(card_ragged, host_ragged)
        check(ok and card_ragged.shape[1] == RAGGED_TEXT
              and ragged_launches == {"wgmma_bf16": 0,
                                      "cuda_core_f32": cfg.n_layers},
              f"{phase} ({n_front} + {RAGGED_TEXT} tokens, xla_chunked): "
              f"float32 logits {ragged_err} from the CPU's, or launches "
              f"{ragged_launches}, want {cfg.n_layers} on cuda_core_f32")
        out["ragged"] = {"tokens": [1, n_front + RAGGED_TEXT],
                         "padded_to": -(-(n_front + RAGGED_TEXT) // 128)
                         * 128, "attn_impl": ragged_cfg.attn_impl,
                         "flash_launches": ragged_launches,
                         "f32_logits_max_abs_err": ragged_err}
    else:
        with torch.inference_mode():
            enc = {dev: m.encode_audio(cfg, x["frames"], dtype=torch.float32)
                   for dev, m, x in (("cuda", card, extra),
                                     ("cpu", host, host_extra))}
            cross = {dev: torch.stack([torch.stack([
                blk.attn.wk(enc[dev]), blk.attn.wv(enc[dev])])
                for blk in m.cross_layers]).cpu()
                for dev, m in (("cuda", card), ("cpu", host))}
        ok, enc_err = within_f32(enc["cuda"], enc["cpu"])
        ok_kv, kv_err = within_f32(cross["cuda"], cross["cpu"])
        check(ok and ok_kv, f"{phase}: float32 encoder output {enc_err} or "
              f"cross K/V {kv_err} on the card from the CPU's, beyond "
              f"{ATTN_F32_TOL}")
        prompt = {"tokens": tokens[:, :8]}
        caches = {dev: serve_lm.prefill_into_cache(
            m, cfg, {**prompt, **x}, 8)[1] for dev, m, x in
            (("cuda", card, extra), ("cpu", host, host_extra))}
        f32_kv = cross["cpu"].reshape(cfg.n_layers, 2, *caches["cpu"][
            "cross_k"].shape[1:])
        cache = {name: bf16_contract(
            phase, name, caches["cuda"][name].cpu(), caches["cpu"][name],
            f32_kv[:, i]) for i, name in enumerate(("cross_k", "cross_v"))}
        out.update(encoder_f32_max_abs_err=enc_err,
                   cross_kv_f32_max_abs_err=kv_err,
                   cross_kv_cache_bf16=cache)
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase, **out)
    del card, host
    torch.cuda.empty_cache()
    return out


def serve_phase(phase: str, arch: str):
    """``serve.generate(arch, smoke=False)`` with decode's arguments, at
    full width and depth: the prefill-into-cache seconds, each step's ms,
    tokens/s, peak memory, no launch of a kernel of the port but the audio
    encoder's flash launches (one an encoder layer, all ``wgmma_bf16``,
    at 1500 frames padded to 1536), the prompt contract, one profiled
    step's device time and idle share.  Returns (the run, the launch
    counts)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve as serve_lm
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = serve_lm.generate(arch, smoke=False, **DECODE)
    torch.cuda.synchronize()
    counts = read_counts()
    by_variant = dict(flash.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    cfg, model = run.cfg, run.model
    b, s, gen = DECODE["batch"], DECODE["prompt_len"], DECODE["gen"]
    want = (cfg.n_encoder_layers if cfg.family == "audio" else 0)
    check(counts[-1] == want == by_variant["wgmma_bf16"]
          and sum(counts[:-1]) == 0 and run.tokens.shape == (b, gen)
          and run.last_logits.shape == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(run.last_logits).all())
          and torch.equal(run.tokens[:, 0],
                          run.last_logits[:, -1].argmax(-1)),
          f"{phase}: tokens {tuple(run.tokens.shape)}, last logits not "
          f"finite or not the first token's, or kernels of the port "
          f"launched: {counts} ({by_variant}), want {want} flash launches")
    contract = prompt_contract(phase, model, cfg, run)
    busy, ops = serve_step_profile(model, cfg, b, s + gen, s)
    emit(phase, arch=arch, n_layers=cfg.n_layers,
         params=sum(p.numel() for p in model.parameters()), **DECODE,
         cache_len=s + gen, weights="random bf16, seed 0",
         prefill_into_cache_seconds=run.prefill_seconds,
         step_ms=[t * 1e3 for t in run.step_seconds],
         step_p50_ms=run.step_p50_ms, tokens_per_s=run.tokens_per_s,
         device_ms_per_step=busy,
         device_idle_share=1 - busy / run.step_p50_ms, by_op=ops,
         max_memory_allocated_gb=peak / 1e9, flash_launches=counts[-1],
         flash_launches_by_variant=by_variant,
         frames=list(run.batch["frames"].shape) if "frames" in run.batch
         else None,
         tokens=run.tokens.tolist(), prompt_logits_vs_prefill=contract,
         seconds=time.perf_counter() - t_phase)
    return run, counts


def flash_per_request(cfg) -> int:
    """The prefill's flash launches a request: one a shared-block group
    (hybrid), one an attention layer (vlm), one an encoder layer, decoder
    layer and cross-attention block (audio), none in the ssm family."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def frontend(cfg, batch: int, seed: int) -> dict:
    """The stub frontend's input of a request, seeded bf16 on the card:
    ``patches`` (vlm) or ``frames`` (audio), (batch, n_frontend_tokens,
    d_model); nothing in the other families."""
    name = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if name is None:
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                              generator=gen, device="cuda").bfloat16()}


def prefill_phase(phase: str, model, cfg, rng, *, labels, variant) -> dict:
    """``make_prefill_step`` at full width and depth: one warm-up, then
    ``LM_REQUESTS`` (zamba2, internvl2-1b, whisper-tiny) or
    ``SSM_REQUESTS`` (xlstm) requests of 2 x 4096 text tokens (with 256
    seeded patches before them, or 1500 seeded frames): p50 ms, tokens/s,
    peak memory, the flash launches (``flash_per_request``, all on
    ``variant``; none in the ssm family); one request's device time by
    group (``labels``: the ``record_function`` ranges around ``ssm``
    functions or the audio encoder, beside flash, GEMMs and the rest), the
    labels' host ms, the idle share (xlstm's request profiled at
    ``SSM_PROFILE_SEQ`` tokens a row, against an unprofiled request of
    that length).  The timed requests also count the flash launches made
    inside each label's function (whisper's: 4 a request in the encoder, 4
    in the cross-attention blocks, the rest in the decoder's
    self-attention).  Returns the flash launches of the timed requests
    (``variant`` None: there must be none): in all, a request and by
    label."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.steps import make_prefill_step
    t_phase = time.perf_counter()
    requests = SSM_REQUESTS if cfg.family == "ssm" else LM_REQUESTS
    per_request = flash_per_request(cfg)
    step = make_prefill_step(cfg)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       size=(LM_BATCH, LM_SEQ)),
                **frontend(cfg, LM_BATCH, 9 + i)}
               for i in range(requests + 1)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits = step(model, batches[0])                          # warm-up
    torch.cuda.synchronize()
    del logits
    walls = []
    names = [label for *_, label in labels]
    by_label = dict.fromkeys(names, 0)
    reset_counts()
    with labelled(labels, launches=by_label):
        for batch in batches[1:]:
            t0 = time.perf_counter()
            logits = step(model, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(logits.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
                  and logits.dtype == torch.bfloat16
                  and bool(torch.isfinite(logits).all()),
                  f"{phase} logits {tuple(logits.shape)} {logits.dtype}, or "
                  "not finite")
            del logits
    counts = read_counts()
    by_variant = dict(flash.launches_by_variant)
    check(counts[-1] == per_request * requests
          and (variant is None or by_variant[variant] == counts[-1])
          and sum(counts[:-1]) == 0,
          f"{phase}: {counts[-1]} flash launches for {requests} requests "
          f"({by_variant}), want {per_request} a request, all {variant}, "
          "and no other kernel")
    if cfg.family == "audio":
        want = {"audio_encoder": cfg.n_encoder_layers * requests,
                "cross_attention": cfg.n_layers * requests}
        check(by_label == want, f"{phase}: flash launches by label "
              f"{by_label}, want {want}")
        by_label["decoder_self_attention"] = counts[-1] - sum(
            by_label.values())
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(walls))
    profiled = dict(batches[1], tokens=batches[1]["tokens"][
        :, :SSM_PROFILE_SEQ if cfg.family == "ssm" else LM_SEQ])
    t0 = time.perf_counter()
    logits = step(model, profiled)
    torch.cuda.synchronize()
    profiled_wall = time.perf_counter() - t0
    with labelled(labels), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits = step(model, profiled)
        torch.cuda.synchronize()
    del logits
    groups, busy = device_ms_by_group(prof, names)
    host_ms = {ev.key: ev.cpu_time_total / 1e3 for ev in prof.key_averages()
               if ev.key in names
               and ev.device_type == torch.autograd.DeviceType.CPU}
    emit(phase, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_heads=cfg.n_heads, head_dim=cfg.head_dim,
         vocab_size=cfg.vocab_size,
         params=sum(p.numel() for p in model.parameters()),
         weights_gb=lm_bytes(model) / 1e9, batch=LM_BATCH, seq=LM_SEQ,
         frontend={k: list(t.shape) for k, t in batches[1].items()
                   if k != "tokens"},
         reduced=["shape: prefill_32k 32 x 32768 -> 2 x 4096 tokens"],
         requests=requests, warmup_requests=1,
         request_ms=[w * 1e3 for w in walls], p50_ms=p50 * 1e3,
         tokens_per_s=LM_BATCH * LM_SEQ * len(walls) / sum(walls),
         max_memory_allocated_gb=peak / 1e9, flash_launches=counts[-1],
         flash_launches_per_request=counts[-1] / requests,
         flash_launches_by_variant=by_variant,
         flash_launches_by_label=by_label,
         profiled_tokens=list(profiled["tokens"].shape),
         profiled_wall_ms=profiled_wall * 1e3, device_ms_per_request=busy,
         device_idle_share=1 - busy / (profiled_wall * 1e3),
         by_group_ms=groups, by_group_share=shares(groups, busy),
         label_host_ms=host_ms,
         by_op=by_kernel(prof, 1, "request", ops=True)[:12],
         seconds=time.perf_counter() - t_phase)
    return {"launches": counts[-1], "per_request": counts[-1] / requests,
            "by_label": by_label}


def long_phase(model, cfg) -> None:
    """The serve step at the dry-run's ``long_500k`` for the hybrid
    family: batch 1 at position 524 287 of a 524 288-slot cache a group
    (a recurrent arch takes no window), the caches seeded bf16 and the
    Mamba states seeded float32; the slots halved until the reckoned
    peak fits the card (each cut listed); 2 warm-up and 5 timed steps:
    p50, peak, the bytes bound (weights and state read once), one
    profiled step's device time by group and idle share."""
    from repro_torch.checkpoint import npz
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import attention as attn_lib, init_decode_state
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w_bytes = lm_bytes(model)
    capacity = torch.cuda.get_device_properties(0).total_memory

    def reckon(length):
        """(state bytes, peak bytes): the weights, the state, and the
        plain decode attention's float32 K and V of one group."""
        shapes = init_decode_state(cfg, 1, length, device="meta")
        st = sum(t.numel() * t.element_size()
                 for t in npz.flat_state(shapes).values())
        kv_f32 = 2 * length * cfg.n_kv_heads * cfg.head_dim * 4
        return st, w_bytes + st + kv_f32

    length, reduced = LONG_LEN, []
    while reckon(length)[1] > 0.95 * capacity:
        reduced.append(f"cache: {length} -> {length // 2} slots")
        length //= 2
    state_bytes, predicted = reckon(length)
    state = init_decode_state(cfg, 1, length, device="cuda")
    fill = torch.Generator(device="cuda").manual_seed(6)
    for t in (*state["kv"].values(), state["mamba"]):
        t.normal_(generator=fill)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1), generator=fill,
                           device="cuda")
    pos = torch.full((1,), length - 1, device="cuda")
    serve_step = make_serve_step(cfg)
    walls = []
    reset_counts()
    for i in range(LONG_WARMUP + LONG_STEPS):
        t0 = time.perf_counter()
        logits, state = serve_step(model, state, tokens, pos)
        torch.cuda.synchronize()
        if i >= LONG_WARMUP:
            walls.append(time.perf_counter() - t0)
    counts = read_counts()
    check(sum(counts) == 0 and logits.shape == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"hybrid_long: logits {tuple(logits.shape)} or not finite, or "
          f"kernels of the port launched: {counts}")
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(walls))
    with labelled([(attn_lib, "decode_attend", "decode_attention")]), \
            torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits, state = serve_step(model, state, tokens, pos)
        torch.cuda.synchronize()
    groups, busy = device_ms_by_group(prof, ["decode_attention"])
    bound = (w_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    emit("hybrid_long", arch=cfg.name, n_layers=cfg.n_layers, batch=1,
         cache_len=length, pos=length - 1,
         state="random: bf16 caches, float32 Mamba states, seed 6",
         reduced=reduced, warmup_steps=LONG_WARMUP, steps=LONG_STEPS,
         weights_gb=w_bytes / 1e9, state_gb=state_bytes / 1e9,
         reckoned_peak_gb=predicted / 1e9,
         max_memory_allocated_gb=peak / 1e9,
         step_ms=[w * 1e3 for w in walls], step_p50_ms=p50 * 1e3,
         bytes_bound_ms=bound, share_of_bound=bound / (p50 * 1e3),
         device_ms_per_step=busy, device_idle_share=1 - busy / (p50 * 1e3),
         by_group_ms=groups, by_group_share=shares(groups, busy),
         by_op=by_kernel(prof, 1, "step", ops=True)[:10],
         seconds=time.perf_counter() - t_phase)
    del state, logits, prof
    torch.cuda.empty_cache()


def attn_bwd_bound_ms(b, hq, hkv, sq, sk, d, itemsize, causal) -> tuple:
    """The backward's least time: the unmasked (query, key) pairs at five
    products of 2d operations each (2.5 times the forward's 4d) over the
    dtype's peak rate, against q, o, do and k, v read once and dq, dk, dv
    written once over the HBM rate."""
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * sk)
    rate = BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S
    t_ops = pairs * 10 * d / rate * 1e3
    nbytes = itemsize * d * (4 * b * hq * sq + 4 * b * hkv * sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_within(got, want, bound, dtype) -> tuple[bool, float, float]:
    """The backward kernel's (dq, dk, dv) against the plain version's:
    float32 within 2e-4 of max(1, max|want|) (sums in other orders, the
    SFU's exp); bf16 within that plus one bf16 step of the value plus
    ``bound`` (``ref.attention_bwd_rounding_bound``: P and dS rounded to
    bf16 as operands).  Returns (within, max abs error, largest share of
    the tolerance used)."""
    ok, err, share = True, 0.0, 0.0
    for g, w, bd in zip(got, want, bound):
        w = w.float()
        tol = ATTN_F32_TOL * max(1.0, float(w.abs().max()))
        if dtype == torch.bfloat16:
            tol = tol + BF16_STEP * w.abs() + bd
        diff = (g.float() - w).abs()
        ok &= bool((diff <= tol).all())
        err = max(err, float(diff.max()))
        share = max(share, float((diff / tol).max()))
    return ok, err, share


def attn_bwd_check(gen) -> dict:
    """Phase attn_bwd_check: the backward kernel against its plain version
    over the sweep; the bf16 forward's lse against ``ref.attention_lse``
    and the backward given it; groups split among the dK/dV work items and
    not; returns the worst error and share by variant."""
    from repro_torch.kernels import flash_attention as flash, ops, ref
    t_phase = time.perf_counter()
    cases = [(1, 4, 4, 128, 128, True, 0, None),
             (2, 16, 2, 256, 256, True, 0, None),
             (1, 7, 1, 384, 384, True, 100, None),
             (1, 16, 2, 256, 384, False, 0, 300),
             (1, 16, 2, 256, 256, False, 0, None),
             (1, 4, 2, 384, 384, True, 50, 200),
             (1, 2, 2, 128, 1536, False, 0, 1500),
             (1, 4, 4, 256, 256, False, 70, None)]
    worst = {v: {"max_abs_err": 0.0, "share_of_tolerance": 0.0}
             for v in flash.BWD_VARIANTS}
    n, repeat, before = 0, True, flash.bwd_launches
    lse_worst = {"max_abs_err": 0.0, "share_of_tolerance": 0.0,
                 "inf_rows": 0, "cases": 0}

    def one(q, k, v, o, do, **mask):
        nonlocal n, repeat
        got = flash.flash_attention_bwd_cuda(q, k, v, o, do, **mask)
        torch.cuda.synchronize()
        want = ref.attention_bwd_ref(q, k, v, o, do, **mask)
        bound = ref.attention_bwd_rounding_bound(q, k, v, o, do, **mask)
        ok, err, share = bwd_within(got, want, bound, q.dtype)
        again = flash.flash_attention_bwd_cuda(q, k, v, o, do, **mask)
        repeat &= all(torch.equal(a, b) for a, b in zip(got, again))
        w = worst[flash.bwd_variant(q.dtype)]
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["share_of_tolerance"] = max(w["share_of_tolerance"], share)
        n += 1
        check(ok, f"attention backward off its plain version: q "
              f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype} {mask}, "
              f"max_abs_err {err}, share of tolerance {share}")
        return err, share

    def lse_case(q, k, v, o, do, mask):
        """The lse the forward writes (training's path): the output the
        same bits as without it, lse within 2e-4 of max(1, |want|) of
        ``ref.attention_lse`` with its +inf rows equal, and the backward
        given it the same bits as the backward that gets it itself."""
        o_lse, lse = flash.flash_attention_cuda(q, k, v, with_lse=True,
                                                **mask)
        want = ref.attention_lse(q, k, **mask)
        inf = torch.isinf(want)
        check(torch.equal(o_lse, o), f"the forward with lse gave another "
              f"output: {tuple(q.shape)} {mask}")
        check(torch.equal(torch.isinf(lse), inf) and bool(
            (lse[inf] > 0).all()), f"the forward's lse is not +inf on the "
              f"rows that keep no key: {tuple(q.shape)} {mask}")
        if (~inf).any():
            diff = (lse[~inf] - want[~inf]).abs()
            share = float((diff / (ATTN_F32_TOL * want[~inf].abs().clamp(
                min=1.0))).max())
            check(share <= 1, f"the forward's lse off ref.attention_lse: "
                  f"{tuple(q.shape)} {mask}, {float(diff.max())}")
            lse_worst["max_abs_err"] = max(lse_worst["max_abs_err"],
                                           float(diff.max()))
            lse_worst["share_of_tolerance"] = max(
                lse_worst["share_of_tolerance"], share)
        lse_worst["inf_rows"] += int(inf.sum())
        lse_worst["cases"] += 1
        a = flash.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **mask)
        b = flash.flash_attention_bwd_cuda(q, k, v, o, do, **mask)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"the backward given the forward's lse differs from the one "
              f"that gets it itself: {tuple(q.shape)} {mask}")

    for b, hq, hkv, sq, sk, causal, window, kv_len in cases:
        for d in (32, 64, 80, 128):
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((b, hq, sq, d), generator=gen,
                                device="cuda").to(dtype)
                k, v = (torch.randn((b, hkv, sk, d), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                mask = dict(causal=causal, window=window, kv_len=kv_len)
                o = flash.flash_attention_cuda(q, k, v, **mask)
                do = torch.randn(o.shape, generator=gen,
                                 device="cuda").to(dtype)
                one(q, k, v, o, do, **mask)
                if dtype == torch.bfloat16:
                    lse_case(q, k, v, o, do, mask)
    # the moe prefill's shape (MHA 16:16, d 128), bf16
    q, k, v = (torch.randn((2, 16, 4096, 128), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    o = flash.flash_attention_cuda(q, k, v, causal=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
    moe_err, moe_share = one(q, k, v, o, do, causal=True)
    del q, k, v, o, do
    # groups split among the dK/dV work items (7:1, 16:2, their sums
    # added by bwd_dkdv_sum) and not (MHA), causal bf16, given the
    # forward's lse: each against the plain version, twice the same bits
    groups = {}
    sms = flash.sm_count(torch.device("cuda"))
    for hq, hkv, s, d in ((7, 1, 1024, 64), (16, 2, 1024, 128),
                          (4, 4, 512, 80)):
        q = torch.randn((1, hq, s, d), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((1, hkv, s, d), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        o, lse = flash.flash_attention_cuda(q, k, v, causal=True,
                                            with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
        counts = dict(flash.bwd_launches_by_kernel)
        got = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                             lse=lse)
        launched = {name: flash.bwd_launches_by_kernel[name] - counts[name]
                    for name in counts
                    if flash.bwd_launches_by_kernel[name] != counts[name]}
        ran = flash.bwd_kernels(q.dtype, 1, hq, hkv, s, sms)
        check(launched == dict.fromkeys(ran, 1),
              f"a {hq}:{hkv} backward call launched {launched}")
        want = ref.attention_bwd_ref(q, k, v, o, do, causal=True)
        bound = ref.attention_bwd_rounding_bound(q, k, v, o, do,
                                                 causal=True)
        ok, err, share = bwd_within(got, want, bound, q.dtype)
        check(ok, f"a {hq}:{hkv} backward off its plain version: {err}")
        again = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                               lse=lse)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(same, f"a {hq}:{hkv} backward gave other bits on a second "
              f"call")
        heads = flash.dkdv_heads_per_chunk(1, hq, hkv, s, sms)
        groups[f"{hq}:{hkv}"] = dict(
            q=[1, hq, s, d], heads_per_chunk=heads,
            chunks=-(-(hq // hkv) // heads), kernels=launched,
            max_abs_err=err, share_of_tolerance=share, deterministic=same)
        del q, k, v, o, do, lse, got, again, want, bound
    # ragged lengths through ops.flash_attention under autograd: padded to
    # multiples of 128 outside the autograd function
    ragged = {}
    for sk, causal in ((1000, True), (1500, False)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((1, 8, 1000, 64), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((1, 2, sk, 64), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ops.flash_attention(*leaves, causal=causal, ragged=True)
            out.backward(do)
            o = out.detach()
            want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal)
            bound = ref.attention_bwd_rounding_bound(q, k, v, o, do,
                                                     causal=causal)
            ok, err, share = bwd_within([t.grad for t in leaves], want,
                                        bound, dtype)
            check(ok, f"ragged backward (q 1000, k/v {sk}, causal "
                  f"{causal}, {dtype}) off its plain version: {err}")
            ragged[f"q1000_kv{sk}_{'causal' if causal else 'no_mask'}_"
                   f"{str(dtype)[6:]}"] = dict(max_abs_err=err,
                                                share_of_tolerance=share)
    check(repeat, "the attention backward gave other bits on a second call")
    out = dict(cases=n, within_tolerance=True, deterministic=repeat,
               tolerance={"f32": "2e-4 * max(1, max|want|)",
                          "bf16": "2e-4 * max(1, max|want|) + 2^-7 |want| "
                                  "+ ref.attention_bwd_rounding_bound"},
               by_variant=worst, ragged=ragged,
               forward_lse=dict(lse_worst, tolerance="2e-4 * max(1, |want|)",
                                against="ref.attention_lse"),
               groups=groups,
               moe_shape=dict(q=[2, 16, 4096, 128], max_abs_err=moe_err,
                              share_of_tolerance=moe_share),
               bwd_launches=flash.bwd_launches - before,
               seconds=time.perf_counter() - t_phase)
    emit("attn_bwd_check", **out)
    return out


def attn_bwd_time(gen, name: str, shape: tuple, registers: dict) -> dict:
    """Phase attn_bwd_time at one training shape, causal bf16, given the
    forward's lse as the training step gives it."""
    from repro_torch.kernels import flash_attention as flash, ref
    t_phase = time.perf_counter()
    b, hq, hkv, s, d = shape
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    o, lse = flash.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
    before = dict(flash.bwd_launches_by_kernel)
    calls = flash.bwd_launches
    got = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                         lse=lse)
    per_call = {n: flash.bwd_launches_by_kernel[n] - before[n]
                for n in before if flash.bwd_launches_by_kernel[n]
                != before[n]}
    sms = flash.sm_count(q.device)
    ran = flash.bwd_kernels(q.dtype, b, hq, hkv, s, sms)
    check(flash.bwd_launches - calls == 1 and per_call
          == dict.fromkeys(ran, 1), f"a backward call launched {per_call}")
    want = ref.attention_bwd_ref(q, k, v, o, do, causal=True)
    bound = ref.attention_bwd_rounding_bound(q, k, v, o, do, causal=True)
    ok, err, share = bwd_within(got, want, bound, torch.bfloat16)
    check(ok, f"attention backward at {name}'s shape off its plain "
          f"version: {err}")
    del want, bound
    again = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                           lse=lse)
    repeat = all(torch.equal(x, y) for x, y in zip(got, again))
    del got, again
    ms, issue_ms = cuda_ms(lambda: flash.flash_attention_bwd_cuda(
        q, k, v, o, do, causal=True, lse=lse), iters=10, warmup=2)
    forward_ms, _ = cuda_ms(lambda: flash.flash_attention_cuda(
        q, k, v, causal=True), iters=10, warmup=2)
    plain_ms, _ = cuda_ms(lambda: ref.attention_bwd_ref(
        q, k, v, o, do, causal=True), iters=2, warmup=1)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=hq != hkv)
    library_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), iters=10, warmup=2)
    del out, leaves
    bound_ms, bound_by = attn_bwd_bound_ms(b, hq, hkv, s, s, d, 2, True)
    flops = b * hq * (s * (s + 1) // 2) * 10 * d
    res = dict(ms=ms, issue_ms=issue_ms, forward_ms=forward_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms,
               library_over_kernel=library_ms / ms,
               tflops=flops / (ms * 1e-3) / 1e12, gflop=flops / 1e9,
               max_abs_err=err, share_of_tolerance=share,
               deterministic=repeat, launches_per_call=per_call,
               heads_per_chunk=flash.dkdv_heads_per_chunk(b, hq, hkv, s,
                                                          sms),
               registers={n: registers.get(f"{n}_d{d}",
                                           registers.get(n))
                          for n in ran})
    emit("attn_bwd_time", kernel="flash_attention_bwd",
         variant=flash.bwd_variant(q.dtype), name=name,
         shape=dict(q=list(q.shape), kv=list(k.shape), causal=True,
                    dtype="bfloat16"), **res,
         bound_peak_tflops=BF16_OPS_PER_S / 1e12,
         seconds=time.perf_counter() - t_phase)
    return res


def train_state_on(device, cfg, opt, seed: int):
    """A train state from float32 weights drawn on the CPU from ``seed``,
    moved to ``device``: the same weights on every device."""
    from repro_torch.launch.steps import init_train_state
    model, state = init_train_state(cfg, torch.Generator().manual_seed(seed),
                                    opt, device="cpu")
    model.to(device)
    return model, {"m": {n: t.to(device) for n, t in state["m"].items()},
                   "v": {n: t.to(device) for n, t in state["v"].items()},
                   "step": state["step"].to(device)}


def lm_train_check(rng) -> dict:
    """Phase lm_train_check: one float32 train step, card against CPU, on
    the naive path and on the kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    opt = AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, opt, dtype=torch.float32)
    out = {}
    for label, b, text in (("naive", 2, 256), ("kernels", 1, 1000)):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, text)),
                 "patches": torch.from_numpy(rng.normal(size=(
                     b, cfg.n_frontend_tokens, cfg.d_model)).astype(
                         np.float32))}
        runs = {}
        for device in ("cuda", "cpu"):
            model, state = train_state_on(device, cfg, opt, seed=12)
            counts = (flash.launches, flash.bwd_launches)
            model, state, metrics = step(model, state, batch)
            runs[device] = dict(
                model=model, state=state,
                metrics={k: float(v) for k, v in metrics.items()},
                launches=dict(forward=flash.launches - counts[0],
                              backward_calls=flash.bwd_launches - counts[1]))
        card, host = runs["cuda"], runs["cpu"]
        rel = {k: abs(card["metrics"][k] - host["metrics"][k])
               / abs(host["metrics"][k]) for k in ("loss", "gnorm")}
        check(all(r <= 1e-4 for r in rel.values()),
              f"lm_train_check {label}: card against CPU {rel}")
        worst = {"params": (0.0, None), "m": (0.0, None), "v": (0.0, None)}
        for (name, p), (_, want) in zip(card["model"].named_parameters(),
                                        host["model"].named_parameters()):
            diff = float((p.detach().cpu() - want.detach()).abs().max())
            allow = 2 * opt.lr + 1e-6
            check(diff <= allow, f"lm_train_check {label}: {name} moved "
                  f"{diff} from the CPU's, beyond {allow}")
            if diff / allow > worst["params"][0]:
                worst["params"] = (diff / allow, name)
            for part in ("m", "v"):
                got = card["state"][part][name].cpu()
                w = host["state"][part][name]
                tol = 2e-4 * float(w.abs().max()) + 1e-30
                share = float((got - w).abs().max()) / tol
                check(share <= 1, f"lm_train_check {label}: {part} of "
                      f"{name} off the CPU's by {share} of its tolerance")
                if share > worst[part][0]:
                    worst[part] = (share, name)
        want_fwd = 2 * cfg.n_layers if label == "kernels" else 0
        check(card["launches"] == dict(forward=want_fwd,
                                       backward_calls=want_fwd // 2),
              f"lm_train_check {label}: flash launches {card['launches']}")
        out[label] = dict(
            tokens=[b, cfg.n_frontend_tokens + text],
            metrics={"cuda": card["metrics"], "cpu": host["metrics"]},
            rel_err=rel, flash_launches=card["launches"],
            worst_share_of_tolerance={k: {"share": v[0], "leaf": v[1]}
                                      for k, v in worst.items()})
        del runs, card, host
    emit("lm_train_check", arch=TRAIN_ARCH, n_layers=cfg.n_layers,
         attn_impl=cfg.attn_impl, remat=cfg.remat,
         weights="random float32, seed 12", activations="float32",
         tolerance={"loss_gnorm_rel": 1e-4,
                    "m_v": "2e-4 of the leaf's largest",
                    "params": "2 lr + 1e-6"}, **out,
         seconds=time.perf_counter() - t_phase)
    return out


def lm_train_phase(rng) -> dict:
    """Phase lm_train: internvl2-1b at full width, 10 steps after one
    warm-up, the counts reset just before the timed steps and read just
    after, then one profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash, ref
    from repro_torch.launch import steps as steps_lib, train as train_lib
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import AdamWConfig
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=TRAIN_STEPS + 2)
    model, state = steps_lib.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(13), opt,
        device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    step = steps_lib.make_train_step(cfg, opt)
    batch_fn = train_lib.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_TEXT,
                                       device="cuda")
    losses, gnorms, step_ms = [], [], []
    model, state, m = step(model, state, batch_fn(0))       # warm-up
    losses.append(float(m["loss"]))
    gnorms.append(float(m["gnorm"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_calls = []
    with contextlib.ExitStack() as stack:
        for fn in ("attention_ref", "attention_bwd_ref"):
            real = getattr(ref, fn)
            stack.callback(setattr, ref, fn, real)
            setattr(ref, fn, lambda *a, _r=real, _n=fn, **kw:
                    plain_calls.append(_n) or _r(*a, **kw))
        reset_counts()
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch_fn(i))
            losses.append(float(m["loss"]))            # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(m["gnorm"]))
        launches = dict(
            forward=flash.launches / TRAIN_STEPS,
            backward_calls=flash.bwd_launches / TRAIN_STEPS,
            backward_kernels={n: c / TRAIN_STEPS for n, c in
                              flash.bwd_launches_by_kernel.items()})
        total_bwd, total_fwd = flash.bwd_launches, flash.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not plain_calls, f"lm_train called the plain attention: "
          f"{sorted(set(plain_calls))}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"lm_train: the loss did not fall: {losses}")
    check(launches["forward"] == 2 * cfg.n_layers
          and launches["backward_calls"] == cfg.n_layers,
          f"lm_train: flash launches a step {launches}, want "
          f"{2 * cfg.n_layers} forward (remat) and {cfg.n_layers} backward")
    # one profiled step: device time by group and the idle share
    labels = ["xent", "optimizer"]
    with labelled([(lm_layers, "_xent_sum", "xent"),
                   (steps_lib, "adamw_update", "optimizer")]):
        batch = batch_fn(TRAIN_STEPS + 1)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups, busy = device_ms_by_group(prof, labels)
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    res = dict(losses=losses, gnorms=gnorms, step_ms=step_ms, p50_ms=p50,
               p99_ms=p99, text_tokens_per_s=TRAIN_BATCH * TRAIN_TEXT
               / (p50 / 1e3), max_memory_allocated_gb=peak_gb,
               flash_launches_per_step=launches,
               backward_calls=total_bwd, forward_launches=total_fwd,
               params=n_params)
    emit("lm_train", arch=TRAIN_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         vocab_size=cfg.vocab_size, weights="random float32, seed 13",
         remat=cfg.remat, attn_impl=cfg.attn_impl, batch=TRAIN_BATCH,
         tokens=[TRAIN_BATCH, cfg.n_frontend_tokens + TRAIN_TEXT],
         reduced=[], optimizer=dataclasses.asdict(opt), warmup_steps=1,
         steps=TRAIN_STEPS, **res,
         profiled_step=dict(wall_ms=wall_ms, device_busy_ms=busy,
                            idle_share=1 - busy / wall_ms,
                            # the profiler slows the host: against the
                            # unprofiled steps' p50 too
                            idle_share_of_p50=1 - busy / p50,
                            device_ms_by_group=groups,
                            share_by_group=shares(groups, busy)),
         seconds=time.perf_counter() - t_phase)
    del model, state
    torch.cuda.empty_cache()
    return res


def lm_pretrain_phase() -> dict:
    """Phase lm_pretrain: the pretraining entry point, then its resume."""
    from repro_torch.launch import lm_pretrain
    t_phase = time.perf_counter()
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_pretrain"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(PRETRAIN, ckpt_dir=str(ckpt), device="cuda")
    arch = kw.pop("arch")
    t0 = time.perf_counter()
    first = lm_pretrain.pretrain(arch, **kw)
    first_s = time.perf_counter() - t0
    last = ckpt / f"step_{PRETRAIN['steps_n']:08d}.npz"
    with np.load(last) as data:
        final = {k: data[k] for k in data.files}
    last.unlink()
    resumed = lm_pretrain.pretrain(arch, **kw)
    at = PRETRAIN["ckpt_every"]
    with np.load(last) as data:
        equal = sorted(final) == sorted(data.files) and all(
            np.array_equal(final[k], data[k]) for k in data.files)
    check(all(np.isfinite(first)), f"lm_pretrain: losses {first}")
    check(resumed == first[at:], f"lm_pretrain: resumed losses {resumed} "
          f"are not the first run's {first[at:]}")
    check(equal, "lm_pretrain: the resumed run's final state differs")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = dict(losses=first, resumed_losses=resumed, resumed_at=at,
               resumed_bit_equal=True, final_state_bit_equal=equal,
               first_run_seconds=first_s)
    emit("lm_pretrain", arch=arch, batch=PRETRAIN["batch"],
         seq=PRETRAIN["seq"], steps=PRETRAIN["steps_n"],
         checkpoint_every=at, **out, seconds=time.perf_counter() - t_phase)
    return out


ROOFLINE_STEPS = {  # phase -> (arch, batch, text tokens, kind)
    "prefill": (LM_ARCH, LM_BATCH, LM_SEQ, "prefill"),
    "lm_train": (TRAIN_ARCH, TRAIN_BATCH, TRAIN_TEXT, "train")}


def roofline_phase(smi_line: str, measured: dict) -> None:
    """Phase roofline: the prefill's and lm_train's steps counted on the
    meta device (``launch.dryrun.count_one``: no allocation, the flash
    calls as the kernel does the work), beside what those phases
    measured: model FLOPs (6ND / 2ND) and counted FLOPs, the compute and
    memory terms on the card's peaks, the p50 and the share
    ``model_flops / (p50 x 989 TFLOP/s)``, the peak estimate beside the
    step's measured ``max_memory_allocated``.  Fails if a count raises,
    if the flash calls counted differ from the launches the phase counted
    a request or a step, or if the estimate lies further than
    ``PEAK_MARGIN`` of the measured peak from it."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    for phase, (arch, batch, seq, kind) in ROOFLINE_STEPS.items():
        t0 = time.perf_counter()
        rec = dryrun.count_one(get_config(arch),
                               InputShape(phase, seq, batch, kind))
        got = measured[phase]
        calls = {"forward": rec["attention"]["forward_calls"],
                 "backward_calls": rec["attention"]["backward_calls"]}
        launched = {k: got["flash_launches"][k] for k in calls}
        check(calls == launched, f"roofline {phase}: the count has flash "
              f"calls {calls}, the phase launched {launched} a step")
        est_gb = rec["peak_bytes_estimate"] / 1e9
        peak_gb = got["max_memory_allocated_gb"]
        check(abs(peak_gb - est_gb) <= PEAK_MARGIN * peak_gb,
              f"roofline {phase}: peak estimate {est_gb:.2f} GB, measured "
              f"{peak_gb:.2f} GB: further apart than {PEAK_MARGIN:.0%} of "
              "the measurement")
        terms, p50_s = rec["roofline"], got["p50_ms"] / 1e3
        emit("roofline", step=phase, arch=arch, kind=kind,
             tokens=[batch, seq], nvidia_smi=smi_line,
             **{k: rec[k] for k in (
                 "n_params", "model_flops", "flops", "flops_float32",
                 "bytes_accessed", "attention", "useful_flops_ratio")},
             compute_ms=terms["compute_s"] * 1e3,
             memory_ms=terms["memory_s"] * 1e3, dominant=terms["dominant"],
             p50_ms=got["p50_ms"],
             model_flops_share=rec["model_flops"] / (p50_s * BF16_OPS_PER_S),
             bound_share=max(terms["compute_s"], terms["memory_s"]) / p50_s,
             state_gb=rec["state_bytes"] / 1e9,
             peak_estimate_gb=est_gb, max_memory_allocated_gb=peak_gb,
             peak_gap_share=(peak_gb - est_gb) / peak_gb,
             peak_margin=PEAK_MARGIN,
             count_seconds=rec["run_s"],
             seconds=time.perf_counter() - t0)
    emit("roofline_total", seconds=time.perf_counter() - t_phase)


# the sharded phase: two ranks of the one card (gloo), tensor-parallel over
# 'model' on make_debug_mesh(1, 2); internvl2-1b's lm_train step and
# glm4-9b's prefill at full width, the float32 checks at 2 layers
SHARDED_MESH, SHARDED_RANKS = (1, 2), 2
SHARDED_STEPS, SHARDED_REQUESTS, SHARDED_CHECK_LAYERS = 3, 2, 2
SHARDED_F32_TOL = 2e-4            # the card's float32 prefill contract
SHARDED_LOSS_TOL, SHARDED_MV_TOL = 1e-4, 2e-4      # lm_train_check's


def _sharded_mesh():
    from repro_torch.launch import mesh
    return mesh.make_debug_mesh(*SHARDED_MESH)


def _local_heads(record: list):
    """Record the (q heads, kv heads) of every forward and backward flash
    launch on this rank (the kernels' entry points, as ``ops`` calls
    them); returns the context that puts them back."""
    from repro_torch.kernels import flash_attention as flash
    stack = contextlib.ExitStack()
    for name in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
        real = getattr(flash, name)
        stack.callback(setattr, flash, name, real)
        setattr(flash, name, lambda q, k, *a, _r=real, _n=name, **kw:
                record.append((_n, q.shape[1], k.shape[1])) or
                _r(q, k, *a, **kw))
    return stack


def _full(t) -> torch.Tensor:
    """A ``DTensor``'s whole value, gathered in gloo's forms (as under
    ``logical_rules`` on this mesh); a plain tensor as it is."""
    if not hasattr(t, "full_tensor"):
        return t
    from repro_torch.launch import distributed as dist_lib
    with dist_lib.GlooCollectives():
        return t.full_tensor()


def sharded_train_rank(dm, rules) -> dict:
    """(a) on this rank: internvl2-1b's train step at 2 layers in float32
    against the one-process step on the card, then at full depth in bf16:
    a warm-up and SHARDED_STEPS timed steps, the flash launches and their
    local heads, the collective bytes of one step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import roofline, shardings, steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import sharding
    from repro_torch.optim import AdamWConfig
    opt = AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=10)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=SHARDED_CHECK_LAYERS)
    batch = train_lib.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_TEXT,
                                    device="cuda")(0)
    step = steps_lib.make_train_step(cfg, opt, dtype=torch.float32)
    model, state = train_state_on("cuda", cfg, opt, seed=12)
    smodel, sstate = copy.deepcopy(model), copy.deepcopy(state)
    model, state, want = step(model, state, batch)
    shardings.shard_model(smodel, dm, cfg)
    sstate = shardings.shard_opt_state(sstate, dm, cfg)
    with sharding.logical_rules(rules, dm):
        smodel, sstate, got = step(smodel, sstate,
                                   shardings.shard_batch(batch, dm))
    rel = {k: abs(float(_full(got[k])) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "gnorm")}
    mv = max(float((_full(sstate[part][n]) - t).abs().max())
             / (float(t.abs().max()) + 1e-30)
             for part in ("m", "v") for n, t in state[part].items())
    check(max(rel.values()) <= SHARDED_LOSS_TOL and mv <= SHARDED_MV_TOL,
          f"sharded lm_train check: loss/gnorm {rel}, m/v {mv}")
    del model, state, smodel, sstate
    torch.cuda.empty_cache()

    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=SHARDED_STEPS + 2)
    model, state = steps_lib.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(13), opt,
        device="cuda")
    shardings.shard_model(model, dm, cfg)
    state = shardings.shard_opt_state(state, dm, cfg)
    torch.cuda.empty_cache()
    step = steps_lib.make_train_step(cfg, opt)
    batch_fn = train_lib.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_TEXT,
                                       device="cuda")
    losses, step_ms, heads = [], [], []
    with sharding.logical_rules(rules, dm):
        model, state, m = step(model, state,
                               shardings.shard_batch(batch_fn(0), dm))
        losses.append(float(_full(m["loss"])))
        torch.cuda.synchronize()
        counts = (flash.launches, flash.bwd_launches)
        with _local_heads(heads):
            for i in range(1, SHARDED_STEPS + 1):
                b = shardings.shard_batch(batch_fn(i), dm)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with roofline.CollectiveCounter() as coll:
                    model, state, m = step(model, state, b)
                losses.append(float(_full(m["loss"])))   # waits
                step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(forward=flash.launches - counts[0],
                        backward_calls=flash.bwd_launches - counts[1])
    del model, state
    torch.cuda.empty_cache()
    return dict(check=dict(rel_err=rel, m_v_share=mv,
                           n_layers=SHARDED_CHECK_LAYERS),
                losses=losses, step_ms=step_ms,
                p50_ms=float(np.percentile(step_ms, 50)),
                launches=launches, heads=sorted(set(heads)),
                collective_bytes=dict(coll.bytes))


def sharded_prefill_rank(dm, rules) -> dict:
    """(b) on this rank: glm4-9b's prefill at 2 layers in float32 against
    the one-process step on the card, then at full depth in bf16: a
    warm-up and SHARDED_REQUESTS timed requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import roofline, shardings, steps as steps_lib
    from repro_torch.models import init_params, sharding
    rng = np.random.default_rng(31)
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=SHARDED_CHECK_LAYERS)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).to("cuda")}
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda", dtype=torch.float32)
    step = steps_lib.make_prefill_step(cfg, dtype=torch.float32)
    want = step(model, batch)
    shardings.shard_model(model, dm, cfg)
    with sharding.logical_rules(rules, dm):
        got = _full(step(model, shardings.shard_batch(batch, dm)))
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(gap <= SHARDED_F32_TOL * max(1.0, scale),
          f"sharded prefill check: {gap} from the one-process step")
    del model, want, got
    torch.cuda.empty_cache()

    cfg = get_config(LM_ARCH)
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    shardings.shard_model(model, dm, cfg)
    torch.cuda.empty_cache()
    step = steps_lib.make_prefill_step(cfg)
    batches = [shardings.shard_batch({"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).to("cuda")}, dm)
        for _ in range(SHARDED_REQUESTS + 1)]
    req_ms, heads = [], []
    with sharding.logical_rules(rules, dm):
        logits = step(model, batches[0])
        torch.cuda.synchronize()
        n0 = flash.launches
        with _local_heads(heads):
            for b in batches[1:]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with roofline.CollectiveCounter() as coll:
                    logits = step(model, b)
                torch.cuda.synchronize()
                req_ms.append((time.perf_counter() - t0) * 1e3)
        launches = flash.launches - n0
        local = logits.to_local()
        finite = bool(torch.isfinite(local).all())
        shape = list(logits.shape)
    check(finite and shape == [LM_BATCH, LM_SEQ, cfg.vocab_size],
          f"sharded prefill: logits {shape}, finite {finite}")
    del model, logits, local
    torch.cuda.empty_cache()
    return dict(check=dict(max_abs_err=gap, scale=scale,
                           n_layers=SHARDED_CHECK_LAYERS),
                req_ms=req_ms, p50_ms=float(np.percentile(req_ms, 50)),
                launches=launches, heads=sorted(set(heads)),
                collective_bytes=dict(coll.bytes))


def sharded_rank() -> dict:
    """Both sharded steps on this rank, on the 1 x 2 mesh of the group
    ``launch.distributed.run`` started (gloo over the card's tensors)."""
    from repro_torch.launch import mesh
    from repro_torch.models import sharding
    # a spawned rank: the script's precision settings again
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.reset_peak_memory_stats()
    dm = mesh.device_mesh(_sharded_mesh())
    rules = sharding.rules_for_mesh(mesh.shape_of(dm))
    out = {"lm_train": sharded_train_rank(dm, rules),
           "prefill": sharded_prefill_rank(dm, rules)}
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sharded_phase(smi_line: str) -> dict:
    """Phase sharded: the JAX package's plan applied as DTensor placements
    on two ranks of the card, tensor-parallel over 'model': (a) the
    lm_train step and (b) the prefill at full width, each held at 2
    layers in float32 to the one-process card step, the flash kernels run
    on each rank's local heads (7:1 and 16:1), and (c) the collective
    bytes each rank's counter saw in one step and one request equal to
    the fake-group meta count of the same steps
    (``launch.dryrun.measure_sharded``: exact, held so in the tests)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import distributed as dist_lib, dryrun
    t_phase = time.perf_counter()
    meta = {phase: dryrun.measure_sharded(get_config(arch), InputShape(
        phase, seq, batch, kind), _sharded_mesh())["coll"]
        for phase, (arch, batch, seq, kind) in ROOFLINE_STEPS.items()}
    meta_s = time.perf_counter() - t_phase
    got = dist_lib.run(sharded_rank, SHARDED_RANKS, device="cuda")
    tcfg, pcfg = get_config(TRAIN_ARCH), get_config(LM_ARCH)
    want_heads = {
        "lm_train": {("flash_attention_cuda", tcfg.n_heads // 2,
                      tcfg.n_kv_heads // 2),
                     ("flash_attention_bwd_cuda", tcfg.n_heads // 2,
                      tcfg.n_kv_heads // 2)},
        "prefill": {("flash_attention_cuda", pcfg.n_heads // 2,
                     pcfg.n_kv_heads // 2)}}
    for phase in ("lm_train", "prefill"):
        heads = {tuple(h) for h in got[phase]["heads"]}
        check(heads == want_heads[phase], f"sharded {phase}: the flash "
              f"kernels ran on (q, kv) heads {heads}, want "
              f"{want_heads[phase]}")
        check(got[phase]["collective_bytes"] == meta[phase],
              f"sharded {phase}: the rank moved "
              f"{got[phase]['collective_bytes']}, the meta count says "
              f"{meta[phase]}")
    want = {"lm_train": dict(forward=2 * tcfg.n_layers * SHARDED_STEPS,
                             backward_calls=tcfg.n_layers * SHARDED_STEPS),
            "prefill": pcfg.n_layers * SHARDED_REQUESTS}
    for phase in want:
        check(got[phase]["launches"] == want[phase],
              f"sharded {phase}: flash launches {got[phase]['launches']} "
              f"on rank 0, want {want[phase]}")
    check(all(np.isfinite(got["lm_train"]["losses"])),
          f"sharded lm_train: losses {got['lm_train']['losses']}")
    emit("sharded", nvidia_smi=smi_line, mesh=dict(zip(
        ("data", "model"), SHARDED_MESH)), ranks=SHARDED_RANKS,
         backend="gloo (GlooCollectives under logical_rules)",
         lm_train=dict(arch=TRAIN_ARCH, tokens=[TRAIN_BATCH,
                                                 tcfg.n_frontend_tokens
                                                 + TRAIN_TEXT],
                       steps=SHARDED_STEPS, dtype="bfloat16",
                       **got["lm_train"]),
         prefill=dict(arch=LM_ARCH, tokens=[LM_BATCH, LM_SEQ],
                      requests=SHARDED_REQUESTS, dtype="bfloat16",
                      **got["prefill"]),
         meta_collective_bytes=meta, meta_count_seconds=meta_s,
         rank0_max_memory_allocated_gb=got["max_memory_allocated_gb"],
         seconds=time.perf_counter() - t_phase)
    return got


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1

    from repro_torch import GBDTConfig, accuracy, fit, fit_reference
    from repro_torch.core.boosting import leaf_rounding
    from repro_torch.configs import get_config
    from repro_torch.core import boosting, proposal, rank_error, sketch, \
        tree as tree_lib
    from repro_torch.data import tabular
    from repro_torch.kernels import _build, hist, ops, ref, split_gain, \
        traverse
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import distributed as dist_lib, \
        distributed_gbdt, quickstart, serve_gbdt
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import attention as attn_lib, init_decode_state, \
        init_params, layers as lm_layers, model as model_lib, moe as moe_lib, \
        ssm as ssm_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit("device", kind=kind, nvidia_smi=smi_line,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         allow_bf16_reduced_precision_reduction=(
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction))

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(
        (_build.BUILD_DIR / f"{name}.log").read_text()) for name in libs}
    wgmma_ptxas = {k: v for k, v in ptxas["flash_attention"].items()
                   if "flash_kernel_wgmma" in k}
    flash_sass = sass_counts(_build.BUILD_DIR / "libflash_attention.so")
    flash_bwd_sass = sass_counts(
        _build.BUILD_DIR / "libflash_attention_bwd.so")
    check(len(wgmma_ptxas) == 2 * len(flash.WGMMA_HEAD_DIMS),
          f"ptxas reported {sorted(wgmma_ptxas)}, want two Hopper flash "
          f"kernels (without and with lse) a head dim of "
          f"{flash.WGMMA_HEAD_DIMS}")

    def regs(report: dict, pattern: str) -> dict | None:
        return next(({"registers": v.get("registers"),
                      "spill_bytes": v.get("spill_stores", 0)
                      + v.get("spill_loads", 0)}
                     for k, v in report.items() if re.search(pattern, k)),
                    None)
    # the no-grad instance under d{d}, the one that also writes lse (the
    # training forward) under d{d}_lse
    wgmma_regs = {f"d{d}{tag}": regs(wgmma_ptxas,
                                     f"flash_kernel_wgmmaILi{d}ELb{flag}E")
                  for d in flash.WGMMA_HEAD_DIMS
                  for tag, flag in (("", 0), ("_lse", 1))}
    check(all(r is not None and r["spill_bytes"] == 0
              for r in wgmma_regs.values()),
          f"a Hopper flash kernel spills or was not reported: {wgmma_regs}")
    check(flash_sass is None or all(flash_sass[op] > 0 for op in SASS_OPS),
          f"libflash_attention.so lacks wgmma or TMA instructions: "
          f"{flash_sass}")
    check(flash_bwd_sass is None
          or all(flash_bwd_sass[op] > 0 for op in SASS_OPS),
          f"libflash_attention_bwd.so lacks wgmma or TMA instructions: "
          f"{flash_bwd_sass}")
    hist_atomics = sass_atomics(_build.BUILD_DIR / "libhist.so")
    cas_loops = None if hist_atomics is None else sum(
        c for op, c in hist_atomics.items() if ".CAS" in op)
    check(not cas_loops, f"libhist.so adds with compare-and-swap loops: "
          f"{hist_atomics}")
    # every backward instance: the bf16 variant's two kernels a head dim
    # and its sum of the chunks, the float32 variant's two a head dim
    bwd_ptxas = ptxas["flash_attention_bwd"]
    bwd_regs = {f"{kind}_d{d}": regs(bwd_ptxas, f"{kind}ILi{d}E")
                for kind in ("bwd_dq_wgmma", "bwd_dkdv_wgmma")
                for d in flash.HEAD_DIMS}
    bwd_regs["bwd_dkdv_sum"] = regs(bwd_ptxas, "bwd_dkdv_sum")
    bwd_regs.update({f"{kind}_f32_d{d}": regs(bwd_ptxas, f"{kind}IfLi{d}E")
                     for kind in flash.BWD_KERNELS["bwd_cuda_core_f32"]
                     for d in flash.HEAD_DIMS})
    check(all(r is not None for r in bwd_regs.values()),
          f"ptxas did not report every backward instance: {bwd_regs}")
    check(all(r["spill_bytes"] == 0 for r in bwd_regs.values()),
          f"a backward instance spills: {bwd_regs}")
    # ptxas serialises the wgmma of a loop it cannot pipeline (C7515,
    # C7518: an accumulator written between issue and wait, a wait in a
    # divergent path), which made the dK/dV kernel slower in a trial:
    # none may
    serialised = sorted(k for k, v in bwd_ptxas.items() if "wgmma" in k
                        and any("serialized" in w for w in v["warnings"]))
    check(not serialised, f"ptxas serialises the wgmma of {serialised}")
    emit("build", seconds=build_seconds, libraries=sorted(libs),
         ptxas=ptxas, flash_wgmma_registers=wgmma_regs,
         flash_bwd_registers=bwd_regs,
         flash_sass_counts=flash_sass, flash_bwd_sass_counts=flash_bwd_sass,
         hist_sass_atomics=hist_atomics, hist_cas_loops=cas_loops,
         sass_note=None if flash_sass is not None else
         "cuobjdump not found: SASS not counted")

    # 3. check + 4. time -----------------------------------------------------
    rng = np.random.default_rng(0)
    cases = [(binned, n, C, depth, False) for binned in (False, True)
             for n in (1, 4095, 4096, 50_000) for C in (1, 25)
             for depth in (1, 6)]
    cases += [(binned, 4096, 25, 0, False) for binned in (False, True)]
    cases += [(binned, 4096, 25, 6, True) for binned in (False, True)]
    max_err = {False: 0.0, True: 0.0}
    for binned, n, C, depth, out_of_range in cases:
        args = make_chunk(rng, n=n, C=C, depth=depth, binned=binned,
                          out_of_range=out_of_range)
        out = traverse.traverse_chunk_cuda(*args, max_depth=depth)
        exp = ref.traverse_chunk_ref(*args, max_depth=depth)
        torch.cuda.synchronize()
        check(out.shape == (n, C) and out.dtype == torch.float32,
              f"traverse output {tuple(out.shape)} {out.dtype}")
        err = float((out - exp).abs().max())
        max_err[binned] = max(max_err[binned], err)
        check(torch.equal(out, exp),
              f"traverse kernel != plain version (binned={binned}, n={n}, "
              f"C={C}, depth={depth}, out_of_range={out_of_range}, "
              f"max_abs_err={err})")
    repeats = {}          # each kernel launched twice on one input
    for binned in (False, True):
        args = make_chunk(rng, n=MICROBATCH, C=TREE_CHUNK, depth=DEPTH,
                          binned=binned, out_of_range=True)
        repeats[f"traverse_{binned}"] = torch.equal(
            traverse.traverse_chunk_cuda(*args, max_depth=DEPTH),
            traverse.traverse_chunk_cuda(*args, max_depth=DEPTH))
    emit("check", kernel="traverse_chunk", cases=len(cases),
         equal=True, max_abs_err={"f32": max_err[False],
                                  "i32": max_err[True]},
         repeat_equal={"f32": repeats["traverse_False"],
                       "i32": repeats["traverse_True"]})

    timing = {}
    for binned in (False, True):
        args = make_chunk(rng, n=MICROBATCH, C=TREE_CHUNK, depth=DEPTH,
                          binned=binned)
        ms, issue_ms = cuda_ms(lambda: traverse.traverse_chunk_cuda(
            *args, max_depth=DEPTH), iters=500)
        plain_ms, plain_issue_ms = cuda_ms(lambda: ref.traverse_chunk_ref(
            *args, max_depth=DEPTH), iters=100)
        bound_ms, bound_by = traverse_bound_ms(MICROBATCH, FEATURES,
                                               TREE_CHUNK, DEPTH)
        timing[binned] = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                              plain_issue_ms=plain_issue_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    # the launch floor: an empty kernel, timed as every kernel is
    floor_ms, floor_issue_ms = cuda_ms(lambda: torch.cuda._sleep(0),
                                       iters=500)
    emit("time", kernel="launch_floor", op="torch.cuda._sleep(0)",
         ms=floor_ms, issue_ms=floor_issue_ms)
    for t in timing.values():
        t["floor_ms"] = floor_ms
    emit("time", kernel="traverse_chunk",
         shape=dict(n=MICROBATCH, f=FEATURES, C=TREE_CHUNK, depth=DEPTH),
         f32=timing[False], i32=timing[True])

    # the forest-sum form: bit for bit its plain version (the leaf values
    # added in tree order onto +0.0, then base + scale * sum)
    forest_err = {False: 0.0, True: 0.0}

    def check_forest(args, depth, case, **affine):
        out = traverse.forest_sum_cuda(*args, max_depth=depth, **affine)
        exp = ref.forest_sum_ref(*args, max_depth=depth, **affine)
        torch.cuda.synchronize()
        binned = args[0].dtype == torch.int32
        check(out.shape == (args[0].shape[0],) and out.dtype == torch.float32,
              f"forest_sum output {tuple(out.shape)} {out.dtype} ({case})")
        err = float((out - exp).abs().max()) if out.numel() else 0.0
        forest_err[binned] = max(forest_err[binned], err)
        check(torch.equal(out, exp), f"forest_sum kernel != plain version "
              f"({case}, max_abs_err={err})")
        return out

    forest_cases = 0
    for binned in (False, True):
        for n in (1, 4095, 4096, 50_000):
            for T in (1, 24, 25, 26, TREES):
                for depth in (0, 1, DEPTH):
                    args = make_chunk(rng, n=n, C=T, depth=depth,
                                      binned=binned)
                    check_forest(args, depth, f"binned={binned} n={n} T={T} "
                                 f"depth={depth}")
                    forest_cases += 1
        # out-of-range ids and the affine step at the serving shape; a
        # deep forest (one tree a stage), a wide one (values not staged)
        for kw, affine in (
                (dict(n=MICROBATCH, C=TREES, depth=DEPTH, out_of_range=True),
                 {}),
                (dict(n=MICROBATCH, C=TREES, depth=DEPTH),
                 dict(base=0.25, scale=0.3)),
                (dict(n=3000, C=37, depth=13, f=8), {}),
                (dict(n=2000, C=70, depth=9), dict(base=-1.5, scale=0.1)),
                (dict(n=777, C=70, depth=5, f=600), {})):
            args = make_chunk(rng, binned=binned, **kw)
            check_forest(args, kw["depth"], f"binned={binned} {kw} "
                         f"{affine}", **affine)
            forest_cases += 1
        # a first tree of -0.0 leaves alone: 0 + (-0) is +0
        feature, cmp, leaf = make_chunk(rng, n=1, C=1, depth=DEPTH,
                                        binned=binned)[1:]
        leaf = torch.full_like(leaf, -0.0)
        values = make_chunk(rng, n=MICROBATCH, C=1, depth=DEPTH,
                            binned=binned)[0]
        out = check_forest((values, feature, cmp, leaf), DEPTH,
                           f"binned={binned}, leaves -0.0")
        check(not bool(torch.signbit(out).any()),
              "forest_sum kept a -0.0 leaf as the sum; it must be +0.0")
        forest_cases += 1
        args = make_chunk(rng, n=MICROBATCH, C=TREES, depth=DEPTH,
                          binned=binned, out_of_range=True)
        repeats[f"forest_sum_{binned}"] = torch.equal(
            traverse.forest_sum_cuda(*args, max_depth=DEPTH),
            traverse.forest_sum_cuda(*args, max_depth=DEPTH))
        check(repeats[f"forest_sum_{binned}"], "forest_sum kernel differs "
              "from itself on a repeated launch")
    emit("check", kernel="forest_sum", cases=forest_cases, equal=True,
         max_abs_err={"f32": forest_err[False], "i32": forest_err[True]},
         repeat_equal={"f32": repeats["forest_sum_False"],
                       "i32": repeats["forest_sum_True"]})

    forest_timing = {}
    for binned in (False, True):
        args = make_chunk(rng, n=MICROBATCH, C=TREES, depth=DEPTH,
                          binned=binned)
        ms, issue_ms = cuda_ms(lambda: traverse.forest_sum_cuda(
            *args, max_depth=DEPTH), iters=500)
        plain_ms, plain_issue_ms = cuda_ms(lambda: ref.forest_sum_ref(
            *args, max_depth=DEPTH), iters=10, warmup=2)
        b_ms, b_by = traverse_bound_ms(MICROBATCH, FEATURES, TREES, DEPTH,
                                       out_per_row=1)
        # one block alone (32 rows): the chain of groups a block walks,
        # without the other blocks' reads of the forest from L2
        one_block_ms, _ = cuda_ms(lambda: traverse.forest_sum_cuda(
            *(a[:32] if i == 0 else a for i, a in enumerate(args)),
            max_depth=DEPTH), iters=500)
        forest_timing[binned] = dict(
            ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
            plain_issue_ms=plain_issue_ms, bound_ms=b_ms, bound_by=b_by,
            floor_ms=floor_ms, one_block_ms=one_block_ms)
    emit("time", kernel="forest_sum",
         shape=dict(n=MICROBATCH, f=FEATURES, T=TREES, depth=DEPTH),
         f32=forest_timing[False], i32=forest_timing[True])

    gen = torch.Generator(device="cuda").manual_seed(0)
    hist_err = {False: 0.0, True: 0.0}
    err_share = {False: 0.0, True: 0.0}   # largest |kernel - plain| / bound

    def check_hist(child, bins, node, gh_int, gh_real, *, n_nodes, nbins,
                   case):
        """The kernel against its fixed-point emulation (equal, counts
        too) and against its plain version: equal on integer g/h (or on
        none, given None), within the restated rounding bound on real g/h;
        in child mode the row counts equal."""
        kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
        plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
        kw = dict(n_nodes=n_nodes, nbins=nbins)
        shape = (node.shape[0], n_nodes, bins.shape[1], nbins)
        for gh in (gh_int, gh_real):
            if gh is None:
                continue
            got = kernel(bins, node, gh, **kw)
            emul = ref.hist_levels_fixed(bins, node, gh, **kw, child=child)
            want = plain(bins, node, gh, **kw)
            torch.cuda.synchronize()
            if child:
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[1], emul[1]),
                      f"hist kernel's row counts != plain version's ({case})")
                got, want, emul = got[0], want[0], emul[0]
            check(got.shape == shape + (2,),
                  f"hist output {tuple(got.shape)}, {case}")
            check(torch.equal(got, emul), f"hist kernel != its fixed-point "
                  f"emulation ({case}, max_abs_err="
                  f"{float((got - emul).abs().max())})")
            if gh is gh_int:
                check(torch.equal(got, want), f"hist kernel != plain "
                      f"version on integer g/h ({case})")
                continue
            bound = ref.hist_rounding_bound(bins, node, gh, child=child, **kw,
                                            quantum=ref.hist_quanta(gh))
            diff = (got.double() - want.double()).abs()
            torch.cuda.synchronize()
            check(bool((diff <= bound).all()),
                  f"hist kernel beyond the restated rounding bound on real "
                  f"g/h ({case}, max_abs_err={float(diff.max())})")
            hist_err[child] = max(hist_err[child], float(diff.max()))
            nz = bound > 0
            if bool(nz.any()):
                err_share[child] = max(err_share[child],
                                       float((diff[nz] / bound[nz]).max()))

    n_hist_cases = 0
    for child in (False, True):
        for n in (1, 4097, TRAIN_ROWS):
            for f in (1, TRAIN_FEATURES):
                for nbins in (2, TRAIN_BINS, 257):
                    for L in (1, TRAIN_DEPTH):
                        # 16: the parent panel of the subtraction fit
                        for n_nodes in ((1, TRAIN_NODES // 2, TRAIN_NODES)
                                        if child else (1, TRAIN_NODES)):
                            bins, node, gh_int, gh_real = hist_case(
                                gen, n=n, f=f, nbins=nbins, n_nodes=n_nodes,
                                L=L, child=child)
                            check_hist(
                                child, bins, node, gh_int, gh_real,
                                n_nodes=n_nodes, nbins=nbins,
                                case=f"child={child} n={n} f={f} "
                                     f"nbins={nbins} L={L} n_nodes={n_nodes}")
                            n_hist_cases += 1

    gain_err = 0.0

    def check_gain(h, case, **kw):
        """The kernel against its plain version, bit for bit: gains (NaN
        where NaN, -inf where -inf) and bins."""
        nonlocal gain_err
        g, i = split_gain.split_gain_cuda(h, **kw)
        gw, iw = ref.split_gain_ref(h, **kw)
        torch.cuda.synchronize()
        both = (g == gw) | (torch.isnan(g) & torch.isnan(gw))
        diff = torch.where(both, 0.0, (g - gw).abs().nan_to_num(float("inf")))
        err = float(diff.max()) if diff.numel() else 0.0
        gain_err = max(gain_err, err)
        check(bool(both.all()) and torch.equal(i, iw),
              f"split_gain kernel != plain version ({case}, params={kw}, "
              f"max_abs_err={err})")

    n_gain_cases = 0
    # l2 = 0 with no weight floor gives NaN gains; gamma = inf makes every
    # legal gain -inf
    params = [(1.0, 0.0, 1e-6), (1.0, 0.1, 1.0), (0.0, 0.0, 0.0),
              (0.5, 0.3, 0.5), (1.0, float("inf"), 0.0)]
    for n_nodes, f in ((1, 1), (5, 3), (TRAIN_NODES, TRAIN_FEATURES)):
        for nbins in (1, 2, 9, 16, 17, TRAIN_BINS, 65, 256, 257, 300, 1000,
                      4097, split_gain.MAX_BINS):
            if n_nodes * f * nbins > 2_000_000:
                continue
            h = gain_case(gen, n_nodes, f, nbins)
            for l2, gamma, mcw in params:
                check_gain(h, f"n_nodes={n_nodes}, f={f}, nbins={nbins}",
                           l2=l2, gamma=gamma, min_child_weight=mcw)
                n_gain_cases += 1

    # the training shape: the deepest level of a depth-6 tree (every row
    # in one of 32 nodes); child mode as the subtraction fit calls it:
    # a panel of 16 parents, about half the rows routed left, with counts
    train_timing = {}
    for child in (False, True):
        n_nodes = TRAIN_NODES // 2 if child else TRAIN_NODES
        bins, _, _, gh = hist_case(gen, n=TRAIN_ROWS, f=TRAIN_FEATURES,
                                   nbins=TRAIN_BINS, n_nodes=1, L=1,
                                   child=False)
        node = torch.randint(0, TRAIN_NODES, (1, TRAIN_ROWS), generator=gen,
                             device="cuda", dtype=torch.int32)
        kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
        plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
        kw = dict(n_nodes=n_nodes, nbins=TRAIN_BINS)
        # the inputs timed here, held against the plain version first,
        # and the launch repeated: the same bits
        check_hist(child, bins, node, None, gh, **kw,
                   case=f"the timed training shape, child={child}")
        n_hist_cases += 1
        first, again = kernel(bins, node, gh, **kw), kernel(bins, node, gh,
                                                            **kw)
        repeats[f"hist_{child}"] = (
            torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                            again[1])
            if child else torch.equal(first, again))
        check(repeats[f"hist_{child}"], f"hist kernel (child={child}) "
              "differs from itself on a repeated launch")
        del first, again
        ms, issue_ms = cuda_ms(lambda: kernel(bins, node, gh, **kw), iters=50)
        plain_ms, _ = cuda_ms(lambda: plain(bins, node, gh, **kw), iters=5,
                              warmup=2)
        emulation_ms, _ = cuda_ms(lambda: ref.hist_levels_fixed(
            bins, node, gh, **kw, child=child), iters=5, warmup=2)
        # the library call: one index_add_ over the precomputed flat index
        # (in child mode of [g, h, 1], the counts riding as a third column)
        adds = ((node[0] % 2 == 0) if child else (node[0] >= 0))
        key = (((node[0].long() // 2 if child else node[0].long())[:, None]
                * TRAIN_FEATURES
                + torch.arange(TRAIN_FEATURES, device="cuda")[None, :])
               * TRAIN_BINS + bins.long())[adds].reshape(-1)
        cols = torch.cat([gh, torch.ones_like(gh[:, :1])], 1) if child else gh
        vals = cols[adds][:, None, :].expand(
            -1, TRAIN_FEATURES, cols.shape[1]).reshape(
            -1, cols.shape[1]).contiguous()
        size = n_nodes * TRAIN_FEATURES * TRAIN_BINS
        library_ms, _ = cuda_ms(lambda: torch.zeros(
            (size, cols.shape[1]), device="cuda").index_add_(0, key, vals),
            iters=20, warmup=3)
        b_ms, b_by = hist_bound_ms(bins, node, n_nodes, TRAIN_BINS, child)
        train_timing[child] = dict(ms=ms, issue_ms=issue_ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   floor_ms=floor_ms,
                                   emulation_ms=emulation_ms,
                                   replaced_kernel_ms=REPLACED_HIST_MS[
                                       "left" if child else "direct"])
        if not child:
            panel = kernel(bins, node, gh, **kw)[0]
    emit("check", kernel="hist_levels", cases=n_hist_cases,
         equal_to_fixed_point_emulation=True, integer_gh_equal=True,
         real_gh_within_bound=True, left_counts_equal=True,
         bound="ref.hist_rounding_bound(..., quantum=ref.hist_quanta(gh))",
         repeat_equal={"direct": repeats["hist_False"],
                       "left": repeats["hist_True"]},
         max_abs_err={"direct": hist_err[False], "left": hist_err[True]},
         max_err_over_bound={"direct": err_share[False],
                             "left": err_share[True]})
    check_gain(panel, "the timed training panel")
    repeats["split_gain"] = all(
        torch.equal(a, b) for a, b in zip(split_gain.split_gain_cuda(panel),
                                          split_gain.split_gain_cuda(panel)))
    emit("check", kernel="split_gain", cases=n_gain_cases + 1, equal=True,
         max_abs_err=gain_err, repeat_equal=repeats["split_gain"])
    emit("time", kernel="hist_levels",
         shape=dict(n=TRAIN_ROWS, f=TRAIN_FEATURES, n_nodes=TRAIN_NODES,
                    nbins=TRAIN_BINS, levels=1, left_panel_nodes=
                    TRAIN_NODES // 2),
         direct=train_timing[False], left=train_timing[True])

    ms, issue_ms = cuda_ms(lambda: split_gain.split_gain_cuda(panel),
                           iters=200)
    plain_ms, _ = cuda_ms(lambda: ref.split_gain_ref(panel), iters=20)
    b_ms, b_by = split_gain_bound_ms(TRAIN_NODES * TRAIN_FEATURES, TRAIN_BINS)
    gain_timing = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       floor_ms=floor_ms)
    emit("time", kernel="split_gain",
         shape=dict(n_nodes=TRAIN_NODES, f=TRAIN_FEATURES, nbins=TRAIN_BINS),
         **gain_timing)

    # 5. serve ------------------------------------------------------------
    argv = ["--device", "cuda", "--trees", str(TREES), "--depth", str(DEPTH),
            "--features", str(FEATURES), "--candidates", str(CANDIDATES),
            "--microbatch", str(MICROBATCH), "--requests", str(REQUESTS)]
    launches, chunk_launches = {}, {}
    for binned in (False, True):
        traverse.launches = traverse.forest_launches = 0
        report = serve_gbdt.main(argv + (["--binned"] if binned else []))
        launches[binned] = traverse.forest_launches
        chunk_launches[binned] = traverse.launches
        check(launches[binned] == REQUESTS + WARMUP_REQUESTS
              and chunk_launches[binned] == 0,
              f"binned={binned}: {launches[binned]} forest-sum and "
              f"{chunk_launches[binned]} per-tree launches for "
              f"{REQUESTS + WARMUP_REQUESTS} requests, want one forest-sum "
              "launch a request and no per-tree launch")
        emit("serve", binned=binned, launches=launches[binned],
             launches_per_request=1, per_tree_launches=chunk_launches[binned],
             engine=report.engine, summary=report.summarize())

    model = serve_gbdt.synthetic_gbdt(
        n_trees=TREES, max_depth=DEPTH, n_features=FEATURES,
        n_candidates=CANDIDATES, seed=0, device="cuda")
    cpu_model = model.to("cpu")
    # the first request of serve(seed=0), and the same rows with NaNs
    xb = np.random.default_rng(0).normal(
        size=(MICROBATCH, FEATURES)).astype(np.float32)
    x_nan = xb.copy()
    x_nan[::97, 3] = np.nan
    x_nan[7, :] = np.nan
    for name, x in (("first_request", xb), ("nan_rows", x_nan)):
        bins = model.bin_features(x)
        check(torch.equal(bins.cpu(), cpu_model.bin_features(x)),
              f"{name}: bin ids differ from the CPU's")
        for binned in (False, True):
            m = model.predict(x, output="margin", binned=binned)
            m_cpu = cpu_model.predict(x, output="margin", binned=binned)
            check(m.shape == (MICROBATCH,) and bool(torch.isfinite(m).all()),
                  f"{name}: margins not finite of shape ({MICROBATCH},)")
            check(torch.equal(m.cpu(), m_cpu),
                  f"{name} binned={binned}: margins differ from the CPU "
                  f"model's (max_abs_err="
                  f"{float((m.cpu() - m_cpu).abs().max())})")
    emit("serve_check", margins_equal_cpu=True, bin_ids_equal_cpu=True,
         rows=MICROBATCH, nan_rows=True)

    # where a raw request's device time goes, by kernel
    x_dev = torch.from_numpy(xb).cuda()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            model.predict(x_dev, output="margin")
        torch.cuda.synchronize()
    rows = by_kernel(prof, 4, "request")
    t0 = time.perf_counter()
    for _ in range(4):
        model.predict(x_dev, output="margin")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 4 * 1e3
    device_us = sum(r["device_us_per_request"] for r in rows)
    emit("profile", requests=4, binned=False, wall_ms_per_request=wall_ms,
         device_us_per_request=device_us,
         device_idle_share=1 - device_us / 1e3 / wall_ms,
         kernel_launches_per_request=sum(r["count"] for r in rows) / 4,
         by_kernel=rows[:8])

    # 6. train ------------------------------------------------------------
    x, y = tabular.gaussian_classification(TRAIN_ROWS + HOLDOUT_ROWS,
                                           TRAIN_FEATURES, seed=0)
    x_dev, y_dev = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    x_tr, y_tr = x_dev[:TRAIN_ROWS], y_dev[:TRAIN_ROWS]
    x_ho, y_ho = x_dev[TRAIN_ROWS:], y_dev[TRAIN_ROWS:]
    reset, read = reset_counts, read_counts

    train_launches = {}
    forests = {}
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        # warm-up: the allocator's first growth and the first launches
        fit(x_tr, y_tr, dataclasses.replace(cfg, n_trees=1),
            torch.Generator(device="cuda").manual_seed(1), device="cuda")
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        model = fit(x_tr, y_tr, cfg,
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
        wall = time.perf_counter() - t0
        n_hist, n_left, n_gain, n_trav, n_forest, n_flash = read()
        per_fit = TRAIN_TREES * TRAIN_DEPTH
        check((n_left if subtract else n_hist) == per_fit
              and (n_hist if subtract else n_left) == 0
              and n_gain == per_fit and n_trav + n_forest == 0
              and n_flash == 0,
              f"subtract={subtract}: launches hist {n_hist}, hist_left "
              f"{n_left}, split_gain {n_gain}, traverse {n_trav}; want "
              f"{per_fit} of the fit's histogram mode and {per_fit} "
              "split_gain")
        train_launches[subtract] = dict(hist=n_left if subtract else n_hist,
                                        split_gain=n_gain)
        forests[subtract] = model.forest
        # the same fit again from the same seed: the same forest, bit for
        # bit (fixed-point histogram and leaf sums)
        again = fit(x_tr, y_tr, cfg,
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda").forest
        equal_fields = {name: torch.equal(a, b) for name, a, b in
                        zip(model.forest._fields, model.forest, again)}
        check(all(equal_fields.values()), f"subtract={subtract}: two fits "
              f"from one seed differ on the card: {equal_fields}")
        emit("train_repeat", subtract=subtract, rows=TRAIN_ROWS,
             n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
             fields_equal=equal_fields)
        del again
        check(all(bool(torch.isfinite(a).all()) for a in
                  (model.forest.leaf_value, model.candidates)),
              f"subtract={subtract}: non-finite leaves or candidates")
        first = dataclasses.replace(model, forest=tree_lib.Forest(
            *(a[:1] for a in model.forest)))
        loss_first = logloss(first.predict(x_tr, output="margin"), y_tr)
        loss_last = logloss(model.predict(x_tr, output="margin"), y_tr)
        traverse.forest_launches = 0
        acc = accuracy(model, x_ho, y_ho)
        check(traverse.forest_launches == 1,
              f"holdout predict made {traverse.forest_launches} forest-sum "
              "launches, want 1")
        check(loss_last < loss_first and acc > 0.6,
              f"subtract={subtract}: logloss {loss_first} -> {loss_last}, "
              f"holdout accuracy {acc}")
        emit("train", subtract=subtract, rows=TRAIN_ROWS,
             holdout_rows=HOLDOUT_ROWS, features=TRAIN_FEATURES,
             n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
             n_candidates=TRAIN_CANDIDATES, reduced=["rows: 11M -> 1M"],
             fit_seconds=wall, model_fit_seconds=model.fit_seconds,
             ms_per_round=wall / TRAIN_TREES * 1e3,
             launches=dict(hist_levels=n_hist, hist_levels_left=n_left,
                           split_gain=n_gain),
             train_logloss_first=loss_first, train_logloss_last=loss_last,
             holdout_accuracy=acc,
             holdout_forest_sum_launches=traverse.forest_launches)
    same = float((forests[False].feature == forests[True].feature)
                 .to(torch.float32).mean())

    # where a fit's device time goes, by kernel and by host op
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=2, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fit(x_tr, y_tr, cfg,
                torch.Generator(device="cuda").manual_seed(0), device="cuda")
        rows = by_kernel(prof, cfg.n_trees, "round")
        t0 = time.perf_counter()
        fit(x_tr, y_tr, cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        wall_ms = (time.perf_counter() - t0) / cfg.n_trees * 1e3
        busy_ms = sum(r["device_us_per_round"] for r in rows) / 1e3
        emit("train_profile", rounds=cfg.n_trees, subtract=subtract,
             wall_ms_per_round=wall_ms, device_ms_per_round=busy_ms,
             device_idle_share=1 - busy_ms / wall_ms, by_kernel=rows[:10],
             by_op=by_kernel(prof, cfg.n_trees, "round", ops=True)[:12])
    emit("train_compare", direct_vs_subtract_same_features=same)

    # 7. train_check --------------------------------------------------------
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4000, 6)).astype(np.float32)
    ys = (xs @ rng.normal(size=6) > 0).astype(np.float32)
    g_cpu = torch.Generator().manual_seed(0)
    grid = torch.stack([proposal.random_candidates(
        g_cpu, torch.from_numpy(xs), 16) for _ in range(6)])
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                         subtract=subtract)
        card_model = fit(xs, ys, cfg, candidates=grid, device="cuda")
        cpu_model = fit(xs, ys, cfg, candidates=grid, device="cpu")
        on_card, on_cpu = card_model.forest, cpu_model.forest
        # the leaf contract: within 1e-5 of the CPU's leaves beyond the
        # CPU's own rounding (its row-order float32 sums' distance from the
        # exact sums, which the card's fixed-point sums do not share); and
        # the card's leaves within 1e-6 of their own exact sums
        cpu_rounding = leaf_rounding(cpu_model, xs, ys)
        card_rounding = float(leaf_rounding(card_model, xs, ys).max())
        leaf_diff = (on_card.leaf_value.cpu() - on_cpu.leaf_value).abs()
        leaf_err = float(leaf_diff.max())
        check(torch.equal(on_card.feature.cpu(), on_cpu.feature)
              and torch.equal(on_card.split_bin.cpu(), on_cpu.split_bin)
              and torch.equal(on_card.threshold.cpu(), on_cpu.threshold)
              and bool((leaf_diff.double() <= 1e-5 + cpu_rounding).all())
              and card_rounding <= 1e-6,
              f"subtract={subtract}: the card's forest differs from the "
              f"CPU's (leaf max_abs_err={leaf_err}, the CPU's own leaf "
              f"rounding up to {float(cpu_rounding.max())}, the card's "
              f"{card_rounding})")
        emit("train_check", subtract=subtract, rows=4000, features=6,
             n_trees=6, max_depth=4, n_candidates=16, structure_equal=True,
             leaf_max_abs_err=leaf_err,
             leaf_tolerance="1e-5 + the CPU's own leaf rounding",
             cpu_leaf_rounding_max=float(cpu_rounding.max()),
             card_leaf_rounding_max=card_rounding)

    # train_vs_cpu: the training cell's rows, two trees from one grid
    t_phase = time.perf_counter()
    x_cpu, y_cpu = torch.from_numpy(x[:TRAIN_ROWS]), torch.from_numpy(
        y[:TRAIN_ROWS])
    g_cpu = torch.Generator().manual_seed(3)
    grid = torch.stack([proposal.random_candidates(
        g_cpu, x_cpu, TRAIN_CANDIDATES) for _ in range(2)])
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=2, max_depth=VS_CPU_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        on_card = fit(x_tr, y_tr, cfg, candidates=grid, device="cuda")
        on_cpu = fit(x_cpu, y_cpu, cfg, candidates=grid, device="cpu")
        card_forest = tree_lib.Forest(*(a.cpu() for a in on_card.forest))
        trees = [first_difference(card_forest, on_cpu, t, x_cpu, y_cpu)
                 for t in range(cfg.n_trees)]
        emit("train_vs_cpu", subtract=subtract, rows=TRAIN_ROWS,
             features=TRAIN_FEATURES, n_trees=cfg.n_trees,
             max_depth=cfg.max_depth, n_candidates=TRAIN_CANDIDATES,
             checked=False, same_split_features=float(
                 (card_forest.feature == on_cpu.forest.feature)
                 .to(torch.float32).mean()),
             same_trees=[t["equal"] for t in trees], trees=trees,
             leaf_max_abs_err=float((card_forest.leaf_value
                                     - on_cpu.forest.leaf_value)
                                    .abs().max()),
             seconds=time.perf_counter() - t_phase)

    # 8. propose_check ------------------------------------------------------
    # the card's weighted_quantile and uniform_range grids against the CPU
    # port's, bit for bit: at the training cell with the hessian after one
    # logistic round, and on a ties set with -0.0, NaN and zero weights
    t_phase = time.perf_counter()
    one = fit(x_tr, y_tr, GBDTConfig(n_trees=1, max_depth=TRAIN_DEPTH,
                                     n_candidates=TRAIN_CANDIDATES),
              torch.Generator(device="cuda").manual_seed(0), device="cuda")
    _, h1 = boosting.grad_hess(one.predict(x_tr, output="margin"), y_tr,
                               "logistic")
    x_ties, h_ties = (torch.from_numpy(a).cuda() for a in ties_case(
        TIES_ROWS, TIES_FEATURES, seed=0))
    prop_cases = {"training_cell": (x_tr, h1, (TRAIN_CANDIDATES,)),
                  "ties": (x_ties, h_ties, (TRAIN_CANDIDATES, 255))}
    prop_equal = {}
    for name, (xg, hg, ks) in prop_cases.items():
        xc, hc = xg.cpu(), hg.cpu()
        for k in ks:
            for strategy in ("weighted_quantile", "uniform_range"):
                card = proposal.propose(strategy, xg, k, hess=hg)
                cpu = proposal.propose(strategy, xc, k, hess=hc)
                differ = grid_differences(card.cpu(), cpu)
                check(card.device.type == "cuda" and differ == 0,
                      f"propose_check: {strategy} k={k} on {name}: {differ} "
                      "of the card's candidates differ from the CPU port's")
                prop_equal[f"{name}/{strategy}/k={k}"] = True
    # the signed-zero question: the card's stable sort of the raw values
    # against the CPU's, with every NaN made the positive NaN (so only the
    # zeros can order apart) and as they are; and the port's order
    # (``sketch.stable_order``) on both
    cols = x_ties.T
    raw_differ = {}
    for name, keys in (("nan_positive", torch.where(
            torch.isnan(cols), float("nan"), cols)), ("as_is", cols)):
        raw_card = torch.sort(keys, dim=1, stable=True)
        raw_cpu = torch.sort(keys.cpu(), dim=1, stable=True)
        raw_differ[name] = {
            "positions": int((raw_card.indices.cpu() != raw_cpu.indices)
                             .sum()),
            "card": sort_stats(raw_card.values.cpu()),
            "cpu": sort_stats(raw_cpu.values)}
    order_equal = torch.equal(sketch.stable_order(cols).cpu(),
                              sketch.stable_order(cols.cpu()))
    check(order_equal, "propose_check: sketch.stable_order differs between "
          "the card and the CPU")
    emit("propose_check", rows=TRAIN_ROWS, features=TRAIN_FEATURES,
         hessian="logistic, after one round", ties_rows=TIES_ROWS,
         ties_features=TIES_FEATURES, equal_bits=prop_equal,
         raw_stable_sort_card_vs_cpu=raw_differ,
         stable_order_equal_cpu=order_equal,
         seconds=time.perf_counter() - t_phase)
    del x_ties, h_ties, cols

    # 9. propose_time -------------------------------------------------------
    # each strategy's proposal alone: the device ones with CUDA events at
    # the training cell, the host ones on the host clock at
    # bench_proposal_time.py's cuts (and random on the card at the same)
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = TRAIN_CANDIDATES
    prop_ms = {
        "random": cuda_ms(lambda: proposal.random_candidates(gen, x_tr, k),
                          iters=200)[0],
        "weighted_quantile": cuda_ms(
            lambda: proposal.weighted_quantile_candidates(x_tr, h1, k),
            iters=20, warmup=3)[0],
        "uniform_range": cuda_ms(
            lambda: proposal.uniform_range_candidates(x_tr, k), iters=100)[0],
    }
    host_ms, random_at_cut_ms = {}, {}
    x_host = x[:HOST_ROWS]
    for strategy, f_cut in (("gk_quantile", GK_FEATURES),
                            ("exact", TRAIN_FEATURES)):
        fn = getattr(proposal, f"{strategy}_candidates")
        t0 = time.perf_counter()
        fn(x_host[:, :f_cut], k)
        host_ms[strategy] = (time.perf_counter() - t0) * 1e3
        xs = x_tr[:HOST_ROWS, :f_cut]
        random_at_cut_ms[strategy] = cuda_ms(
            lambda: proposal.random_candidates(gen, xs, k), iters=200)[0]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            proposal.weighted_quantile_candidates(x_tr, h1, k)
        torch.cuda.synchronize()
    emit("propose_time", rows=TRAIN_ROWS, features=TRAIN_FEATURES,
         n_candidates=k, device_ms=prop_ms, floor_ms=floor_ms,
         t_q_over_t_s=prop_ms["weighted_quantile"] / prop_ms["random"],
         t_uniform_over_t_s=prop_ms["uniform_range"] / prop_ms["random"],
         host_ms=host_ms,
         host_cuts={"gk_quantile": [HOST_ROWS, GK_FEATURES],
                    "exact": [HOST_ROWS, TRAIN_FEATURES]},
         random_device_ms_at_host_cuts=random_at_cut_ms,
         t_host_over_t_s={s: host_ms[s] / random_at_cut_ms[s]
                          for s in host_ms},
         weighted_quantile_by_op=by_kernel(prof, 3, "call", ops=True)[:10],
         weighted_quantile_by_kernel=by_kernel(prof, 3, "call")[:8],
         seconds=time.perf_counter() - t_phase)

    # 10. table2 ------------------------------------------------------------
    # the paper's comparison at the training cell: a fit per strategy,
    # through the same kernels; the host strategies at HOST_ROWS rows
    t_phase = time.perf_counter()
    path_launches = {}
    table = {}

    def fit_checked(strategy, xf, yf, path, fitter=fit, **kw):
        """A fit at ``xf``: the counts reset just before it and read just
        after, max_depth histogram and split-gain launches a tree."""
        cfg = GBDTConfig(n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, strategy=strategy,
                         **kw)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        model = fitter(xf, yf, cfg, torch.Generator(device="cuda")
                       .manual_seed(0), device="cuda")
        wall = time.perf_counter() - t0
        n_hist, n_left, n_gain, n_trav, n_forest, n_flash = read()
        per_fit = TRAIN_TREES * TRAIN_DEPTH
        n_mode, n_other = ((n_left, n_hist) if cfg.subtract
                           else (n_hist, n_left))
        check(n_mode == per_fit and n_gain == per_fit
              and n_other + n_trav + n_forest + n_flash == 0,
              f"{path}: launches hist {n_hist}, hist_left {n_left}, "
              f"split_gain {n_gain}, traverse {n_trav + n_forest}, flash "
              f"{n_flash}; want {per_fit} of the fit's histogram mode and "
              f"{per_fit} split-gain launches")
        path_launches[path] = {
            "hist_levels_left" if cfg.subtract else "hist_levels": n_mode,
            "split_gain": n_gain}
        return model, wall

    def holdout(model):
        traverse.forest_launches = 0
        acc = accuracy(model, x_ho, y_ho)
        check(traverse.forest_launches == 1, "holdout predict made "
              f"{traverse.forest_launches} forest-sum launches, want 1")
        return acc, logloss(model.predict(x_ho, output="margin"), y_ho)

    for strategy, rows in (("random", TRAIN_ROWS),
                           ("weighted_quantile", TRAIN_ROWS),
                           ("uniform_range", TRAIN_ROWS),
                           ("random", HOST_ROWS), ("gk_quantile", HOST_ROWS),
                           ("exact", HOST_ROWS)):
        xf, yf = x_tr[:rows], y_tr[:rows]
        path = f"table2/{strategy}/{rows}"
        traceable = strategy in proposal.TRACEABLE
        if rows == TRAIN_ROWS:     # warm-up: the strategy's first launches
            fit(xf, yf, GBDTConfig(n_trees=1, max_depth=TRAIN_DEPTH,
                                   n_candidates=TRAIN_CANDIDATES,
                                   strategy=strategy),
                torch.Generator(device="cuda").manual_seed(1), device="cuda")
        model, wall = fit_checked(strategy, xf, yf, path)
        acc, ho_loss = holdout(model)
        check(acc > 0.6 and np.isfinite(ho_loss),
              f"{path}: holdout accuracy {acc}, logloss {ho_loss}")
        row = dict(strategy=strategy, rows=rows, fit_seconds=wall,
                   model_fit_seconds=model.fit_seconds,
                   proposal_seconds=model.proposal_seconds,
                   candidates_shape=list(model.candidates.shape),
                   launches=path_launches[path], holdout_accuracy=acc,
                   holdout_logloss=ho_loss)
        if traceable:
            # fit_reference times every proposal, the card synchronised
            # around each; it must give fit's forest
            ref_model, ref_wall = fit_checked(strategy, xf, yf,
                                              path + "/reference",
                                              fitter=fit_reference)
            equal = all(torch.equal(a, b) for a, b in zip(model.forest,
                                                          ref_model.forest))
            check(equal, f"{path}: fit_reference's forest differs from "
                  "fit's")
            row.update(proposal_seconds=ref_model.proposal_seconds,
                       proposal_seconds_from="fit_reference",
                       reference_fit_seconds=ref_wall,
                       reference_forest_equal=equal)
        if strategy == "weighted_quantile":
            again = fit(xf, yf, model.config, torch.Generator(
                device="cuda").manual_seed(0), device="cuda").forest
            equal_fields = {name: torch.equal(a, b) for name, a, b in
                            zip(model.forest._fields, model.forest, again)}
            check(all(equal_fields.values()), f"{path}: two fits from one "
                  f"seed differ on the card: {equal_fields}")
            emit("train_repeat", strategy=strategy, subtract=False,
                 rows=rows, n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
                 fields_equal=equal_fields)
            del again
        table[path] = row
        emit("table2", reduced=["rows: 11M -> 1M"] if rows == TRAIN_ROWS
             else [f"rows: 11M -> {rows} (a host strategy's proposal is "
                   "pure-Python numpy)"], **row)
        del model
    # where a weighted-quantile round's device time goes
    cfg = GBDTConfig(n_trees=2, max_depth=TRAIN_DEPTH,
                     n_candidates=TRAIN_CANDIDATES,
                     strategy="weighted_quantile")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fit(x_tr, y_tr, cfg, device="cuda")
    rows = by_kernel(prof, cfg.n_trees, "round")
    t0 = time.perf_counter()
    fit(x_tr, y_tr, cfg, device="cuda")
    wall_ms = (time.perf_counter() - t0) / cfg.n_trees * 1e3
    busy_ms = sum(r["device_us_per_round"] for r in rows) / 1e3
    emit("train_profile", rounds=cfg.n_trees, strategy=cfg.strategy,
         subtract=False, wall_ms_per_round=wall_ms,
         device_ms_per_round=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
         by_kernel=rows[:10],
         by_op=by_kernel(prof, cfg.n_trees, "round", ops=True)[:14])
    s_row = table[f"table2/random/{TRAIN_ROWS}"]
    q_row = table[f"table2/weighted_quantile/{TRAIN_ROWS}"]
    emit("table2_summary", rows=TRAIN_ROWS,
         accuracy={p[len("table2/"):]: r["holdout_accuracy"]
                   for p, r in table.items()},
         accuracy_gap_random_vs_weighted_quantile=abs(
             s_row["holdout_accuracy"] - q_row["holdout_accuracy"]),
         fit_seconds_random=s_row["fit_seconds"],
         fit_seconds_weighted_quantile=q_row["fit_seconds"],
         proposal_seconds_random=s_row["proposal_seconds"],
         proposal_seconds_weighted_quantile=q_row["proposal_seconds"],
         t_q_over_t_s_device=prop_ms["weighted_quantile"] / prop_ms["random"],
         seconds=time.perf_counter() - t_phase)

    # 11. telemetry ---------------------------------------------------------
    # a fit with telemetry gives the plain fit's forest; fits timed in
    # turns (off, on, on, off)
    t_phase = time.perf_counter()
    walls = {False: [], True: []}
    models = {}
    for on in (False, True, True, False):
        model, wall = fit_checked("random", x_tr, y_tr,
                                  f"telemetry/{'on' if on else 'off'}",
                                  telemetry=on)
        walls[on].append(wall)
        models[on] = model
    equal = all(torch.equal(a, b) for a, b in zip(models[False].forest,
                                                  models[True].forest))
    check(equal, "telemetry: the forest with telemetry differs from the "
          "forest without it")
    report = models[True].report
    check(report is not None and report.n_rounds == TRAIN_TREES
          and report.train_loss.device.type == "cuda"
          and bool(torch.isfinite(report.train_loss).all()),
          "telemetry: no report of TRAIN_TREES finite rounds on the card")
    sub, _ = fit_checked("random", x_tr, y_tr, "telemetry/subtract",
                         telemetry=True, subtract=True)
    updates = {"direct": float(report.hist_updates.double().sum()),
               "subtract": float(sub.report.hist_updates.double().sum())}
    check(updates["subtract"] < updates["direct"]
          == TRAIN_TREES * TRAIN_DEPTH * TRAIN_ROWS * TRAIN_FEATURES,
          f"telemetry: histogram updates {updates}; want n f depth a tree "
          "direct, fewer subtract")
    emit("telemetry", rows=TRAIN_ROWS, forest_equal=equal,
         fit_seconds_off=walls[False], fit_seconds_on=walls[True],
         summary=report.summarize(), hist_updates=updates,
         hist_updates_subtract_over_direct=updates["subtract"]
         / updates["direct"], seconds=time.perf_counter() - t_phase)
    del models, sub, report

    # 12. rank_error --------------------------------------------------------
    # Fig. 2 on the card (the quickstart's sizes), against Theorem 1 within
    # tests/test_rank_error.py's bounds; run twice (the first is cold)
    fig2_seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        fig2 = rank_error.fig2_experiment(seed=0, **FIG2, device="cuda")
        fig2_seconds.append(time.perf_counter() - t0)
    rel = {name: [v / t - 1 for v, t in zip(fig2[name], fig2["theory"])]
           for name in ("random", "quantile")}
    check(all(abs(r) <= 0.5 for r in rel["random"])
          and all(abs(q) <= 0.6 for q in rel["quantile"]),
          f"rank_error: Fig. 2 outside Theorem 1's bounds (rel 0.5 random, "
          f"0.6 quantile): {fig2}")
    emit("rank_error", **FIG2, seed=0, **fig2, rel_to_theory=rel,
         bounds={"random": 0.5, "quantile": 0.6}, seconds=fig2_seconds)

    # 13. quickstart --------------------------------------------------------
    t0 = time.perf_counter()
    qs = quickstart.main(["--device", "cuda"])
    qs_acc = {s: r["acc"] for s, r in qs["table2"].items()}
    check(all(a > 0.6 for a in qs_acc.values()),
          f"quickstart: holdout accuracy {qs_acc}")
    emit("quickstart", device=qs["device"], accuracy=qs_acc,
         fit_seconds={s: r["fit_s"] for s, r in qs["table2"].items()},
         accuracy_gap=abs(qs_acc["random"] - qs_acc["weighted_quantile"]),
         report=qs["report"], fig2=qs["fig2"],
         seconds=time.perf_counter() - t0)

    # 14. dist_check --------------------------------------------------------
    # the histogram kernel on a shared grid with raw sums, against its
    # fixed-point emulation given the same; then the distributed fits of
    # the 4000 x 6 set at 1, 3 (padded) and 8 ranks, every forest field
    # equal across them, against the single-card fit
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    grid_cases = 0
    for child in (False, True):
        for n, f, nbins, n_nodes, L in (
                (4097, 6, 17, 8, 1), (20_000, TRAIN_FEATURES, TRAIN_BINS,
                                      TRAIN_NODES, TRAIN_DEPTH),
                (TRAIN_ROWS // EXAMPLE_WORKERS, TRAIN_FEATURES, TRAIN_BINS,
                 TRAIN_NODES, 1)):
            if child:
                n_nodes //= 2
            bins, node, _, gh = hist_case(gen, n=n, f=f, nbins=nbins,
                                          n_nodes=n_nodes, L=L, child=child)
            kernel = (hist.hist_levels_left_cuda if child
                      else hist.hist_levels_cuda)
            kw = dict(n_nodes=n_nodes, nbins=nbins)
            log2n = ref.log2_ceil(n)
            # the launch's own grid, a larger maximum and more rows (as
            # another rank's would give), raw and rounded
            for bits, lg in ((ref.max_bits(gh), log2n),
                             (ref.max_bits(3 * gh), log2n + 3)):
                for raw in (False, True):
                    got = kernel(bins, node, gh, bits=bits, log2n=lg,
                                 raw=raw, **kw)
                    want = ref.hist_levels_fixed(bins, node, gh, bits=bits,
                                                 log2n=lg, raw=raw,
                                                 child=child, **kw)
                    torch.cuda.synchronize()
                    if child:
                        check(torch.equal(got[1], want[1]), "dist_check: "
                              f"shared-grid row counts differ (n={n})")
                        got, want = got[0], want[0]
                    check(same_bits(got, want), f"dist_check: the kernel "
                          f"on a shared grid (child={child}, n={n}, raw="
                          f"{raw}) differs from ref.hist_levels_fixed")
                    grid_cases += 1
            # three 'ranks' of these rows, a NaN g on the second: their
            # raw sums on the shared grid add up to one launch over all
            g_nan = gh.clone()
            g_nan[n // 2, 0] = float("nan")
            cut = [0, n // 3, 2 * n // 3, n]
            parts = [slice(a, b) for a, b in zip(cut, cut[1:]) if b > a]
            bits = torch.stack([ref.max_bits(g_nan[sl])
                                for sl in parts]).amax(0)
            total = cnt = 0
            for sl in parts:
                out = kernel(bins[sl].contiguous(), node[:, sl].contiguous(),
                             g_nan[sl].contiguous(), bits=bits, log2n=log2n,
                             raw=True, **kw)
                if child:
                    out, c = out
                    cnt = cnt + c
                total = total + out
            one = kernel(bins, node, g_nan, **kw)
            want = ref.hist_levels_fixed(bins, node, g_nan, child=child, **kw)
            torch.cuda.synchronize()
            if child:
                check(torch.equal(cnt, one[1]) and torch.equal(cnt, want[1]),
                      "dist_check: summed row counts differ")
                one, want = one[0], want[0]
            summed = ref.from_fixed(total, bits, log2n)
            check(same_bits(summed, one) and same_bits(summed, want)
                  and bool(torch.isnan(summed[..., 0]).all())
                  and bool(torch.isfinite(summed[..., 1]).all()),
                  f"dist_check: three ranks' raw sums (a NaN g on one) differ "
                  f"from one launch (child={child}, n={n})")
            grid_cases += 1
    dist_runs, spawn_seconds = {}, {}
    for w in DIST_WORLDS:
        t0 = time.perf_counter()
        dist_runs[w] = dist_lib.run(
            dist_rank, w, ("check", "train") if w in (1, EXAMPLE_WORKERS)
            else ("check",), device="cuda")
        spawn_seconds[w] = time.perf_counter() - t0
    c = DIST_CHECK
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(c["rows"], c["features"])).astype(np.float32)
    ys = (xs @ rng.normal(size=c["features"]) > 0).astype(np.float32)
    dist_check = {}
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=c["n_trees"], max_depth=c["max_depth"],
                         n_candidates=c["n_candidates"],
                         strategy="uniform_range", subtract=subtract)
        single = [a.cpu() for a in fit(xs, ys, cfg, device="cuda").forest]
        forests = {w: r["check"][subtract]["forest"]
                   for w, r in dist_runs.items()}
        first = forests[DIST_WORLDS[0]]
        equal = {w: all(torch.equal(a, b) for a, b in zip(first, fw))
                 for w, fw in forests.items()}
        leaf_err = float((single[3] - first[3]).abs().max())
        per_tree = cfg.max_depth * cfg.n_trees
        dist_launches = {w: r["check"][subtract]["launches"]
                    for w, r in dist_runs.items()}
        check(all(equal.values()), f"dist_check subtract={subtract}: the "
              f"forests differ across world sizes: {equal}")
        check(torch.equal(single[0], first[0]) and torch.equal(single[1],
                                                               first[1])
              and leaf_err <= 1e-4, f"dist_check subtract={subtract}: the "
              f"distributed forest differs from the single-card fit "
              f"(leaf max_abs_err={leaf_err})")
        check(all(v[0] == per_tree and v[1] == per_tree and v[2] == 2
                  * per_tree for ls in dist_launches.values() for v in ls),
              f"dist_check subtract={subtract}: launches {dist_launches}, "
              f"want {per_tree} of the histogram's mode and of split gain "
              "on every rank")
        mode = "hist_levels_left" if subtract else "hist_levels"
        for w, ls in dist_launches.items():
            path = f"dist_check/W{w}/{'subtract' if subtract else 'direct'}"
            path_launches[path] = {mode: [v[0] for v in ls],
                                   "split_gain": [v[1] for v in ls]}
        dist_check[subtract] = dict(equal_across_world_sizes=equal,
                                    structure_equal_single_card=True,
                                    leaf_max_abs_err_vs_single_card=leaf_err,
                                    launches_per_rank=dist_launches)
    emit("dist_check", worlds=list(DIST_WORLDS), **DIST_CHECK,
         strategy="uniform_range", kernel_shared_grid_cases=grid_cases,
         direct=dist_check[False], subtract=dist_check[True],
         leaf_tolerance_vs_single_card=1e-4,
         run_seconds_by_world=spawn_seconds,
         seconds=time.perf_counter() - t_phase)

    # 15. dist_train --------------------------------------------------------
    # the training cell at 1 and 8 ranks (one card: NCCL at 1, gloo over
    # CUDA tensors at 8)
    t_phase = time.perf_counter()
    trains = {w: dist_runs[w]["train"] for w in (1, EXAMPLE_WORKERS)}
    per_tree = TRAIN_DEPTH * TRAIN_TREES
    for w, runs in trains.items():
        for name, row in runs.items():
            if name in ("profile", "collective_ms"):
                continue
            check(all(v[0] == per_tree and v[1] == per_tree
                      and v[2] == 2 * per_tree for v in row["launches"]),
                  f"dist_train W={w} {name}: launches {row['launches']}, "
                  f"want {per_tree} histogram and {per_tree} split-gain on "
                  "every rank")
            mode = ("hist_levels_left" if name.endswith("subtract")
                    else "hist_levels")
            path_launches[f"dist_train/W{w}/{name}"] = {
                mode: [v[0] for v in row["launches"]],
                "split_gain": [v[1] for v in row["launches"]]}
    uniform_equal = {}
    for mode in ("direct", "subtract"):
        a = trains[1][f"uniform_range/{mode}"]["forest"]
        b = trains[EXAMPLE_WORKERS][f"uniform_range/{mode}"]["forest"]
        uniform_equal[mode] = {f: torch.equal(u, v) for f, u, v in
                               zip(tree_lib.Forest._fields, a, b)}
        check(all(uniform_equal[mode].values()), f"dist_train uniform_range "
              f"{mode}: W=1 and W={EXAMPLE_WORKERS} differ: "
              f"{uniform_equal[mode]}")
    w8 = trains[EXAMPLE_WORKERS]
    repeat_equal = {f: torch.equal(u, v) for f, u, v in zip(
        tree_lib.Forest._fields, w8["random/direct"]["forest"],
        w8["random/again/direct"]["forest"])}
    check(all(repeat_equal.values()), f"dist_train: two random fits from "
          f"one seed differ: {repeat_equal}")
    dist_acc = {}
    for strategy in ("random", "weighted_quantile"):
        row = w8[f"{strategy}/direct"]
        single_acc = table[f"table2/{strategy}/{TRAIN_ROWS}"][
            "holdout_accuracy"]
        dist_acc[strategy] = dict(distributed=row["holdout_accuracy"],
                                  single_card=single_acc)
        check(abs(row["holdout_accuracy"] - single_acc) <= 0.03
              and row["holdout_forest_sum_launches"] == 1
              and row["summary"]["train_loss"]["final"]
              < row["summary"]["train_loss"]["first"],
              f"dist_train {strategy}: holdout accuracy "
              f"{row['holdout_accuracy']} against the single card's "
              f"{single_acc} (bound 0.03), loss "
              f"{row['summary']['train_loss']}")
    emit("dist_train", rows=TRAIN_ROWS, features=TRAIN_FEATURES,
         n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
         n_candidates=TRAIN_CANDIDATES, reduced=["rows: 11M -> 1M"],
         worlds=[1, EXAMPLE_WORKERS], backends={
             w: dist_lib.backend_for("cuda", w) for w in (1, EXAMPLE_WORKERS)},
         uniform_range_equal_w1_w8=uniform_equal,
         random_repeat_equal=repeat_equal, accuracy=dist_acc,
         single_card_fit_seconds={
             s: table[f"table2/{s}/{TRAIN_ROWS}"]["fit_seconds"]
             for s in ("random", "weighted_quantile", "uniform_range")},
         runs={f"W{w}/{name}": {k: v for k, v in row.items()
                                if k != "forest"}
               for w, runs in trains.items() for name, row in runs.items()
               if name not in ("profile", "collective_ms")},
         collective_ms={w: runs["collective_ms"] for w, runs in
                        trains.items()},
         seconds=time.perf_counter() - t_phase)
    emit("dist_profile", world=EXAMPLE_WORKERS, rank=0, strategy="random",
         **w8["profile"])
    del dist_runs, trains, w8

    # 16. dist_serve --------------------------------------------------------
    t_phase = time.perf_counter()
    served = dist_lib.run(dist_serve_rank, DIST_SERVE_SHARDS, device="cuda")
    check(all(served["margins_equal"]) and len(served["margins_equal"])
          == REQUESTS, "dist_serve: sharded margins differ from unsharded "
          f"serving ({served['margins_equal']})")
    check(all(v[0] == REQUESTS + WARMUP_REQUESTS and v[1] == 0
              for v in served["launches"]), f"dist_serve: launches "
          f"{served['launches']} (forest sum, per tree) on the ranks, want "
          "one forest-sum launch a request on each")
    emit("dist_serve", data_shards=DIST_SERVE_SHARDS, backend=dist_lib.
         backend_for("cuda", DIST_SERVE_SHARDS), trees=TREES, depth=DEPTH,
         features=FEATURES, microbatch=MICROBATCH, requests=REQUESTS,
         margins_bit_identical=True, launches_per_rank=served["launches"],
         engine=served["engine"], summary=served["summary"],
         seconds=time.perf_counter() - t_phase)

    # 17. dist_example ------------------------------------------------------
    t_phase = time.perf_counter()
    example = distributed_gbdt.main(["--workers", str(EXAMPLE_WORKERS),
                                     "--device", "cuda"])
    ex = example["results"]
    check(all(r["acc"] > 0.6 for r in ex.values())
          and all(ex[s]["loss_final"] < ex[s]["loss_first"]
                  for s in distributed_gbdt.STRATEGIES),
          f"dist_example: {ex}")
    emit("dist_example", **example, seconds=time.perf_counter() - t_phase)

    # 18. attn_check -------------------------------------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def attn_case(b, hq, hkv, sq, d, dtype):
        return [torch.randn((b, h, sq, d), generator=gen, device="cuda")
                .to(dtype) for h in (hq, hkv, hkv)]

    attn_err = dict.fromkeys(flash.VARIANTS, 0.0)
    attn_share = dict.fromkeys(flash.VARIANTS, 0.0)   # of the tolerance
    attn_err_d80 = dict.fromkeys(flash.VARIANTS, 0.0)
    attn_share_d80 = dict.fromkeys(flash.VARIANTS, 0.0)
    cases = [(2, hq, hkv, sq, causal, window)
             # MHA, GQA, MQA, a group of 16
             for hq, hkv in ((4, 4), (8, 2), (8, 1), (16, 1))
             for causal, window in ((True, 0), (True, 128), (True, 200),
                                    (True, 1), (False, 0))
             for sq in (128, 384)]
    cases += [(1, 4, 2, 2048, True, 0), (1, 4, 2, 2048, True, 200)]
    # 512 (head, query tile) items, more than the card has SMs: each block
    # of the persistent Hopper kernel walks several, reloading Q
    cases += [(2, 32, 32, 1024, True, 0)]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(2 * 32 * 1024 // 128 > n_sms, f"attn_check: 512 work items do "
          f"not outnumber the card's {n_sms} SMs")
    n_attn = 0
    for b, hq, hkv, sq, causal, window in cases:
        for d in flash.HEAD_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = attn_case(b, hq, hkv, sq, d, dtype)
                name = flash.variant(dtype, d)
                before = flash.launches_by_variant[name]
                got = flash.flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window)
                torch.cuda.synchronize()
                ok, err, share = attn_within(got, q, k, v, causal=causal,
                                             window=window)
                check(ok and got.dtype == dtype and got.shape == q.shape
                      and flash.launches_by_variant[name] == before + 1,
                      f"flash kernel ({name}) != plain version (heads "
                      f"{hq}:{hkv}, causal={causal}, window={window}, "
                      f"d={d}, s={sq}, {dtype}, max_abs_err={err}, "
                      f"share of tolerance {share})")
                attn_err[name] = max(attn_err[name], err)
                attn_share[name] = max(attn_share[name], share)
                if d == 80:
                    attn_err_d80[name] = max(attn_err_d80[name], err)
                    attn_share_d80[name] = max(attn_share_d80[name], share)
                n_attn += 1
    # ragged causal lengths, as xla_chunked's blockwise path gives them:
    # padded to a multiple of 128 around one launch, sliced back
    ragged_err, ragged_share = {}, {}
    for sq, window in ((1000, 0), (1500, 0), (1000, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_case(1, 8, 2, sq, 128, dtype)
            name = flash.variant(dtype, 128)
            before = flash.launches_by_variant[name]
            got = ops.flash_attention(q, k, v, causal=True, window=window,
                                      ragged=True)
            torch.cuda.synchronize()
            ok, err, share = attn_within(got, q, k, v, causal=True,
                                         window=window)
            case = f"s={sq} window={window} {str(dtype)[6:]}"
            check(ok and got.shape == q.shape and got.dtype == dtype
                  and flash.launches_by_variant[name] == before + 1,
                  f"ragged flash ({name}, {case}) != plain version "
                  f"(max_abs_err={err}, share of tolerance {share})")
            ragged_err[case], ragged_share[case] = err, share
            n_attn += 1
    kv_check = kv_len_check(gen)
    n_attn += kv_check["cases"]
    # the moe prefill's shape: deepseek-moe-16b's MHA 16:16, 2 x 4096
    mha_cfg = get_config(MOE_ARCH)
    mq, mk, mv = attn_case(LM_BATCH, mha_cfg.n_heads, mha_cfg.n_kv_heads,
                           LM_SEQ, mha_cfg.head_dim, torch.bfloat16)
    moe_variant = flash.variant(mq.dtype, mha_cfg.head_dim)
    before = flash.launches_by_variant["wgmma_bf16"]
    got = flash.flash_attention_cuda(mq, mk, mv, causal=True)
    torch.cuda.synchronize()
    ok, moe_slice_err, moe_slice_share = attn_within(got, mq, mk, mv,
                                                     causal=True)
    check(ok and moe_variant == "wgmma_bf16" and got.shape == mq.shape
          and flash.launches_by_variant["wgmma_bf16"] == before + 1,
          f"flash kernel ({moe_variant}) != plain version at the moe "
          f"prefill shape {tuple(mq.shape)} (max_abs_err={moe_slice_err}, "
          f"share of tolerance {moe_slice_share}), or not on wgmma_bf16")
    del got, mq, mk, mv
    torch.cuda.empty_cache()
    lm_cfg = get_config(LM_ARCH)
    hq, hkv, d = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    q, k, v = attn_case(LM_BATCH, hq, hkv, LM_SEQ, d, torch.bfloat16)
    lm_variant = flash.variant(q.dtype, d)
    check(lm_variant == "wgmma_bf16", f"the prefill's attention would run "
          f"on {lm_variant}, not the Hopper kernel")
    got = flash.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    ok, slice_err, slice_share = attn_within(got, q, k, v, causal=True)
    check(ok, f"flash kernel != plain version at the prefill shape "
          f"(max_abs_err={slice_err}, share of tolerance {slice_share})")
    repeats["flash_attention"] = torch.equal(
        got, flash.flash_attention_cuda(q, k, v, causal=True))
    del got
    # the hybrid prefill's shape: zamba2-2.7b's MHA 32:32 at head dim 80
    # (2560 / 32), 2 x 4096, bf16: the Hopper kernel in column chunks of 32
    hyb_cfg = get_config(HYBRID_ARCH)
    hq_, hk_, hv_ = attn_case(LM_BATCH, hyb_cfg.n_heads, hyb_cfg.n_kv_heads,
                              LM_SEQ, hyb_cfg.head_dim, torch.bfloat16)
    hyb_variant = flash.variant(hq_.dtype, hyb_cfg.head_dim)
    before = flash.launches_by_variant["wgmma_bf16"]
    got = flash.flash_attention_cuda(hq_, hk_, hv_, causal=True)
    torch.cuda.synchronize()
    ok, hyb_slice_err, hyb_slice_share = attn_within(got, hq_, hk_, hv_,
                                                     causal=True)
    check(ok and hyb_variant == "wgmma_bf16" and got.shape == hq_.shape
          and flash.launches_by_variant["wgmma_bf16"] == before + 1,
          f"flash kernel ({hyb_variant}) != plain version at the hybrid "
          f"prefill shape {tuple(hq_.shape)} (max_abs_err={hyb_slice_err}, "
          f"share of tolerance {hyb_slice_share}), or not one wgmma_bf16 "
          "launch")
    repeats["flash_attention_d80"] = torch.equal(
        got, flash.flash_attention_cuda(hq_, hk_, hv_, causal=True))
    check(repeats["flash_attention_d80"], "flash kernel at the hybrid "
          "prefill shape: a second launch on the same inputs differs")
    del got
    emit("attn_check", cases=n_attn + 3, within_tolerance=True,
         tolerance={"f32": {"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
                    "bf16": {"abs": ATTN_F32_TOL,
                             "rel": ATTN_F32_TOL + BF16_STEP,
                             "plus": "ref.attention_rounding_bound"}},
         max_abs_err={**attn_err, "prefill_shape_wgmma_bf16": slice_err,
                      "moe_prefill_shape_wgmma_bf16": moe_slice_err,
                      "hybrid_prefill_shape_wgmma_bf16_d80": hyb_slice_err},
         max_share_of_tolerance={
             **attn_share, "prefill_shape_wgmma_bf16": slice_share,
             "moe_prefill_shape_wgmma_bf16": moe_slice_share,
             "hybrid_prefill_shape_wgmma_bf16_d80": hyb_slice_share},
         d80_by_variant={"max_abs_err": attn_err_d80,
                         "share_of_tolerance": attn_share_d80},
         repeat_equal={"d128": repeats["flash_attention"],
                       "d80": repeats["flash_attention_d80"]},
         ragged={"max_abs_err": ragged_err,
                 "share_of_tolerance": ragged_share},
         kv_len=kv_check,
         seconds=time.perf_counter() - t_phase)

    # 19. attn_time --------------------------------------------------------
    attn_timing = attn_time(q, k, v, variant=lm_variant)
    del q, k, v
    # the same at the hybrid prefill's shape (d = 80)
    hyb_timing = attn_time(hq_, hk_, hv_, variant=hyb_variant)
    del hq_, hk_, hv_
    # head dim 64 on the Hopper kernel: internvl2-1b's prefill (GQA 14:2
    # over 256 patches + 4096 tokens, causal); whisper-tiny's encoder (MHA
    # 6:6 over 1500 frames, no mask: q and K/V padded to 1536, the keys
    # bounded by kv_len) and its cross-attention (4096 tokens over the
    # 1500 frames); each held to the plain version, then timed
    vcfg, acfg = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    frames = acfg.n_frontend_tokens
    padded = -(-frames // flash.SEQ_MULTIPLE) * flash.SEQ_MULTIPLE
    enc_q = attn_case(LM_BATCH, acfg.n_heads, acfg.n_kv_heads, padded,
                      acfg.head_dim, torch.bfloat16)
    d64_shapes = {
        "vlm_prefill": (attn_case(
            LM_BATCH, vcfg.n_heads, vcfg.n_kv_heads,
            vcfg.n_frontend_tokens + LM_SEQ, vcfg.head_dim, torch.bfloat16),
            True, None, None),
        "whisper_encoder": (enc_q, False, frames, frames),
        "whisper_cross": ([torch.randn(
            (LM_BATCH, acfg.n_heads, LM_SEQ, acfg.head_dim), generator=gen,
            device="cuda").bfloat16(), *enc_q[1:]], False, frames, None)}
    d64_timing = {}
    for shape_name, ((q_, k_, v_), causal, kv_len, q_len) in \
            d64_shapes.items():
        got = flash.flash_attention_cuda(q_, k_, v_, causal=causal,
                                         kv_len=kv_len)
        torch.cuda.synchronize()
        ok, err, share = attn_within(got, q_, k_, v_, causal=causal,
                                     kv_len=kv_len)
        check(ok, f"flash kernel at {shape_name} (q {tuple(q_.shape)}, k/v "
              f"{tuple(k_.shape)}, kv_len {kv_len}) != plain version "
              f"(max_abs_err={err}, share of tolerance {share})")
        d64_timing[shape_name] = attn_time(
            q_, k_, v_, variant="wgmma_bf16", causal=causal, kv_len=kv_len,
            q_len=q_len, name=shape_name)
        d64_timing[shape_name].update(
            max_abs_err=err, share_of_tolerance=share,
            shape=f"q {tuple(q_.shape)}, k/v {tuple(k_.shape)}"
            + (f", kv_len {kv_len}" if kv_len else ", causal"))
    del got, q_, k_, v_, d64_shapes, enc_q
    # the float32 kernel, which only the check paths launch, at glm4-9b's
    # heads and 2048 tokens: its output there is held to the plain
    # version, and SDPA's float32 result to the same contract
    fq, fk, fv = attn_case(1, hq, hkv, 2048, d, torch.float32)
    f32_variant = flash.variant(fq.dtype, d)
    f32_ok, f32_err, f32_share = attn_within(
        flash.flash_attention_cuda(fq, fk, fv, causal=True), fq, fk, fv,
        causal=True)
    check(f32_ok, f"attn_time: {f32_variant} at q {tuple(fq.shape)} lies "
          f"{f32_share:.3g} x its tolerance from the plain version")
    f32_timing = attn_time(fq, fk, fv, variant=f32_variant)
    f32_timing.update(max_abs_err=f32_err, share_of_tolerance=f32_share)
    sdpa_ok, sdpa_err, sdpa_share = attn_within(
        torch.nn.functional.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True, enable_gqa=True), fq, fk, fv,
        causal=True)
    f32_timing.update(library_within_contract=sdpa_ok,
                      library_max_abs_err=sdpa_err,
                      library_share_of_tolerance=sdpa_share)
    del fq, fk, fv
    torch.cuda.empty_cache()

    # 20. prefill ---------------------------------------------------------
    t_phase = time.perf_counter()
    model = init_params(lm_cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t_phase
    step = make_prefill_step(lm_cfg)
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, lm_cfg.vocab_size, size=(LM_BATCH, LM_SEQ))
                for _ in range(LM_REQUESTS + 1)]
    torch.cuda.reset_peak_memory_stats()
    live_before = torch.cuda.memory_allocated()        # weights and leftovers
    logits = step(model, {"tokens": requests[0]})       # warm-up
    torch.cuda.synchronize()
    del logits
    walls, next_tokens = [], []
    # the phase's peak (the logits' checks included) and the step's own
    phase_peak = step_peak = 0
    reset()
    for tokens in requests[1:]:
        phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = step(model, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        step_peak = max(step_peak, torch.cuda.max_memory_allocated())
        check(logits.shape == (LM_BATCH, LM_SEQ, lm_cfg.vocab_size)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} {logits.dtype}, or "
              "not finite")
        next_tokens.append(logits[:, -1].argmax(-1).tolist())
        del logits
    phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
    n_hist, n_left, n_gain, n_trav, n_forest, n_flash = read()
    lm_launches = n_flash
    lm_by_variant = dict(flash.launches_by_variant)
    check(n_flash == lm_cfg.n_layers * LM_REQUESTS
          and lm_by_variant[lm_variant] == n_flash
          and n_hist + n_left + n_gain + n_trav + n_forest == 0,
          f"{n_flash} flash launches for {LM_REQUESTS} requests ("
          f"{lm_by_variant}), want {lm_cfg.n_layers} a request, all "
          f"{lm_variant} (and no other kernel: hist {n_hist}, hist_left "
          f"{n_left}, split_gain {n_gain}, traverse {n_trav}, forest_sum "
          f"{n_forest})")
    p50 = float(np.median(walls))
    emit("prefill", arch=LM_ARCH, n_layers=lm_cfg.n_layers,
         d_model=lm_cfg.d_model, n_heads=hq, n_kv_heads=hkv, head_dim=d,
         d_ff=lm_cfg.d_ff, vocab_size=lm_cfg.vocab_size,
         params=sum(p.numel() for p in model.parameters()),
         weights="random bf16, seed 0", batch=LM_BATCH, seq=LM_SEQ,
         reduced=["shape: prefill_32k 32 x 32768 -> 2 x 4096 tokens"],
         requests=LM_REQUESTS, warmup_requests=1, attn_impl=lm_cfg.attn_impl,
         init_seconds=init_seconds, request_ms=[w * 1e3 for w in walls],
         p50_ms=p50 * 1e3,
         tokens_per_s=LM_BATCH * LM_SEQ * len(walls) / sum(walls),
         memory_allocated_before_gb=live_before / 1e9,
         max_memory_allocated_gb=phase_peak / 1e9,
         step_max_memory_allocated_gb=step_peak / 1e9,
         flash_launches=n_flash, flash_launches_per_request=n_flash
         / LM_REQUESTS, flash_launches_by_variant=lm_by_variant,
         next_tokens=next_tokens,
         seconds=time.perf_counter() - t_phase)
    prefill_res = dict(p50_ms=p50 * 1e3,
                       max_memory_allocated_gb=step_peak / 1e9,
                       flash_launches=dict(forward=n_flash / LM_REQUESTS,
                                           backward_calls=0))

    # 21. prefill_profile ---------------------------------------------------
    t_phase = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits = step(model, {"tokens": requests[1]})
        torch.cuda.synchronize()
    del logits
    rows = by_kernel(prof, 1, "request")
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for r in rows:
        groups[kernel_class(r["name"])] += r["device_us_per_request"] / 1e3
    busy_ms = sum(groups.values())
    emit("prefill_profile", requests=1, wall_ms_per_request=p50 * 1e3,
         device_ms_per_request=busy_ms,
         device_idle_share=1 - busy_ms / (p50 * 1e3),
         by_group_ms=groups,
         by_group_share={g: t / busy_ms for g, t in groups.items()},
         by_kernel=rows[:10], seconds=time.perf_counter() - t_phase)
    del model, prof
    torch.cuda.empty_cache()

    # 22. prefill_check -------------------------------------------------
    lm_check = prefill_check("prefill_check", LM_ARCH, 1, rng)

    # 23. decode ----------------------------------------------------------
    # serve.generate at full width and depth: the prompt token by token
    # through the serve step into a KV cache, then greedy decode; decode
    # attention is plain torch, so no kernel of the port runs
    run, decode_counts = serve_phase("decode", LM_ARCH)
    dcfg, dmodel = run.cfg, run.model
    b, s = DECODE["batch"], DECODE["prompt_len"]
    del run

    # 24. decode_time -----------------------------------------------------
    # the serve step at the dry-run's decode_32k cache length, the cache
    # filled with seeded bf16 values, every row at position 32767
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bt, L = DECODE_TIME_BATCH, DECODE_TIME_LEN
    state = init_decode_state(dcfg, bt, L, device="cuda")
    fill = torch.Generator(device="cuda").manual_seed(5)
    for t in state["kv"].values():
        t.normal_(generator=fill)
    tokens = torch.randint(0, dcfg.vocab_size, (bt, 1), generator=fill,
                           device="cuda")
    pos = torch.full((bt,), L - 1, device="cuda")
    serve_step = make_serve_step(dcfg)
    walls = []
    reset()
    for i in range(3 + DECODE_TIME_STEPS):
        t0 = time.perf_counter()
        logits, state = serve_step(dmodel, state, tokens, pos)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(time.perf_counter() - t0)
    time_counts = read()
    check(sum(time_counts) == 0 and logits.shape == (bt, 1, dcfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"decode_time: logits {tuple(logits.shape)} or not finite, or "
          f"kernels of the port launched: {time_counts}")
    time_peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(walls))
    with labelled([(attn_lib, "decode_attend", "decode_attention")]), \
            torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits, state = serve_step(dmodel, state, tokens, pos)
        torch.cuda.synchronize()
    groups, busy = device_ms_by_group(prof, ["decode_attention"])
    time_ops = by_kernel(prof, 1, "step", ops=True)[:12]
    kv_bytes = sum(t.numel() * t.element_size() for t in state["kv"].values())
    w_bytes = lm_bytes(dmodel)
    decode_bound = (kv_bytes + w_bytes) / HBM_BYTES_PER_S * 1e3
    emit("decode_time", arch=LM_ARCH, n_layers=dcfg.n_layers, batch=bt,
         cache_len=L, pos=L - 1, cache="random bf16, seed 5",
         reduced=["shape: decode_32k batch 128 -> 32"],
         warmup_steps=3, steps=DECODE_TIME_STEPS,
         step_ms=[w * 1e3 for w in walls], step_p50_ms=p50 * 1e3,
         tokens_per_s=bt * len(walls) / sum(walls),
         max_memory_allocated_gb=time_peak / 1e9,
         weights_gb=w_bytes / 1e9, kv_cache_gb=kv_bytes / 1e9,
         bytes_bound_ms=decode_bound, share_of_bound=decode_bound / (p50 * 1e3),
         device_ms_per_step=busy, device_idle_share=1 - busy / (p50 * 1e3),
         by_group_ms=groups, by_group_share=shares(groups, busy),
         by_op=time_ops, seconds=time.perf_counter() - t_phase)
    del state, logits, prof, dmodel, tokens, pos
    torch.cuda.empty_cache()

    # 25. decode_check ----------------------------------------------------
    # glm4-9b at full width with 2 layers: the card against the port on
    # the CPU, the same weights, float32 activations and caches; rows at
    # different positions; without a window and with window 16 over 40
    # tokens (the ring buffer wraps twice)
    t_phase = time.perf_counter()
    ccfg = dataclasses.replace(lm_cfg, n_layers=2)
    cmodel = init_params(ccfg, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    cpu_model = init_params(ccfg, device="meta", dtype=torch.float32)
    cpu_model.load_state_dict({k: v.to("cpu", torch.float32) for k, v in
                               cmodel.state_dict().items()},
                              assign=True, strict=True)
    offsets = torch.tensor([0, 3])
    decode_cases = {}
    for window, n_steps, cache_len in ((0, 24, 27), (16, 40, 16)):
        toks = torch.from_numpy(rng.integers(0, ccfg.vocab_size,
                                             size=(2, n_steps)))
        states = {dev: init_decode_state(ccfg, 2, cache_len, device=dev,
                                         dtype=torch.float32)
                  for dev in ("cuda", "cpu")}
        worst = 0.0
        for t in range(n_steps):
            out = {}
            for dev, m in (("cuda", cmodel), ("cpu", cpu_model)):
                out[dev] = float32_decode(m, ccfg, states[dev],
                                          toks[:, t:t + 1], t + offsets,
                                          window=window)
            ok, err = within_f32(out["cuda"], out["cpu"])
            worst = max(worst, err)
            check(ok, f"decode_check (window {window}): step {t}: logits on "
                  f"the card differ from the CPU's beyond {ATTN_F32_TOL} "
                  f"(max_abs_err={err})")
        last = n_steps - 1 + offsets
        cache_err = 0.0
        for name in ("k", "v"):
            card, host = states["cuda"]["kv"][name].cpu(), \
                states["cpu"]["kv"][name]
            ok, err = within_f32(card, host)
            cache_err = max(cache_err, err)
            written = [sorted({int(i) for i in (host[:, r] != 0).any(
                -1).any(-1).any(0).nonzero()[:, 0]}) for r in range(2)]
            want = [sorted({(p % cache_len) if window else
                            min(p, cache_len - 1)
                            for p in range(int(o), int(e) + 1)})
                    for o, e in zip(offsets, last)]
            check(ok and torch.equal(card != 0, host != 0)
                  and written == want,
                  f"decode_check (window {window}): cache {name} differs "
                  f"(max_abs_err={err}) or writes other slots ({written}, "
                  f"want {want})")
        decode_cases[f"window_{window}"] = {
            "steps": n_steps, "cache_len": cache_len,
            "positions": [[int(o), int(e)] for o, e in zip(offsets, last)],
            "logits_max_abs_err": worst, "cache_max_abs_err": cache_err}
    emit("decode_check", arch=LM_ARCH, n_layers=ccfg.n_layers, batch=2,
         tolerance={"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
         cases=decode_cases, seconds=time.perf_counter() - t_phase)
    del cmodel, cpu_model, states
    torch.cuda.empty_cache()

    # 26. moe_decode ------------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset()
    mrun = serve_lm.generate(MOE_ARCH, smoke=False, **DECODE)
    torch.cuda.synchronize()
    moe_decode_counts = read()
    moe_decode_peak = torch.cuda.max_memory_allocated()
    mcfg, mmodel = mrun.cfg, mrun.model
    check(sum(moe_decode_counts) == 0
          and mrun.tokens.shape == (b, DECODE["gen"])
          and bool(torch.isfinite(mrun.last_logits).all()),
          f"moe_decode: tokens {tuple(mrun.tokens.shape)}, logits not "
          f"finite, or kernels of the port launched: {moe_decode_counts}")
    m_bytes = lm_bytes(mmodel)
    moe_busy, moe_step_ops = serve_step_profile(
        mmodel, mcfg, b, s + DECODE["gen"], s)
    emit("moe_decode", arch=MOE_ARCH, n_layers=mcfg.n_layers,
         params=sum(p.numel() for p in mmodel.parameters()),
         weights="random bf16 experts, float32 router, seed 0", **DECODE,
         capacity_per_expert=moe_lib.capacity(mcfg, b),
         prefill_into_cache_seconds=mrun.prefill_seconds,
         step_ms=[t * 1e3 for t in mrun.step_seconds],
         step_p50_ms=mrun.step_p50_ms, tokens_per_s=mrun.tokens_per_s,
         device_ms_per_step=moe_busy,
         device_idle_share=1 - moe_busy / mrun.step_p50_ms,
         by_op=moe_step_ops, weights_gb=m_bytes / 1e9,
         weights_bound_ms=m_bytes / HBM_BYTES_PER_S * 1e3,
         max_memory_allocated_gb=moe_decode_peak / 1e9,
         flash_launches=moe_decode_counts[-1], tokens=mrun.tokens.tolist(),
         seconds=time.perf_counter() - t_phase)
    del mrun

    # 27. moe_prefill -----------------------------------------------------
    # deepseek-moe-16b at full width and depth through make_prefill_step,
    # the same cut of prefill_32k as glm4-9b's (2 x 4096 tokens)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mstep = make_prefill_step(mcfg)
    requests = [rng.integers(0, mcfg.vocab_size, size=(LM_BATCH, LM_SEQ))
                for _ in range(LM_REQUESTS + 1)]
    logits = mstep(mmodel, {"tokens": requests[0]})          # warm-up
    torch.cuda.synchronize()
    del logits
    walls = []
    reset()
    for tokens in requests[1:]:
        t0 = time.perf_counter()
        logits = mstep(mmodel, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(logits.shape == (LM_BATCH, LM_SEQ, mcfg.vocab_size)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()),
              f"moe_prefill logits {tuple(logits.shape)} {logits.dtype}, or "
              "not finite")
        del logits
    n_hist, n_left, n_gain, n_trav, n_forest, n_flash = read()
    moe_launches = n_flash
    moe_by_variant = dict(flash.launches_by_variant)
    check(n_flash == mcfg.n_layers * LM_REQUESTS
          and moe_by_variant[lm_variant] == n_flash
          and n_hist + n_left + n_gain + n_trav + n_forest == 0,
          f"moe_prefill: {n_flash} flash launches for {LM_REQUESTS} requests "
          f"({moe_by_variant}), want {mcfg.n_layers} a request, all "
          f"{lm_variant}, and no other kernel")
    moe_peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(walls))
    # dropped assignments per layer, as each layer counted them in the
    # last timed request
    drops = [int(blk.moe.n_dropped) for blk in mmodel.layers]
    with labelled([(moe_lib, "expert_ffn", "moe_experts"),
                   (moe_lib, "moe_layer", "moe_route_dispatch_combine"),
                   (lm_layers.MLP, "forward", "moe_shared")]), \
            torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits = mstep(mmodel, {"tokens": requests[1]})
        torch.cuda.synchronize()
    groups, busy = device_ms_by_group(
        prof, ["moe_experts", "moe_route_dispatch_combine", "moe_shared"])
    moe_ops = by_kernel(prof, 1, "request", ops=True)[:12]
    tg = LM_BATCH * LM_SEQ // moe_lib.groups(mcfg, LM_BATCH * LM_SEQ)
    emit("moe_prefill", arch=MOE_ARCH, n_layers=mcfg.n_layers,
         d_model=mcfg.d_model, n_experts=mcfg.n_experts, top_k=mcfg.top_k,
         n_shared_experts=mcfg.n_shared_experts,
         d_ff_expert=mcfg.d_ff_expert, vocab_size=mcfg.vocab_size,
         params=sum(p.numel() for p in mmodel.parameters()),
         weights_gb=m_bytes / 1e9, batch=LM_BATCH, seq=LM_SEQ,
         reduced=["shape: prefill_32k 32 x 32768 -> 2 x 4096 tokens"],
         requests=LM_REQUESTS, warmup_requests=1,
         request_ms=[w * 1e3 for w in walls], p50_ms=p50 * 1e3,
         tokens_per_s=LM_BATCH * LM_SEQ * len(walls) / sum(walls),
         max_memory_allocated_gb=moe_peak / 1e9,
         flash_launches=n_flash,
         flash_launches_per_request=n_flash / LM_REQUESTS,
         flash_launches_by_variant=moe_by_variant,
         capacity_per_expert=moe_lib.capacity(mcfg, tg),
         assignments_per_layer=tg * mcfg.top_k,
         dropped_per_layer=drops,
         device_ms_per_request=busy,
         device_idle_share=1 - busy / (p50 * 1e3), by_group_ms=groups,
         by_group_share=shares(groups, busy), by_op=moe_ops,
         seconds=time.perf_counter() - t_phase)
    del mmodel, logits, prof
    torch.cuda.empty_cache()

    # 28. moe_check -------------------------------------------------------
    # deepseek-moe-16b at full width with 2 layers, 1 x 256 tokens: the
    # card against the port on the CPU with the same weights and float32
    # activations; the dropped assignments of each layer equal on both;
    # on the card onehot and sort dispatch equal where nothing is dropped
    t_phase = time.perf_counter()
    kcfg = dataclasses.replace(mcfg, n_layers=2)
    kmodel = init_params(kcfg, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    cpu_k = init_params(kcfg, device="meta", dtype=torch.float32)
    cpu_k.load_state_dict({k: v.to("cpu", torch.float32) for k, v in
                           kmodel.state_dict().items()},
                          assign=True, strict=True)
    ktokens = rng.integers(0, kcfg.vocab_size, size=(1, 256))

    def f32_with_drops(model):
        out = float32_logits(model, kcfg, ktokens)
        return out, [int(blk.moe.n_dropped) for blk in model.layers]

    card_f32, card_drops = f32_with_drops(kmodel)
    host_f32, host_drops = f32_with_drops(cpu_k)
    ok, moe_err = within_f32(card_f32, host_f32)
    check(ok and bool(torch.isfinite(card_f32).all()),
          f"moe_check: float32 logits on the card differ from the CPU's "
          f"beyond {ATTN_F32_TOL} (max_abs_err={moe_err})")
    check(card_drops == host_drops, f"moe_check: dropped assignments per "
          f"layer {card_drops} on the card, {host_drops} on the CPU")
    roomy = {}
    for dispatch in ("onehot", "sort"):
        rcfg = dataclasses.replace(kcfg, capacity_factor=8.0,
                                   moe_dispatch=dispatch)
        roomy[dispatch] = make_prefill_step(rcfg)(kmodel,
                                                  {"tokens": ktokens})
    check(torch.equal(roomy["onehot"], roomy["sort"]),
          "moe_check: sort dispatch differs from onehot on the card at "
          "capacity_factor 8.0")
    emit("moe_check", arch=MOE_ARCH, n_layers=kcfg.n_layers,
         tokens=list(ktokens.shape),
         f32_logits_max_abs_err=moe_err,
         f32_tolerance={"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
         dropped_per_layer={"card": card_drops, "cpu": host_drops},
         capacity_per_expert=moe_lib.capacity(kcfg, 256),
         sort_equals_onehot_at_cf8=True,
         seconds=time.perf_counter() - t_phase)
    del kmodel, cpu_k, roomy
    torch.cuda.empty_cache()

    # 29. ssm_check, 30. hybrid_check -------------------------------------
    recurrent_check("ssm_check", SSM_ARCH, 8, 7, rng)
    hyb_check = recurrent_check("hybrid_check", HYBRID_ARCH, 12, 8, rng)

    # 31. hybrid_decode, 32. hybrid_prefill, 33. hybrid_long ---------------
    hrun, hyb_decode_counts = serve_phase("hybrid_decode", HYBRID_ARCH)
    hmodel, hcfg = hrun.model, hrun.cfg
    del hrun
    hyb_prefill = prefill_phase(
        "hybrid_prefill", hmodel, hcfg, rng, variant=hyb_variant,
        labels=[(ssm_lib, "chunked_decay_attention", "ssd_scan")])
    long_phase(hmodel, hcfg)
    del hmodel
    torch.cuda.empty_cache()

    # 34. ssm_decode, 35. ssm_prefill --------------------------------------
    srun, ssm_decode_counts = serve_phase("ssm_decode", SSM_ARCH)
    smodel, scfg = srun.model, srun.cfg
    del srun
    ssm_prefill = prefill_phase(
        "ssm_prefill", smodel, scfg, rng, variant=None,
        labels=[(ssm_lib, "slstm_scan", "slstm_scan"),
                (ssm_lib, "chunked_decay_attention", "ssd_scan")])
    del smodel
    torch.cuda.empty_cache()

    # 36. vlm_check, 37. vlm_decode, 38. vlm_prefill -----------------------
    vlm_check = prefill_check("vlm_check", VLM_ARCH, 10, rng)
    vrun, vlm_decode_counts = serve_phase("vlm_decode", VLM_ARCH)
    vmodel, vcfg = vrun.model, vrun.cfg
    del vrun
    vlm_prefill = prefill_phase("vlm_prefill", vmodel, vcfg, rng,
                                variant="wgmma_bf16", labels=[])
    del vmodel
    torch.cuda.empty_cache()

    # 39. audio_check, 40. audio_decode, 41. audio_prefill -----------------
    audio_check = prefill_check("audio_check", AUDIO_ARCH, 11, rng)
    arun, audio_decode_counts = serve_phase("audio_decode", AUDIO_ARCH)
    amodel, acfg = arun.model, arun.cfg
    del arun
    audio_prefill = prefill_phase(
        "audio_prefill", amodel, acfg, rng, variant="wgmma_bf16",
        labels=[(model_lib.DecoderLM, "encode_audio", "audio_encoder"),
                (model_lib.CrossBlock, "forward", "cross_attention")])
    del amodel
    torch.cuda.empty_cache()

    # 42. attn_bwd_check, 43. attn_bwd_time -------------------------------
    gen = torch.Generator(device="cuda").manual_seed(21)
    bwd_check = attn_bwd_check(gen)
    bwd_timing = {name: attn_bwd_time(gen, name, shape, bwd_regs)
                  for name, shape in BWD_SHAPES.items()}
    torch.cuda.empty_cache()

    # 44. lm_train_check, 45. lm_train, 46. lm_pretrain --------------------
    lm_train_check(rng)
    lm_train = lm_train_phase(rng)
    lm_pretrain_phase()

    # 47. roofline ----------------------------------------------------------
    roofline_phase(smi_line, {
        "prefill": prefill_res,
        "lm_train": dict(lm_train,
                         flash_launches=lm_train["flash_launches_per_step"])})

    # 48. sharded ---------------------------------------------------------
    sharded = sharded_phase(smi_line)
    torch.cuda.empty_cache()

    # 49. kernels ---------------------------------------------------------
    kernels = []
    for binned, suffix in ((False, "f32"), (True, "i32")):
        t = forest_timing[binned]
        kernels.append({
            "name": f"forest_sum_{suffix}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/traverse.cu",
            "replaces": "src/repro/kernels/traverse.py:73",
            "launches": launches[binned],
            "launches_per_request": 1,
            "max_abs_err": forest_err[binned],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "floor_ms": floor_ms,
            "library_ms": None,
            "deterministic": repeats[f"forest_sum_{binned}"],
        })
    for binned, suffix in ((False, "f32"), (True, "i32")):
        kernels.append({
            "name": f"traverse_chunk_{suffix}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/traverse.cu",
            "replaces": "src/repro/kernels/traverse.py:73",
            "launches": chunk_launches[binned],
            "on_main_path": False,
            "max_abs_err": max_err[binned],
            "ms": timing[binned]["ms"],
            "plain_ms": timing[binned]["plain_ms"],
            "bound_ms": timing[binned]["bound_ms"],
            "bound_by": timing[binned]["bound_by"],
            "floor_ms": floor_ms,
            "library_ms": None,
            "deterministic": repeats[f"traverse_{binned}"],
        })
    for child, name, line in ((False, "hist_levels", 65),
                              (True, "hist_levels_left", 123)):
        t = train_timing[child]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hist.cu",
            "replaces": f"src/repro/kernels/hist.py:{line}",
            "launches": train_launches[child]["hist"],
            "launches_per_tree": TRAIN_DEPTH,
            "launches_by_path": {p: n[name] for p, n in
                                 path_launches.items() if name in n},
            "max_abs_err": hist_err[child],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "floor_ms": floor_ms,
            "library_ms": t["library_ms"],
            "deterministic": repeats[f"hist_{child}"],
        })
    kernels.append({
        "name": "split_gain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/split_gain.cu",
        "replaces": "src/repro/kernels/split_gain.py:51",
        "launches": sum(v["split_gain"] for v in train_launches.values()),
        "launches_per_tree": TRAIN_DEPTH,
        "launches_by_path": {p: n["split_gain"] for p, n in
                             path_launches.items()},
        "max_abs_err": gain_err,
        "ms": gain_timing["ms"],
        "plain_ms": gain_timing["plain_ms"],
        "bound_ms": gain_timing["bound_ms"],
        "bound_by": gain_timing["bound_by"],
        "floor_ms": floor_ms,
        "library_ms": None,
        "deterministic": repeats["split_gain"],
    })
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "variant": lm_variant,
        # one entry a (variant, head dim): bf16 at d = 128 and 80 share
        # the Hopper kernel's variant
        "variants": {
            f"{lm_variant}_d{lm_cfg.head_dim}": {
                "shape": "q (2, 32, 4096, 128), k/v (2, 2, 4096, 128)",
                "max_abs_err": slice_err, **attn_timing,
                "registers": wgmma_regs[f"d{lm_cfg.head_dim}"],
                "launches_by_path": {"prefill": lm_launches,
                                     "moe_prefill": moe_launches}},
            f"{hyb_variant}_d{hyb_cfg.head_dim}": {
                "shape": "q, k, v (2, 32, 4096, 80)",
                "max_abs_err": hyb_slice_err, **hyb_timing,
                "registers": wgmma_regs[f"d{hyb_cfg.head_dim}"],
                "deterministic": repeats["flash_attention_d80"],
                "launches_by_path": {
                    "hybrid_prefill": hyb_prefill["launches"]}},
            **{f"wgmma_bf16_d64_{shape_name}": {
                **t, "registers": wgmma_regs["d64"],
                "launches_by_path": (
                    {"vlm_prefill": vlm_prefill["launches"]}
                    if shape_name == "vlm_prefill" else
                    {"audio_prefill": audio_prefill["by_label"][
                        "audio_encoder"],
                     "audio_decode": audio_decode_counts[-1]}
                    if shape_name == "whisper_encoder" else
                    {"audio_prefill": audio_prefill["by_label"][
                        "cross_attention"]})}
               for shape_name, t in d64_timing.items()},
            f"{f32_variant}_d{lm_cfg.head_dim}": {
                "shape": "q (1, 32, 2048, 128), k/v (1, 2, 2048, 128)",
                **f32_timing,
                "on_main_path": False,
                "launches_by_path": {
                    "prefill_check": lm_check["flash_launches_f32"][
                        f32_variant],
                    "prefill_check/ragged": lm_check["ragged"][
                        "flash_launches"][f32_variant],
                    "hybrid_check": hyb_check["flash_launches_f32"][
                        f32_variant],
                    "vlm_check": vlm_check["flash_launches_f32"][
                        f32_variant]
                    + vlm_check["ragged"]["flash_launches"][f32_variant],
                    "audio_check": audio_check["flash_launches_f32"][
                        f32_variant]}}},
        "sass_counts": flash_sass,
        "launches": lm_launches + moe_launches + sum(
            p["launches"] for p in (hyb_prefill, ssm_prefill, vlm_prefill,
                                    audio_prefill))
        + audio_decode_counts[-1] + sharded["prefill"]["launches"]
        + sharded["lm_train"]["launches"]["forward"],
        # the sharded paths: rank 0's launches, on its local heads
        "launches_by_path": {"sharded_prefill": sharded["prefill"][
                                 "launches"],
                             "sharded_lm_train": sharded["lm_train"][
                                 "launches"]["forward"],
                             "prefill": lm_launches,
                             "moe_prefill": moe_launches,
                             "hybrid_prefill": hyb_prefill["launches"],
                             "ssm_prefill": ssm_prefill["launches"],
                             "vlm_prefill": vlm_prefill["launches"],
                             "audio_prefill": audio_prefill["launches"],
                             "lm_train": lm_train["forward_launches"],
                             "decode": decode_counts[-1],
                             "moe_decode": moe_decode_counts[-1],
                             "hybrid_decode": hyb_decode_counts[-1],
                             "ssm_decode": ssm_decode_counts[-1],
                             "vlm_decode": vlm_decode_counts[-1],
                             "audio_decode": audio_decode_counts[-1]},
        # the timed requests' launches over their number; a decode phase
        # is one generate call
        "launches_per_request": {
            "prefill": lm_launches / LM_REQUESTS,
            "moe_prefill": moe_launches / LM_REQUESTS,
            "hybrid_prefill": hyb_prefill["per_request"],
            "ssm_prefill": ssm_prefill["per_request"],
            "vlm_prefill": vlm_prefill["per_request"],
            "audio_prefill": audio_prefill["per_request"],
            "audio_prefill_by_label": {
                k: n / LM_REQUESTS
                for k, n in audio_prefill["by_label"].items()},
            "audio_decode": audio_decode_counts[-1]},
        "max_abs_err": slice_err,
        "ms": attn_timing["ms"],
        "plain_ms": attn_timing["plain_ms"],
        "bound_ms": attn_timing["bound_ms"],
        "bound_by": attn_timing["bound_by"],
        "floor_ms": floor_ms,
        "library_ms": attn_timing["library_ms"],
        "deterministic": repeats["flash_attention"],
    })
    vlm_bwd = bwd_timing["internvl2_1b"]
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # the gradient of the flash kernel, which has no VJP in Pallas; the
        # JAX package trains through _flash_xla's rematerialised scan
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "replaces_note": "its VJP: src/repro/models/attention.py:98 "
                         "(_flash_xla under jax.checkpoint)",
        "variant": "bwd_wgmma_bf16",
        "variants": {
            f"bwd_wgmma_bf16_{name}": {
                "shape": dict(zip(("batch", "q_heads", "kv_heads", "seq",
                                   "head_dim"), BWD_SHAPES[name])), **t}
            for name, t in bwd_timing.items()},
        "registers": bwd_regs,
        "launches": lm_train["backward_calls"]
        + sharded["lm_train"]["launches"]["backward_calls"],
        "launches_per_step": lm_train["flash_launches_per_step"][
            "backward_calls"],
        "kernel_launches_per_call": vlm_bwd["launches_per_call"],
        "launches_by_path": {"lm_train": lm_train["backward_calls"],
                             "sharded_lm_train": sharded["lm_train"][
                                 "launches"]["backward_calls"]},
        "max_abs_err": vlm_bwd["max_abs_err"],
        "check_max_abs_err": bwd_check["by_variant"],
        "ms": vlm_bwd["ms"],
        "plain_ms": vlm_bwd["plain_ms"],
        "bound_ms": vlm_bwd["bound_ms"],
        "bound_by": vlm_bwd["bound_by"],
        "floor_ms": floor_ms,
        "library_ms": vlm_bwd["library_ms"],
        "deterministic": bwd_check["deterministic"]
        and all(t["deterministic"] for t in bwd_timing.values()),
    })
    emit("total", seconds=time.perf_counter() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
