#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. flash-attention prefill kernels vs their plain version: bf16 runs
   ``flash_fwd_tc`` (tensor cores), f32 ``flash_fwd_simt``.  The qwen2-7b
   shapes (B=1, H=28, KH=4, Dh=128, bf16, causal, S in {144, 512, 2048}
   and the serve trace's padded prompt length), an f32 case, a
   window/q_offset case with a ragged Skv at Dh=64 in f32 and in bf16,
   bf16 with S not a multiple of 64 at Dh 64 (smollm's heads) and 16, and
   a window case at Dh=64; head dim 256 with one KV head under a window
   (an f32 case, a ragged bf16 one, and recurrentgemma-9b's training
   layer GRIFFIN_LAYER: B 1, S 4096, 16 heads of 256 over one, window
   2048, timed beside SDPA with the window as a boolean mask, its
   backend named); the training forwards (``return_lse``) at
   internvl2-2b's layer (INTERNVL_LAYER: B 2, S 2048, 16 heads of 128
   over 8, causal) and seamless-m4t-large-v2's non-causal one
   (SEAMLESS_LAYER: B 2, S 2048, 16 heads of 64 over 16), timed beside
   SDPA; the cross-attention's shapes (CROSS_CASES, non-causal: Sq 1 over
   Skv 512 at B 8, 16/16 heads of 64, in bf16 and f32, and at Dh 128 over
   8 KV heads, as the encdec decode step calls it; a ragged Sq 37 over Skv
   300), timed beside SDPA; on every case the row log-sum-exp that both
   kernels write for the training path (``return_lse``), held to the
   plain version's at the case's tolerance, beside the same out;
3. the split paged decode (bf16 ``paged_decode_tc`` on the tensor cores,
   f32 ``paged_decode_simt``; the last live split of each request and KV
   head merges the others) vs its plain version at the serve shapes (B=8,
   ps=16, KH=4, G=7, Dh=128, bf16 and f32; a permuted page table and
   ragged kv_len including 0 and a length that is not a page multiple),
   at smollm's shape (KH=3, G=3, Dh=64), with kv_len on the edges of the
   splits, and over a long context (8 slots at 4096 positions, 67 MB of
   live KV), where the share of the memory rate is printed.  Phases 2
   and 3 time each kernel with the host out of the way (``time_ms``) and
   also at the host's pace (``call_ms``);
4. the serving path: first a small f32 model's prefill and decode steps on
   the card (kernels) must give the CPU's logits (plain versions) within
   1e-4, each decode layer's work but the pool's read and write replayed
   as CUDA graphs on the card as the engine runs it; the graphed decode step against the eager
   one at qwen2-7b's width with 2 layers (phase 26's check); then
   qwen2-7b at full width (bf16, seeded random weights) serves 16
   Poisson requests, with every launch counted;
5. top-k compression kernel vs its plain version, bit for bit (int32 /
   int16 views): the reference's test grid in f32 and bf16 with ef absent,
   of x's type and f32; an all-zero block, tied magnitudes, theta = 1 and
   k = 1; then the kernel over a table of leaves (one launch per type pair
   and MAX_LEAVES leaves) against the per-leaf plain version, padded as
   the reference pads: the 59 ResNet-20 leaves at R = 64, block 256, at
   their own lengths (the round's one launch, timed, beside the 59
   one-leaf launches on padded leaves that the round ran before), a
   table of mixed f32 / bf16 leaves and efs, ragged leaves (L = 1, 31,
   257, ...) at three blocks, the in-place form and a table longer than
   one launch takes; FEMNIST's fc1_w at R = 64 (timed); and a mamba2-1.3B
   round's table at R = 4, block 1024, in place: its w_in leaf (bf16,
   more than 2^31 entries in all, so that offsets pass 32 bits) beside a
   small f32 leaf, once with bf16 EF at w_in's length and once with f32
   EF at a ragged length, two launches each (timed);
6. the FedSim path: a small MLP FedSim runs 3 rounds on the card (kernel)
   and on the CPU (plain version) from the same parameters and bits; the
   histories agree within FEDSIM_RTOL;
7. the HCEF round at full width: ResNet-20 on the synthetic CIFAR-10
   stand-in, 64 devices in 8 clusters, the configuration's budgets,
   FEDSIM_ROUNDS rounds (two of them gossip rounds), then the averaged
   model's accuracy, with every top-k launch counted (one a round);
8. the SSD scan kernels (forward, and backward through the autograd
   Function) vs their plain versions (``ref.ssd_chunked``, and autograd
   through it evaluated in f64): the reference's test grid in f32 and
   bf16; the inputs the
   first layer of mamba2-1.3B at full width gives ``ops.ssd`` (b=2, s=512,
   h=64, p=64, g=8, n=128, chunk 256, bf16; both kernels timed there), and
   the same inputs at chunk 128 (four chunks);
   at that shape in bf16 and f32, dt and A drawn as the test grid draws
   them and as mamba2's init gives them (dt about 0.7, A = -1: the decays
   underflow), and a padded length (s=300); an all-zero x.  Each row names
   the kernels it ran (bf16: the tensor-core kernels, "tc"; f32: the SIMT
   kernels) and their launches a call, and a bf16 y must also be within
   SSD_PLAIN_FACTOR times the plain bf16 version's distance from f64;
9. the HCEF round step on mamba2: first a smoke-config round on the card
   (kernels) against the same round on the CPU (plain versions), then the
   train launcher's entry point on mamba2-1.3B at full width
   and depth (MAMBA2_ROUNDS rounds, gossip in the last), with every SSD
   and top-k launch counted (top-k: one a round per type pair of the
   leaves);
10. the gossip wire's kernels vs their plain versions, bit for bit: the
   encode (the warp-per-block kernel up to wb 1024, the CTA-per-block one
   above; each wire block size prints which ran) with int32 offsets and
   with the packed forms it writes itself (p4, and u8 up to wb 256,
   against ``pack_offsets_plain`` of the plain encode's offsets), the
   standalone p4 pack and p4 unpack on every wire dtype, wire blocks 1,
   31, 33, 64, 128, 1000, 1024 and 2048, k_b from 1 to wb, blocks with
   planted threshold ties, all-zero blocks and zero payloads; the p4 pack
   and unpack on both routes (a warp a block up to wb 1024, a CTA a
   block at any wb) over P4_BLOCKS and k_b 1, 7, wb / 10, wb / 2 - 1,
   wb - 1, wb, on valid, all-zero, short, over-full and random bitmaps at
   two byte phases, and the unpack once over more than 2^31 entries (held
   to the plain version chunk by chunk); the encode
   of rows read in place in every offset form (row subsets of a strided
   matrix, ragged last blocks, wb = L < 32); the
   decode-and-mix on MIX_CASES in every dtype (u8 and p4 offsets,
   partial senders, dense plans, more steps than a launch takes, y of
   -0); then the inputs a gossip column chunk of mamba2-1.3B's largest
   leaf (w_in) hands the encode at theta 0.05, 0.1, 0.2, 0.6 and 1 (int4),
   each kernel timed there (the fused p4 encode beside the int32 encode
   and the pack it replaced; the pack and unpack on their route beside
   the CTA-per-block kernels), the decode-and-mix timed on the main chunk
   (C = 2, levels (0.1, 0.6)) against its plain version and the chain it
   replaced, and one chunk through ``sparse_exchange_``: bit for bit its
   plain route, no host synchronisation inside it (sync debug mode
   "error"), its card and host-paced times and its device launches
   (GOSSIP_CHUNK_LAUNCHES: two encodes, one decode-and-mix, two copies);
11. the fused round step (a policy: the sparse gossip over the int4 wire,
   per-cluster levels, the CHOCO wire error feedback) on the smoke
   mamba2, 4 rounds on the card (kernels) against the CPU (plain
   versions): at eta 0 everything within ROUND_RTOL / ROUND_ATOL; at
   eta 0.1, round by round from the card's state, the statistics within
   ROUND_RTOL and the state within ROUND_ATOL but for top-k threshold
   flips (at most Q_FLIP_SHARE of the entries); the encode and the
   decode-and-mix must run, the standalone p4 pack and unpack must not
   (the encode packs; the wire EF's own payload is decoded in the
   decode-and-mix);
12. the fused round step on mamba2-1.3B at full width and depth (R = 4,
   bf16), the launcher's corpus and batch draw, the int4 wire at the
   per-device theta (0.05, 0.1, 0.4, 0.6), so cluster levels (0.1, 0.6),
   SPARSE_ROUNDS rounds with gossip in rounds 2 and 4, every launch of
   every kernel counted (a column chunk of ``GOSSIP_COLS``: one fused
   encode a plan and one decode-and-mix; no standalone pack or unpack);
13. the gossip with the CHOCO wire EF on mamba2-1.3B at full width
   (``tools/gossip_bench.py``'s leaves: 48 layers, bf16, R = 4 in 2
   clusters on a ring, int4 at levels (0.1, 0.6), wire block 1024, with
   (R, L) f32 estimates for every leaf, 60.9 GB in all), EF_ROUNDS
   rounds through ``sparse_exchange_(..., wire_ef=...)`` in column chunks
   of ``gossip_cols(2)``: finite leaves and estimates, the
   estimates moved, two decode-and-mix launches a chunk and no standalone
   unpack or pack, peak <= PEAK_LIMIT_GB, and the first w_in chunk of the
   second round bit for bit ``_sparse_mix_rows(..., impl="plain")`` on
   the card from the same inputs; then that chunk alone, its card time
   beside the chunk's without the EF, and its kernels' device time by
   name;
14. the attention backward kernel (``csrc/flash_attention_bwd.cu``: bf16
   by wgmma on TMA-fed tiles, f32 the exact SIMT kernels) vs its plain
   version (``ref.flash_attention_bwd_plain``) on the same seeded inputs,
   out and lse from the forward kernel: BWD_CASES (G 1, 2 and 3, causal
   and not, a window, ragged S 65, 130 and 1000, Dh 16-256, both types,
   bf16 Dh 128 over 16 query blocks, Dh 256 with one KV head under a
   window), each gradient within BWD_TOL_OF_MAX of its largest entry and
   the same bits on a second run; ptxas must report no spill for a bf16
   backward kernel nor for ``flash_fwd_tc``; then smollm-135M's layer
   (B 2, S 2048, 9 heads, 3 KV heads, Dh 64, bf16, causal),
   recurrentgemma-9b's (GRIFFIN_LAYER), internvl2-2b's (INTERNVL_LAYER)
   and seamless-m4t-large-v2's non-causal one (SEAMLESS_LAYER), timed
   beside their plain
   version, SDPA's backward alone (at griffin's layer with the window as
   a boolean mask) and their bound, and split by kernel; and the forward
   at smollm's shape with its log-sum-exp (the training forward),
   checked and timed beside SDPA's forward and its bound, printed with
   its phase-16 launches after phase 16;
15. the HCEF round step on the smoke smollm (f32, 2 layers, S 65, 2 x 2,
   tau 4), 3 rounds on the card (the f32 attention kernels, forward and
   backward, every launch counted) against the CPU (the plain version
   under autograd): within ROUND_RTOL / ROUND_ATOL;
16. the train launcher's entry point on smollm-135M at full width and
   depth (30 layers, bf16, remat; R = 4 in 2 x 2, tau = q = 4, 2 x 2048
   tokens a step), LM_ROUNDS rounds: finite losses, two attention
   forwards and one backward a layer and step, one top-k launch a round
   per type pair, no serve launch; the round wall p50 against
   LM_ROUND_LIMIT_MS and the peak against PEAK_LIMIT_GB (gated);
17. the masked gossip's kernels bit for bit: ``_sparse_mix_rows(...,
   conn=)`` (the backhaul mask folded into the decode-and-mix's
   per-destination coefficients, then the absorbed-weight and
   partitioned-row passes in PyTorch) against its plain route on
   MIX_CASES at ring and erdos_renyi, one cluster and all but one
   partitioned; phase 10's main w_in chunk with cluster 1 partitioned
   through ``sparse_exchange_``: the same bits as the plain route, no host
   synchronisation, one decode-and-mix launch and MASKED_EPILOGUE_PASSES
   passes beyond the unmasked chunk's GOSSIP_CHUNK_LAUNCHES, timed beside
   it; and ``fold_dropped_updates`` after the grouped top-k on ResNet-20's
   table at R 64 with FOLD_DROPPED devices dropped: contribution + ef_out
   == delta + ef_old on every leaf;
18. the round step under the masks, card against CPU: the smoke smollm
   off-mesh (f32 kernels) under a fixed chaos trace, and the smoke
   mamba2's fused branch (int4 wire, levels (0.1, 0.6), no wire EF) with
   a dead device and cluster 1 cut in the gossip rounds, in lockstep,
   within ROUND_RTOL / ROUND_ATOL (the fused state but for Q_FLIP_SHARE
   threshold flips); on the card a chaos run and its replay, zero fault
   probabilities and no chaos give the same bits, a dead partitioned
   cluster keeps its parameters and its EF takes the update, and the
   launcher at --population 4 (= R) gives the storeless run's bits;
19. ResNet-20 FedSim at 64 slots under chaos (dropout 0.2, partitions
   0.1, coordinator failures 0.2) over FEDSIM_POPULATION clients with
   per-client shards and a spilling store, FEDSIM_ROUNDS rounds: finite,
   participation below 1, the population EF sum the same under == across
   every swap, page files only for clients that took part, one top-k
   launch a round, round p50 against FEDSIM_ROUND_LIMIT_MS (gated);
20. the train launcher on smollm-135M at full width under ``--chaos
   --population 16``: finite losses, participation every round and below
   1, phase 16's launch counts, the EF sum kept across the last swap,
   round p50 and peak gated as phase 16's;
21. the stale gossip's kernels bit for bit: ``_sparse_mix_rows(...,
   stale=)`` against its plain route on MIX_CASES at ring and
   erdos_renyi, every wire dtype, with every cluster stale, cluster 1
   alone stale, and every cluster stale with cluster 1 partitioned; phase
   10's main w_in chunk with every cluster stale, its payloads encoded
   ahead on a side stream (``stale_payloads``) and mixed by
   ``sparse_exchange_(payloads=)``: the in-line stale chunk's and the
   plain route's bits, no host synchronisation, the synchronous chunk's
   wire launches and STALE_CHUNK_LAUNCHES in all; timed beside the
   synchronous chunk, with the side stream's and the main stream's parts
   alone;
22. the overlap step at staleness 1, card against CPU in lockstep: the
   smoke smollm off the mesh (every cluster stale, then cluster 1 alone)
   and the smoke mamba2's fused branch (int4, levels (0.1, 0.6), every
   cluster stale: the side stream on the card), the statistics within
   ROUND_RTOL and the state (pending included) within ROUND_ATOL but for
   Q_FLIP_SHARE threshold flips; on the card staleness 0 and an empty
   stale set give the synchronous step's bits, pending included;
23. smollm-135M at full width: the fused branch with int4 at levels
   (0.1, 0.6), q = 2, OVERLAP_ROUNDS rounds, every cluster stale, by the
   overlap step and by the synchronous step from the same state: finite
   losses, phase 16's attention and top-k launches a round and the
   synchronous program's encode and decode-and-mix launches a gossip
   round, round p50 and peak gated, and the overlap verdict on CUDA
   events (in every gossip round the side stream's last encode ends
   before the main stream's device round does; in the synchronous
   program the first encode starts after it), the gossip phase's ms and
   the stale payloads' bytes printed; then the train launcher off the
   mesh with ``--overlap --staleness 1`` (round 4's stale set
   LAUNCHER_STALE_SET gated, phase 16's launch counts, p50, peak);
24. the MoE layer (``models/lm.py:_moe_ffn``, plain PyTorch: routing,
   capacity, gather dispatch and combine, the expert GEMMs in ``bmm``):
   phase 15's three rounds on the smoke granite-moe-1b-a400m, card
   against CPU in lockstep (each round starts the CPU from the card's
   state), within ROUND_RTOL / ROUND_ATOL, the f32 attention kernels
   counted; then ``_moe_ffn`` at granite's training layer (B 2, S 2048,
   bf16) forward and backward twice on the same inputs, the same bits,
   its card ms forward and backward and the share of assignments
   capacity dropped, printed;
25. phase 16 on granite-moe-1b-a400m at full width and depth (24 layers,
   32 experts, top 8, 1,334,887,424 parameters; R = 4 in 2 x 2, tau = q
   = 4, 2 x 2048 tokens a step), LM_ROUNDS rounds: phase 16's gates (two
   attention forwards and one backward a layer and step, the top-k
   launches a round, p50 and peak); then one local step of its round
   traced as the launchers' ``--profile`` traces: the device's busy
   share and its kernels by time;
26. the decode step with each layer's work but the pool's read and write
   replayed as CUDA graphs (``lm.DecodeGraphs``, as the engine runs it on
   the card) against the eager step, at granite's width with 2 layers: logits and pages within
   the bf16 tolerance, the paged decode kernel launched eagerly in both;
   then phase 4's serve on granite-moe-1b-a400m at full width (bf16,
   random weights; the stream's prompts taken into its vocabulary):
   finite logits, every request complete, the attention launches a layer
   and call, TPOT p50 against TPOT_LIMIT_MS (gated), TTFT p99 printed;
27. the hybrid family (``models/griffin.py``: RG-LRU blocks, local MQA):
   phase 15's round check on the smoke recurrentgemma-9b (f32, window
   16 under S 65, one KV head) at 3 layers (one rglru, rglru, attn
   group) and 5 (two trailing rglru blocks), GRIFFIN_SMALL_ROUNDS
   rounds in lockstep, card against CPU within ROUND_RTOL / ROUND_ATOL
   (the parameters but for Q_FLIP_SHARE top-k threshold flips), the f32
   attention kernels counted; then the RG-LRU scan (``ops.rglru``, plain
   PyTorch: the reference has no kernel for it) at RGLRU_LAYER (W 4096,
   S 4096, B 1, f32) against its sequential oracle, its forward and
   backward timed (``rglru_layer``);
28. recurrentgemma-9b at full width (d_model 4096, lru_width 4096, 16
   heads of 256 over one KV head, d_ff 12288, vocab 256000, window 2048,
   softcap 30; bf16, f32 momentum, remat) and depth GRIFFIN_DEPTH (one
   group and the two trailing rglru blocks, GRIFFIN_PARAMS parameters)
   through ``make_round_step``, driven as the train launcher drives it
   but at R = 2 in 2 clusters x 1 device and one 4096-token sequence a
   step, GRIFFIN_ROUNDS rounds (tau = q = 4, the last gossips): finite
   losses, two attention forwards and one backward an attention layer
   and step, the top-k launches a round, p50 against LM_ROUND_LIMIT_MS
   and peak against PEAK_LIMIT_GB (gated); then the train launcher's
   entry point on the smoke griffin for 2 rounds (the f32 kernels
   counted);
29. the last two architectures (``models/lm.py``): phase 15's round
   check on the smoke internvl2-2b (the ViT stub: 8 patch positions) and
   the smoke seamless-m4t-large-v2 (2 encoder layers, cross-attention),
   seeded N(0, 1) patch embeddings and frames beside the tokens,
   MULTIMODAL_SMALL_ROUNDS rounds in lockstep, card against CPU within
   ROUND_RTOL / ROUND_ATOL but for Q_FLIP_SHARE top-k threshold flips,
   the f32 attention kernels counted; then the train launcher's entry
   point on both smoke models for 2 rounds (the stand-ins it feeds; the
   f32 kernels counted, the non-causal launches apart);
30. internvl2-2b at full width and depth (24 layers, d_model 2048, 16
   heads of 128 over 8, d_ff 8192, vocab 92,553, an untied head, the
   first 256 positions from the ViT stub; INTERNVL_PARAMS parameters;
   bf16, f32 momentum, remat) through ``make_round_step``, driven as
   phase 28 but at 2 x 2048 tokens a step (phase 16's shape) with the
   launcher's stand-ins (N(0, 1) patch embeddings), R = 2 in 2 x 1,
   MULTIMODAL_ROUNDS rounds (tau = q = 4): finite losses, the first
   round's near ln(vocab), 48 attention forwards and 24 backwards a
   local step, the top-k launches a round, p50 and peak gated;
31. seamless-m4t-large-v2 at full width and depth 24 + 24 (d_model 1024,
   16 heads of 64 over 16, d_ff 8192, vocab 256,206, an untied head;
   SEAMLESS_PARAMS parameters), as phase 30 with N(0, 1) frames: the
   attention launches of its three kinds counted apart, causal
   self-attention, the encoder's non-causal self-attention and the
   non-causal cross-attention (two forwards and one backward of each a
   layer and step), and phase 30's gates;
32. the static serving path (``Engine.generate``), card against CPU in
   f32: the smoke qwen2-7b, granite-moe-1b-a400m, mamba2-1.3B,
   recurrentgemma-9b (window 16: a 40-token prompt wraps the ring, the
   decode runs past it), internvl2-2b (8 patch positions, N(0, 1)) and
   seamless-m4t-large-v2 (N(0, 1) frames) each run init_cache, prefill
   and STATIC_SMALL_STEPS decode steps fed the CPU's greedy tokens:
   logits within 1e-4, the attention kernel launches of each call by
   kind (``static_launches``); then ``Engine.generate`` on both with the
   weights times 10, the greedy tokens equal until a row's top two CPU
   logits come within TOKEN_MARGIN; and the paged pool's int8 mode and
   contiguous layout on the smoke qwen2-7b, card against CPU in
   lockstep (logits and floats within 1e-4, int8 entries at most one
   step apart in at most INT8_FLIP_SHARE of them), with no paged decode
   kernel launch (the reference routes both modes to the gather);
33. ``Engine.generate`` at full width (bf16, seeded random weights,
   greedy, STATIC_NEW_TOKENS new tokens, the reference launcher's
   stand-ins) for STATIC_FULL: qwen2-7b (B 8, 512-token prompts),
   mamba2-1.3B (B 8, 512), recurrentgemma-9b at its full depth of 38
   layers (B 2, 3072: the ring of 2048 wraps in prefill), internvl2-2b
   (B 8, 512, the first 256 positions zero patch embeddings) and
   seamless-m4t-large-v2 (B 8, 512 tokens and 512 N(0, 1) frames):
   finite logits, output (B, 64), the attention launches of every
   prefill and decode step by kind, peak <= PEAK_LIMIT_GB (gated); TTFT
   (the prefill), TPOT p50 and tok/s printed; then the plain static
   decode at qwen2-7b's static shape beside the paged kernel over an
   identity table and the int8 pool's gather route
   (``static_decode_routes``);
34. phase 4's qwen2-7b stream over an int8 pool: every request
   complete, the pool's bytes against phase 4's bf16 pool, TPOT p50
   printed, and no paged decode kernel launch (the reference's
   routing);
35. the paper's campaign (``repro_torch/experiments``, the ports of the
   reference's ``benchmarks/`` scripts) with ``common.RESULTS`` in a
   temporary directory and ``benchmarks/`` and ``BENCH_kernels.json``
   hashed before and after (gated unchanged): first HCEF's first
   GATE_ROUNDS rounds of ``common.make_sim`` (CIFAR, 16 devices in 8
   clusters, 16,384 images, GATE_BUDGETS) on the card against the CPU
   from the same parameters and bits (history within FEDSIM_RTOL, the
   parameters within ROUND_ATOL but for Q_FLIP_SHARE top-k flips); then
   ``fig2_3_convergence.main(CAMPAIGN_ROUNDS)`` (Table 2 and Figs. 2, 3
   and 8 on CIFAR and FEMNIST, five schemes each, CEF calibrating the
   budgets) and the Fig. 4, 5 and 6/7 sweeps at SWEEP_ROUNDS, every
   FedSim's rounds, top-k launches (one a round, gated) and p50 round
   wall printed, Table 2 in simulated seconds and joules (Eq. 8/9); then
   ``cfel_cifar_train`` for its 30 rounds, its last checkpoint restored
   into a fresh sim continuing one round bit for bit;
36. the serving bench: the paged decode kernel against its plain version
   at the bench's page size 8 (smollm-135M's and qwen2-7b's heads, bf16
   and f32); then ``serving_bench.bench_rows(smoke=False)`` on
   smollm-135M and qwen2-7b at full width (static batches, continuous
   over a bf16 and an int8 pool on one Poisson stream): every request
   its budget (the bench's own assertion), the attention launches by
   mode (static: the prefill kernel, no paged kernel; continuous: a
   prefill a request and layer, paged launches; int8: none paged),
   ``kv_bytes_ratio``; goodput, TTFT and TPOT p50 / p99 and the
   continuous / static ratio beside the reference's ``--require 1.5``
   printed, not gated;
37. the sweeps: the overlap sweep's staleness-0 rounds card against CPU
   within ROUND_RTOL, ``overlap_sweep.main``; the cohort bench's swaps
   and the cohort sweep's, each verified (``elastic.verified_swap``);
38. the train launcher's ``--ckpt-dir`` on smollm-135M at full width (R
   = 4, CKPT_ROUNDS rounds) in a temporary directory: a checkpoint a
   round, ``latest_checkpoint`` naming the last, its ``load_pytree``
   into the live state bit for bit (bf16 leaves included); bytes and
   write times printed;
39. the three examples (``repro_torch/experiments``): the quickstart's
   first QS_ROUNDS rounds on the card and on the CPU in lockstep (each
   round's row within ROUND_RTOL, the state within ROUND_ATOL but for
   Q_FLIP_SHARE top-k flips, then the card's state written into the
   CPU's), its attention forward and backward and top-k launches gated;
   ``paper_models_demo`` (ResNet-20, 269,722 parameters, and the FEMNIST
   CNN, 6,603,710, three SGD steps each at full size) on both, the counts
   gated and the losses within DEMO_RTOL; ``serve_lm``'s greedy tokens on
   both for one family of each kind (SERVE_KINDS, weights times 10 but
   the norms and the recurrent constants) and ``--continuous`` on
   SERVE_CONTINUOUS, the same tokens gated, the attention kernels'
   launches counted (the paged kernel's on the continuous path);
40. ``kernels_bench.bench(smoke=True)`` on the card: every row of the
   reference's benchmark printed, each kernel row (the attention forward,
   the SSD scan, the top-k, the round rows through the top-k and wire
   kernels) held to its ``_plain`` twin at the kernel's gate (F32_TOL,
   the SSD's atol a share of y's largest entry; top-k bit for bit; a
   round's state within ROUND_ATOL but for Q_FLIP_SHARE flips and its
   loss within ROUND_RTOL); the bench's launches are comparisons and are
   not counted on the main paths;
41. the dry run (``launch/dryrun.py``, on ``meta``) in a temporary
   directory: DRYRUN_CELLS and smollm-135M's train cell on each wire
   dtype, no cell in error; the wire report with ``--require
   int8/int4:2.0``; the roofline over the cells; phase 16's smollm cell's
   ``peak_est_bytes`` beside the peak phase 16 measured (not gated); the
   roofline's ``model_flops`` of every training cell this run trained
   (phases 9, 16, 25, 28, 30, 31) and the share of 989e12 FLOP/s its p50
   round wall implies.

It prints one JSON line of per-kernel numbers and, last, the device line.
It needs one CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernels.py:13
F32_TOL = dict(atol=2e-5, rtol=2e-5)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM
PEAK_BYTES = 3.35e12
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
HOST_LEAD_CYCLES = 1_000_000  # about 0.5 ms of device spin before a timing
SLOTS, PAGE = 8, 16  # the engine's decode slots and page size in phase 4
LONG_CONTEXT = 4096  # phase 3's long-context decode: positions a slot
TOPK_GRID = [(1, 2048, 256), (4, 4096, 512), (3, 1024, 1024)]  # test_kernels
# phase 6: card vs CPU histories of the same small FedSim.  Both are f32;
# sums run in other orders, and a coordinate at a top-k threshold may be
# kept on one side only, so the history is held to a relative tolerance.
FEDSIM_RTOL = 1e-3
FEDSIM_ROUNDS = 12  # phase 7: gossip at rounds 5 and 10 (q = 5)
SSD_GRID = [(1, 32, 2, 16, 1, 8, 8), (2, 64, 4, 16, 2, 16, 16),
            (1, 128, 8, 32, 8, 16, 32)]  # tests/test_kernels.py:91
SSD_MAIN = dict(b=2, s=512, h=64, p=64, g=8, n=128, chunk=256)
# The SSD kernels are held to the plain version evaluated in f64 on the
# same inputs.  y: the reference's tolerance (F32_TOL / BF16_TOL) and
# within rtol of y's largest entry; each gradient: within this share of
# its largest entry (bf16: dx, dB, dC are rounded to bf16, one ulp 2^-8).
SSD_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Where the plain version in the inputs' own arithmetic itself misses that
# tolerance, the kernel must be within this many times the plain version's
# distance from the f64 evaluation.  With mamba2's dt (about 0.7) the
# decays fall fast: y and dA sum terms whose large parts cancel, so an f32
# evaluation of them is off the f64 value by about 1e-5 of their max.  The
# factor leaves room for two summation orders rounding differently; a
# wrong or missing term is off by orders of magnitude more.  Each case
# prints both distances.
SSD_PLAIN_FACTOR = 4.0
# phase 9: the smoke round on the card vs the CPU (f32 on both; sums in
# other orders, and a top-k threshold tie may fall either way)
ROUND_RTOL, ROUND_ATOL = 1e-4, 1e-4
MAMBA2_ROUNDS = 4  # q = 4: round 4 gossips
WIRE_DTYPES = ("f32", "bf16", "int8", "int4", "fp8")
WIRE_BLOCKS = (1, 31, 33, 64, 128, 1000, 1024, 2048)
P4_BLOCKS = tuple(sorted(set(WIRE_BLOCKS) | {257, 4096}))  # phase 10's p4
P4_WIDE_BLOCKS = 1 << 22  # phase 10: at k_b 615, over 2^31 offsets out
WIRE_LEVELS = (0.05, 0.1, 0.2, 0.6, 1.0)  # phase 10's w_in chunk
WIRE_MAIN_LEVEL = 0.6  # the kernels line: the main path's larger level
# phase 10's decode-and-mix grid (tests/test_torch_wire_decode.py:CASES):
# (hkind, C, wire block, L, per-cluster levels, dense rows' type)
MIX_CASES = (
    ("ring", 2, 1024, 3000, (0.1, 0.6), torch.bfloat16),
    ("ring", 4, 1000, 2600, (0.05, 1.0, 0.25, 0.05), torch.float32),
    ("complete", 4, 2048, 5000, (1e-4, 1.0, 0.3, 1e-4), torch.bfloat16),
    ("erdos_renyi", 8, 128, 700, (0.02, 0.5, 0.02, 0.03, 0.5, 1.0, 0.02,
                                  0.3), torch.bfloat16))
GOSSIP_LEVELS = (0.1, 0.6)  # phase 12's cluster levels, the main chunk's
SPARSE_ROUNDS, SPARSE_Q = 4, 2  # phase 12: rounds 2 and 4 gossip
SPARSE_THETA = (0.05, 0.1, 0.4, 0.6)  # per device; cluster levels 0.1, 0.6
PEAK_LIMIT_GB = 72.0
LM_ROUND_LIMIT_MS = 10_000.0  # phase 16: 1000 edge rounds under 3 hours
EF_ROUNDS = 2  # phase 13: the second round starts from nonzero estimates
# phase 10: the device launches of one gossip chunk (two plans): the
# encode of each plan's sender row, the decode-and-mix, the bf16 -> f32
# copy of the cluster means and the copy of the result back to the rows
GOSSIP_CHUNK_LAUNCHES = 5
# phase 5: the grouped top-k's ragged leaves, a table per block
TOPK_RAGGED = {blk: sorted({1, 31, blk - 1, blk, blk + 1, 2 * blk + 1,
                            1000}) for blk in (32, 256, 1024)}
# phase 11 in lockstep: the share of parameter and estimate entries that
# may sit beyond ROUND_ATOL after a round (top-k threshold flips; the card
# has shown 2 of the smoke model's 1,069,632 entries in a round)
Q_FLIP_SHARE = 1e-4
# the full-width training cells each phase ran (phases 9, 16, 25, 28, 30,
# 31), by name: config, topology, tokens, params, round p50 and peak; phase
# 41 sets the roofline's model FLOPs against them
TRAIN_CELLS = {}


def _demangled_name(mangled):
    """The function's own name in an Itanium-mangled nested name
    (_ZN5repro..14ssd_fwd_kernelI...): the last length-prefixed part."""
    i, name = mangled.index("_ZN") + 3, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return name


def ptxas_summary(log):
    """{kernel: (most registers, most spill-store bytes, most stack-frame
    bytes, most static shared-memory bytes, instantiations)} from ``nvcc
    -Xptxas -v`` output, template instantiations merged."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_ZN\w+)'", line)
        if m:
            name = _demangled_name(m.group(1))
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        stack = re.search(r"(\d+) bytes stack frame", line)
        smem = re.search(r"(\d+) bytes smem", line) if regs else None
        if name and (regs or spill or stack):
            r, sp, st, sm, n = out.get(name, (0, 0, 0, 0, 0))
            out[name] = (max(r, int(regs.group(1))) if regs else r,
                         max(sp, int(spill.group(1))) if spill else sp,
                         max(st, int(stack.group(1))) if stack else st,
                         max(sm, int(smem.group(1))) if smem else sm,
                         n + bool(regs))
    return out


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush_buf = None
_spin_ms = None  # device ms of HOST_LEAD_CYCLES, measured at first use
# the last time_ms call: the host's ms to queue one call (the most over
# the timed calls), the device ms of the spin that led it, and whether
# the spin had to be lengthened
last_timing = {}


def _spin_device_ms():
    global _spin_ms
    if _spin_ms is None:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES)  # warm
        s.record()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        e.record()
        torch.cuda.synchronize()
        _spin_ms = s.elapsed_time(e)
    return _spin_ms


def time_ms(fn, iters=10, warmup=2, host_paced=False):
    """Mean device time of ``fn`` over ``iters`` runs, each after an L2
    flush (the serve path finds its KV and activations cold: every decode
    step streams all weights through the cache).  Between the flush and
    the timed call the device spins, so the host has queued the whole
    call before the device reaches it: the events then time the device's
    work, not the Python around the launches.  The spin is
    HOST_LEAD_CYCLES (about 0.5 ms); where the host took longer than that
    to queue a call (a call of many launches), the timing is taken again
    with a spin of 1.5 times the host's time.  With ``host_paced`` there
    is no spin, and a call whose host side is slower than the flush is
    timed at the host's pace (how every kernel was timed before the two
    attention kernels were redesigned).  ``last_timing`` keeps the host's
    queueing time and the spin."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 0 if host_paced else HOST_LEAD_CYCLES
    for attempt in (0, 1):
        evs, host = [], []
        for _ in range(iters):
            _flush_buf.zero_()
            if cycles:
                torch.cuda._sleep(cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        lead = cycles / HOST_LEAD_CYCLES * _spin_device_ms() if cycles \
            else 0.0
        if host_paced or attempt or max(host) <= lead:
            break
        cycles = int(HOST_LEAD_CYCLES * 1.5 * max(host) / _spin_device_ms())
    last_timing.update(host_queue_ms=max(host), lead_ms=lead,
                       lengthened=attempt == 1)
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def kernel_profile(fn, iters=5):
    """{kernel: (launches a call, mean device us a call)} over ``iters``
    calls of ``fn``, by torch.profiler (warm L2; CPU activity on too, so
    that each kernel is tied to its launch)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"::([A-Za-z_]\w*)(?:<[^()]*>)?\(", e.key)
        if m and e.device_time_total > 0:
            n, us = out.get(m.group(1), (0.0, 0.0))
            out[m.group(1)] = (n + e.count / iters,
                               us + e.device_time_total / iters)
    return out


def kernel_split(fn, iters=5):
    """{kernel: mean device us a call}: which of a call's launches takes
    the time."""
    return {k: us for k, (_, us) in kernel_profile(fn, iters).items()}


def max_err(a, b, tol):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * b.abs()).all())
    return float(err.max()), ok


def bound(flops, nbytes, dtype=None):
    """(least ms, what bounds it): ``flops`` operations at ``dtype``'s
    peak, or with no dtype a {dtype: operations} of work in several types,
    each at its own peak; ``nbytes`` at the memory rate."""
    parts = flops if dtype is None else {dtype: flops}
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in parts.items())
    t_mem = nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------------------
# phase 2: prefill kernel
# ---------------------------------------------------------------------------

def live_pairs(Sq, Skv, causal, window, q_offset):
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = q_offset + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return int(keep.sum())


# SDPA's backends in the order tried for a masked call (the flash backend
# takes no mask)
SDPA_MASKED_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_yardstick(q, k, v, causal, window):
    """(call, backend): one SDPA call on q (B, S, H, Dh), k, v (B, S, KH,
    Dh) in SDPA's layout, K and V repeated to the query heads (made
    outside the timing).  With a window the mask is a boolean (S, S)
    ``attn_mask`` and the backend is the first of SDPA_MASKED_BACKENDS
    that takes the call; without one ``is_causal`` and SDPA's own pick
    ("auto").  ``call(requires_grad=False)`` returns the output, or with
    ``requires_grad`` (out, (q, k, v)) leaves for a backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(is_causal=causal)
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        keep = pos[None, :] > pos[:, None] - window
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        kw = dict(attn_mask=keep)

    def call(backend, requires_grad=False):
        ins = [t.detach().requires_grad_(requires_grad)
               for t in (qt, kt, vt)]
        ctx = (sdpa_kernel([getattr(SDPBackend, backend)])
               if backend != "auto" else contextlib.nullcontext())
        with ctx:
            out = sdpa(*ins, **kw)
        return (out, ins) if requires_grad else out

    if not window:
        return functools.partial(call, "auto"), "auto"
    for backend in SDPA_MASKED_BACKENDS:
        try:
            call(backend, requires_grad=True)[0].sum().backward()
            torch.cuda.synchronize()
            return functools.partial(call, backend), backend
        except RuntimeError:
            continue
    fail("no SDPA backend takes a boolean mask")


def prefill_case(fa, gen, *, S, H, KH, Dh, dtype, window=0, q_offset=0,
                 Skv=None, masked_library=False, B=1, causal=True):
    """The forward kernel against its plain version on seeded inputs (out
    and, with ``return_lse``, the row log-sum-exp), timed beside the plain
    version, its bound and, without a window (or with
    ``masked_library``), SDPA (``sdpa_yardstick``).  ``causal=False``
    with Skv != S is the cross-attention's shape (S = 1 in its decode
    step)."""
    Skv = Skv or S
    q = torch.randn((B, S, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KH, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KH, Dh), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa.flash_attention_cuda(q, k, v, **kw)
    out2, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err, ok = max_err(out, ref, tol)
    # the training forward writes the row log-sum-exp beside the same out
    lse_err, lse_ok = max_err(lse, ref_lse, tol)
    ok = ok and lse_ok and torch.equal(out, out2)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    call_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                      host_paced=True)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                       iters=3, warmup=1)
    library_ms = library_backend = None
    if not q_offset and (Skv == S or not causal) and \
            (not window or masked_library):
        sdpa, library_backend = sdpa_yardstick(q, k, v, causal, window)
        library_ms = time_ms(sdpa)
    pairs = live_pairs(S, Skv, causal, window, q_offset)
    flops = 4 * Dh * H * pairs * B  # q.k and p.v, 2 ops per multiply-add
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    kernel = "flash_fwd_tc" if dtype == torch.bfloat16 else "flash_fwd_simt"
    row = dict(kernel=kernel, B=B, S=S, Skv=Skv, H=H, KH=KH, Dh=Dh,
               dtype=str(dtype)[6:], causal=causal, window=window,
               q_offset=q_offset, max_abs_err=err, lse_max_abs_err=lse_err,
               tol=tol["atol"], ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library_backend=library_backend)
    print("prefill " + json.dumps(row))
    if not ok:
        fail(f"flash-attention kernel disagrees with the plain version: {row}")
    return row


# the cross-attention's shapes (phase 2): seamless-m4t-large-v2's decode
# step (Sq 1 over the encoder's 512 frames, B 8, 16/16 heads of 64) in both
# types, Sq 1 at Dh 128 over 8 KV heads, and a ragged prefill Sq != Skv
CROSS_CASES = (
    dict(B=8, S=1, Skv=512, H=16, KH=16, Dh=64, dtype=torch.bfloat16),
    dict(B=8, S=1, Skv=512, H=16, KH=16, Dh=64, dtype=torch.float32),
    dict(B=8, S=1, Skv=512, H=16, KH=8, Dh=128, dtype=torch.bfloat16),
    dict(B=2, S=37, Skv=300, H=16, KH=16, Dh=64, dtype=torch.bfloat16),
)


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel
# ---------------------------------------------------------------------------

def decode_case(fa, gen, *, B, P, ps, KH, G, Dh, dtype, kv_len):
    H = KH * G
    NP = 1 + B * P
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((NP, ps, KH, Dh), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((NP, ps, KH, Dh), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(NP - 1, generator=gen, device="cuda") + 1
    table = perm.to(torch.int32).reshape(B, P).contiguous()
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    o, m, l = fa.paged_decode_attention_cuda(q, kp, vp, table, kl)
    torch.cuda.synchronize()
    o_p, m_p, l_p = fa.paged_decode_attention_plain(q, kp, vp, table, kl)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err_o, ok_o = max_err(o, o_p, tol)
    err_m, ok_m = max_err(m, m_p, tol)
    err_l, ok_l = max_err(l, l_p, tol)
    empty = [b for b, n in enumerate(kv_len) if n == 0]
    ok_empty = all(bool((o[b] == 0).all()) and bool((m[b] == -1e30).all())
                   and bool((l[b] == 1e-20).all()) for b in empty)
    ms = time_ms(lambda: fa.paged_decode_attention_cuda(q, kp, vp, table, kl))
    call_ms = time_ms(
        lambda: fa.paged_decode_attention_cuda(q, kp, vp, table, kl),
        host_paced=True)
    plain_ms = time_ms(
        lambda: fa.paged_decode_attention_plain(q, kp, vp, table, kl))

    mask = (torch.arange(P * ps, device="cuda")[None, :] < kl[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)  # (B, H, 1, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        k = fa.gather_kv_pages(kp, table).transpose(1, 2)
        v = fa.gather_kv_pages(vp, table).transpose(1, 2)
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        return sdpa(qt, k, v, attn_mask=mask)

    library_ms = time_ms(library)
    n_kv = int(sum(kv_len))
    flops = 4 * Dh * H * n_kv
    nbytes = (2 * n_kv * KH * Dh * kp.element_size()      # live K and V
              + 2 * q.numel() * q.element_size()          # q, out
              + 2 * m.numel() * 4 + table.numel() * 4 + B * 4)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    # max_abs_err is the output's; m and l are held to the same atol+rtol
    # (l is a sum of up to kv_len terms, so its absolute error scales).
    cps, n_split = fa.decode_split(B, KH, P, ps, fa._sm_count(0))
    row = dict(B=B, P=P, ps=ps, KH=KH, G=G, Dh=Dh, dtype=str(dtype)[6:],
               kv_len=list(kv_len), n_split=n_split,
               split_positions=cps * fa.DECODE_CHUNK, max_abs_err=err_o,
               err_m=err_m, err_l=err_l, tol=tol["atol"], ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms,
               library_ms=library_ms)
    print("decode " + json.dumps(row))
    if not (ok_o and ok_m and ok_l and ok_empty):
        fail(f"paged-decode kernel disagrees with the plain version "
             f"(empty slots exact: {ok_empty}): {row}")
    return row


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for the engine's model module: counts prefills and decode
    steps, times each call to its logits (the engine synchronises there
    anyway, to sample), and keeps a device flag per call that all logits
    were finite."""

    def __init__(self, model):
        self.model = model
        self.ms = {"prefill": [], "decode": []}
        self.finite = []
        self.pool_bytes = None

    def init_paged_cache(self, *a, **kw):
        cache = self.model.init_paged_cache(*a, **kw)
        self.pool_bytes = sum(t.numel() * t.element_size()
                              for t in cache.values())
        return cache

    @property
    def prefills(self):
        return len(self.ms["prefill"])

    @property
    def decode_steps(self):
        return len(self.ms["decode"])

    def _call(self, kind, fn, *a, **kw):
        t0 = time.perf_counter()
        logits, cache = fn(*a, **kw)
        torch.cuda.synchronize()
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.finite.append(torch.isfinite(logits).all())
        return logits, cache

    def prefill_paged(self, *a, **kw):
        return self._call("prefill", self.model.prefill_paged, *a, **kw)

    def decode_step_paged(self, *a, **kw):
        return self._call("decode", self.model.decode_step_paged, *a, **kw)


def small_path_agrees(lm, configs):
    """prefill_paged + 5 decode_step_paged of a small f32 qwen2-shaped model
    on the card (kernels, each decode layer's work but the pool's read and
    write replayed as CUDA graphs, as the engine runs it) against the same calls on the CPU (plain
    versions, which the CPU tests hold to the JAX package), fed the same
    tokens: logits within 1e-4.  One decode slot is empty (kv_len 0)."""
    cfg = configs.smoke_model(configs.get_config("qwen2_7b").model)
    params = lm.init(cfg, seed=1, device="cpu")
    on_gpu = {k: ({n: w.cuda() for n, w in v.items()}
                  if isinstance(v, dict) else v.cuda())
              for k, v in params.items()}
    on_gpu = dict(on_gpu, layers=lm.layer_list(on_gpu))  # as the engine
    graphs = {"cpu": None, "cuda": lm.DecodeGraphs()}
    rng = np.random.default_rng(1)
    B, ps, P, S = 4, 16, 4, 32
    NP = 1 + B * P
    table = rng.permutation(np.arange(1, NP)).astype(np.int32).reshape(B, P)
    table[3] = 0  # the empty slot's row is null
    plen = np.array([5, 16, 30, 1], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    runs = {}
    for dev, p in (("cpu", params), ("cuda", on_gpu)):
        cache = lm.init_paged_cache(cfg, NP, ps, device=dev)
        logits, cache = lm.prefill_paged(
            cfg, p, {"tokens": torch.as_tensor(toks[:3], device=dev)}, cache,
            torch.as_tensor(table[:3], device=dev),
            torch.as_tensor(plen[:3], device=dev))
        runs[dev] = [p, cache, [logits.cpu()]]
    kv_len = plen.copy()
    kv_len[3] = 0
    tok = torch.argmax(runs["cpu"][2][0][:, -1], -1)
    tok = torch.cat([tok, torch.zeros(1, dtype=tok.dtype)])
    for _ in range(5):
        for dev, run in runs.items():
            with torch.inference_mode():
                logits, run[1] = lm.decode_step_paged(
                    cfg, run[0], run[1], tok[:, None].to(dev),
                    torch.as_tensor(table, device=dev),
                    torch.as_tensor(kv_len, device=dev), graphs=graphs[dev])
            run[2].append(logits.cpu())
        tok = torch.argmax(runs["cpu"][2][-1][:, -1], -1)
        kv_len[:3] += 1
    diff = max(float((a - b).abs().max())
               for a, b in zip(runs["cpu"][2], runs["cuda"][2]))
    print(f"small path: card vs CPU max |logit diff| {diff:.3e} over "
          f"1 prefill + 5 decode steps")
    if not diff <= 1e-4:
        fail("the serving path on the card disagrees with the CPU path")


def serve_requests(poisson_requests, cfg, vocab):
    """Phase 4's stream: 16 Poisson requests at 50 req/s, prompts of
    16-512 tokens drawn in ``vocab`` (qwen2-7b's) and taken into
    ``cfg``'s vocabulary, 16-64 tokens out, seed 0."""
    reqs = poisson_requests(16, 50.0, 512, 64, vocab, seed=0, min_prompt=16,
                            min_new=16)
    return [dataclasses.replace(r, prompt=r.prompt % cfg.vocab_size)
            for r in reqs]


def serve_engine(lm, engine_mod, cfg, poisson_requests, kv_dtype=None):
    """The engine phases 4, 26 and 34 serve with: ``cfg`` at full width
    with seeded random weights, SLOTS decode slots, pages of PAGE, a pool
    of ``kv_dtype``, after one warm-up serve (cuBLAS handles, allocator
    pools, the decode graphs)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    print(f"{cfg.name} full width: {n_params} params "
          f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = engine_mod.Engine(cfg, params, device="cuda",
                            paged=engine_mod.PagedConfig(page_size=PAGE,
                                                         max_slots=SLOTS,
                                                         kv_dtype=kv_dtype))
    eng.serve(poisson_requests(2, 1e6, 32, 4, cfg.vocab_size, seed=7))
    return eng


# phase 34: the int8 pool's logits against the bf16 pool's over a prefill
# and this many decode steps; the limit is the reference's own bound on
# the int8 pool's logit error (tests/test_serving.py
# test_bounded_logit_error: max |logit error| < 1.0)
INT8_STEPS = 8
INT8_LOGIT_LIMIT = 1.0


def int8_against_bf16(lm, cfg, params, reqs):
    """The first SLOTS requests of ``reqs`` prefilled together into a bf16
    pool and an int8 one through one permuted page table, then INT8_STEPS
    decode steps on each, both fed the bf16 side's greedy tokens.
    Returns the largest |logit diff|, the bf16 logits' largest magnitude
    (the vocabulary's padding columns left out) and the share of (step,
    row) whose argmax agree."""
    rows = reqs[:SLOTS]
    B = len(rows)
    plen = np.array([len(r.prompt) for r in rows], np.int32)
    S = -(-int(plen.max()) // PAGE) * PAGE
    width = -(-(S + INT8_STEPS) // PAGE)
    NP = 1 + B * width
    perm = np.random.default_rng(9).permutation(np.arange(1, NP))
    table = torch.as_tensor(perm.astype(np.int32).reshape(B, width),
                            device="cuda")
    toks = np.zeros((B, S), np.int64)
    for i, r in enumerate(rows):
        toks[i, :len(r.prompt)] = r.prompt
    toks = torch.as_tensor(toks, device="cuda")
    kv_len = torch.as_tensor(plen, device="cuda")
    pools, logits = {}, {}
    diff, scale, agree = 0.0, 0.0, 0
    with torch.inference_mode():
        for kv in (None, "int8"):
            pools[kv] = lm.init_paged_cache(cfg, NP, PAGE, kv_dtype=kv,
                                            device="cuda")
            logits[kv], pools[kv] = lm.prefill_paged(
                cfg, params, {"tokens": toks}, pools[kv], table, kv_len)
        for step in range(INT8_STEPS + 1):
            a, b = (logits[kv][:, -1, :cfg.vocab_size].float()
                    for kv in (None, "int8"))
            diff = max(diff, float((a - b).abs().max()))
            scale = max(scale, float(a.abs().max()))
            tok = a.argmax(-1)
            agree += int((tok == b.argmax(-1)).sum())
            if step == INT8_STEPS:
                break
            for kv in pools:
                logits[kv], pools[kv] = lm.decode_step_paged(
                    cfg, params, pools[kv], tok[:, None], table, kv_len)
            kv_len = kv_len + 1
    return dict(rows=B, steps=INT8_STEPS, max_abs_logit_diff=diff,
                max_abs_logit=scale, top1_agree=agree / (B * (INT8_STEPS + 1)))


def serve_full(lm, engine_mod, cfg, fa, reqs, poisson_requests,
               tpot_limit_ms=None, kv_dtype=None):
    """Serve ``reqs`` with ``cfg`` (qwen2-7b in phases 4 and 34, granite in
    phase 26) at full width over a pool of ``kv_dtype``; check and print
    the serve's numbers, failing on a TPOT p50 over ``tpot_limit_ms``
    where given; return the kernels' launch counts of that serve (with
    the pool's bytes, TPOT p50 and every request's tokens beside them).
    An int8 pool takes the reference's routing: the gather, the
    dequantization and the direct decode, and no paged decode kernel; its
    logits are then held to a bf16 pool's (``int8_against_bf16``) within
    INT8_LOGIT_LIMIT."""
    eng = serve_engine(lm, engine_mod, cfg, poisson_requests, kv_dtype)
    rec = Recorder(eng.model)
    eng.model = rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)

    L = cfg.num_layers
    bad = [r.rid for r in reqs
           if r.rid not in outs or len(outs[r.rid].tokens) != r.max_new_tokens
           or outs[r.rid].finish_reason != "length"]
    if bad:
        fail(f"requests without their full budget of tokens: {bad}")
    if not bool(torch.stack(rec.finite).all()):
        fail("non-finite logits on the serve path")
    if rec.prefills != len(reqs):
        fail(f"{rec.prefills} prefills for {len(reqs)} requests")
    paged_calls = 0 if kv_dtype == "int8" else L * rec.decode_steps
    if not (launches["flash_attention"] == L * rec.prefills > 0
            and launches["paged_decode_attention"] == paged_calls
            and rec.decode_steps > 0 and launches["flash_attention_bwd"] == 0):
        fail(f"launch counts {launches} != {L} x ({rec.prefills} prefills, "
             f"{rec.decode_steps} decode steps), kv_dtype {kv_dtype}")
    n_tok = sum(len(o.tokens) for o in outs.values())
    ttft = np.array([o.ttft for o in outs.values()]) * 1e3
    tpot = np.array([o.tpot for o in outs.values()]) * 1e3
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 tok_per_s=n_tok / wall,
                 ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p99_ms=float(np.percentile(ttft, 99)),
                 tpot_p50_ms=float(np.percentile(tpot, 50)),
                 prefills=rec.prefills, decode_steps=rec.decode_steps,
                 prefill_ms_total=sum(rec.ms["prefill"]),
                 prefill_ms_p50=float(np.percentile(rec.ms["prefill"], 50)),
                 decode_ms_total=sum(rec.ms["decode"]),
                 decode_step_ms_p50=float(np.percentile(rec.ms["decode"],
                                                        50)),
                 launches=launches, kv_dtype=kv_dtype,
                 pool_bytes=rec.pool_bytes,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prompt_lens=[len(r.prompt) for r in reqs],
                 max_new=[r.max_new_tokens for r in reqs])
    print(f"serve {cfg.name} " + json.dumps(stats))
    if tpot_limit_ms is not None:
        p50 = stats["tpot_p50_ms"]
        print(f"{cfg.name} TPOT p50 {p50:.2f} ms against {tpot_limit_ms} ms;"
              f" TTFT p99 {stats['ttft_p99_ms']:.1f} ms (not gated)")
        if not p50 <= tpot_limit_ms:
            fail(f"{cfg.name} TPOT p50 {p50:.2f} ms over {tpot_limit_ms} ms")
    if kv_dtype == "int8":
        cmp = int8_against_bf16(lm, cfg, eng.params, reqs)
        print(f"int8 against bf16 {cfg.name} " + json.dumps(cmp))
        if not cmp["max_abs_logit_diff"] < INT8_LOGIT_LIMIT:
            fail(f"the int8 pool's logits are {cmp['max_abs_logit_diff']:.3f}"
                 f" from the bf16 pool's, over {INT8_LOGIT_LIMIT}")
    return dict(launches, pool_bytes=rec.pool_bytes,
                tpot_p50_ms=stats["tpot_p50_ms"],
                tokens={rid: list(o.tokens) for rid, o in outs.items()})


# ---------------------------------------------------------------------------
# phase 5: top-k compression kernel
# ---------------------------------------------------------------------------

def _raw(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def topk_case(tk, gen, *, R, L, block, dtype, ef_dtype=None, theta=None,
              x=None, ef=None, label=""):
    """The kernel and the plain version on the same inputs, bit for bit;
    masked + resid == x + ef exactly where both are f32.  Returns the
    largest |difference| (0 when the bits agree)."""
    if x is None:
        x = torch.randn((R, L), generator=gen, device="cuda").to(dtype)
    if ef is None and ef_dtype is not None:
        ef = (0.3 * torch.randn((R, L), generator=gen,
                                device="cuda")).to(ef_dtype)
    if theta is None:
        theta = 0.05 + 0.95 * torch.rand((R,), generator=gen, device="cuda")
    got = tk.topk_compress_cuda(x, theta, ef=ef, block=block)
    torch.cuda.synchronize()
    want = tk.topk_compress_plain(x, theta, ef=ef, block=block)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    same = all(a.dtype == b.dtype and torch.equal(_raw(a), _raw(b))
               for a, b in zip(got, want))
    if not same:
        fail(f"top-k kernel differs from the plain version ({label} R={R} "
             f"L={L} block={block} {dtype} ef={ef_dtype}): max |diff| "
             f"{err}")
    if x.dtype == torch.float32 and (ef is None
                                     or ef.dtype == torch.float32):
        total = x if ef is None else x + ef
        if not torch.equal(got[0] + got[1], total):
            fail(f"masked + residual != x + ef ({label} R={R} L={L})")
    return err


def _edge_inputs(block):
    """Row 0: an all-zero block, then tied magnitudes; row 1: five
    distinct magnitudes, then random normals."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.zeros((2, 2 * block), device="cuda")
    sign = torch.randint(0, 2, (block,), generator=g, device="cuda") * 2 - 1
    x[0, block:] = 1.5 * sign
    vals = torch.tensor([-2.0, -0.5, 0.5, 1.0, 2.0], device="cuda")
    x[1, :block] = vals[torch.randint(0, 5, (block,), generator=g,
                                      device="cuda")]
    x[1, block:] = torch.randn((block,), generator=g, device="cuda")
    return x


def topk_bytes(x, ef):
    """Each input read once, each output written once (masked in x's
    type, residual in ef's)."""
    reads = x.element_size() + (0 if ef is None else ef.element_size())
    writes = x.element_size() + (x if ef is None else ef).element_size()
    return x.numel() * (reads + writes)


def topk_launches(xs, efs, tk):
    """Launches of one grouped top-k call over these leaves: one per (x
    type, ef type) pair and MAX_LEAVES leaves."""
    groups = {}
    for i, x in enumerate(xs):
        key = (x.dtype, None if efs is None else efs[i].dtype)
        groups[key] = groups.get(key, 0) + 1
    return sum(-(-n // tk.MAX_LEAVES) for n in groups.values())


def topk_leaves_case(tk, xs, efs, theta, block, label, inplace=False):
    """The grouped kernel against the per-leaf plain version (padded as
    the reference pads) on the same leaves, bit for bit, and its launches;
    with ``inplace`` the kernel writes over the leaves and their efs."""
    want = tk.topk_compress_leaves_plain(xs, theta, block=block, efs=efs)
    before = tk.LAUNCHES["topk_compress"]
    if inplace:
        xs = [x.clone() for x in xs]
        efs = [e.clone() for e in efs]
        outs = list(zip(xs, efs))
        got = tk.topk_compress_leaves_cuda(xs, theta, block=block, efs=efs,
                                           outs=outs)
        if any(g[0] is not x or g[1] is not e
               for g, x, e in zip(got, xs, efs)):
            fail(f"top-k in place did not return its outputs ({label})")
    else:
        got = tk.topk_compress_leaves_cuda(xs, theta, block=block, efs=efs)
    torch.cuda.synchronize()
    launches = tk.LAUNCHES["topk_compress"] - before
    if launches != topk_launches(xs, efs, tk):
        fail(f"grouped top-k: {launches} launches for {len(xs)} leaves "
             f"({label}), expected {topk_launches(xs, efs, tk)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not all(a.dtype == b.dtype and torch.equal(_raw(a), _raw(b))
                   for a, b in zip(g, w)):
            fail(f"grouped top-k differs from the per-leaf plain version "
                 f"({label}, leaf {i} of shape {tuple(xs[i].shape)} "
                 f"{xs[i].dtype}, ef "
                 f"{None if efs is None else efs[i].dtype}, block {block})")
    return launches


def topk_phase(tk, leaf_shapes, femnist_fc1):
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    n_cases = 0
    for R, L, block in TOPK_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            for ef_dtype in (None, dtype, torch.float32):
                worst = max(worst, topk_case(tk, gen, R=R, L=L, block=block,
                                             dtype=dtype, ef_dtype=ef_dtype,
                                             label="grid"))
                n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = _edge_inputs(256).to(dtype)
        for th in (1.0, 1e-4, 0.3):  # everything kept; k = 1; ties
            theta = torch.full((2,), th, device="cuda")
            for ef_dtype in (None, torch.float32):
                ef = None
                if ef_dtype is not None:  # keeps the zero block zero
                    ef = torch.zeros((2, 512), device="cuda")
                    ef[1] = 0.25 * torch.randn((512,), generator=gen,
                                               device="cuda")
                worst = max(worst, topk_case(
                    tk, gen, R=2, L=512, block=256, dtype=dtype, x=x,
                    ef=ef, theta=theta, label=f"edge theta={th}"))
                n_cases += 1
        if tk.topk_compress_cuda(x, torch.full((2,), 0.3, device="cuda"),
                                 block=256)[0][0, :256].any():
            fail("top-k kernel kept a nonzero in an all-zero block")

    # the grouped kernel: a table per type pair, ragged leaves, in place
    R = 64
    theta = 0.05 + 0.95 * torch.rand((R,), generator=gen, device="cuda")
    rn = lambda L, dt, sc=1.0: (sc * torch.randn(
        (R, L), generator=gen, device="cuda")).to(dt)
    f32, bf16 = torch.float32, torch.bfloat16
    n_tables, n_leaves = 0, 0
    for block, Ls in TOPK_RAGGED.items():
        for xd, ed in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, None)):
            xs = [rn(L, xd) for L in Ls]
            xs[0].zero_()  # an all-zero leaf
            xs[-1][:, :block] = 1.5  # a block of tied magnitudes
            efs = None if ed is None else [rn(L, ed, 0.3) for L in Ls]
            if efs is not None:
                efs[0].zero_()
            topk_leaves_case(tk, xs, efs, theta, block,
                             f"ragged block {block}")
            n_tables += 1
            n_leaves += len(xs)
    mixed = [(300, f32, f32), (1000, bf16, bf16), (257, bf16, f32),
             (64, f32, f32), (5000, bf16, bf16), (1, bf16, f32),
             (768, f32, f32)]
    xs = [rn(L, xd) for L, xd, _ in mixed]
    efs = [rn(L, ed, 0.3) for L, _, ed in mixed]
    if topk_leaves_case(tk, xs, efs, theta, 256, "mixed types") != 3:
        fail("a table of three type pairs did not take three launches")
    topk_leaves_case(tk, xs, efs, theta, 256, "mixed types, in place",
                     inplace=True)
    many = [rn(int(L), f32) for L in
            torch.randint(1, 700, (2 * tk.MAX_LEAVES + 5,), generator=gen,
                          device="cuda").tolist()]
    efs = [rn(x.shape[1], f32, 0.3) for x in many]
    if topk_leaves_case(tk, many, efs, theta, 256, "long table") != 3:
        fail(f"{len(many)} leaves of one type pair did not take three "
             f"launches")
    n_tables += 3
    n_leaves += 2 * len(mixed) + len(many)
    print(f"topk grouped: {n_tables} tables of {n_leaves} leaves bit for "
          f"bit equal to the per-leaf plain version (ragged L "
          f"{TOPK_RAGGED}, blocks 32/256/1024, f32/bf16 mixed, in place, "
          f"{len(many)} leaves in three launches)")

    # the main path: every ResNet-20 leaf at its own length, R = 64, f32
    # delta and f32 EF, theta as the controller hands it over (f32)
    block = 256
    xs = [rn(int(np.prod(shape)), f32) for shape in leaf_shapes]
    efs = [rn(x.shape[1], f32, 0.3) for x in xs]
    if topk_leaves_case(tk, xs, efs, theta, block, "resnet20 leaves") != 1:
        fail("the ResNet-20 leaves did not take one launch")
    for x, e, (m, r) in zip(xs, efs, tk.topk_compress_leaves_cuda(
            xs, theta, block=block, efs=efs)):
        if not torch.equal(m + r, x + e):
            fail("masked + residual != x + ef (resnet20 leaves)")
    # timed as the round calls it: in place (the data do not change the
    # work: 16 bisection steps a block whatever the values)
    xs_w, efs_w = [x.clone() for x in xs], [e.clone() for e in efs]
    round_k = lambda: tk.topk_compress_leaves_cuda(
        xs_w, theta, block=block, efs=efs_w, outs=list(zip(xs_w, efs_w)))
    round_p = lambda: tk.topk_compress_leaves_plain(xs, theta, block=block,
                                                    efs=efs)
    # how the round ran before: a one-leaf launch per leaf, padded to the
    # block (F.pad of x and ef, results copied back) where L is ragged
    pads = [(-x.shape[1]) % block for x in xs]
    per_leaf = lambda: [
        tk.topk_compress_cuda(x, theta, ef=e, block=block) if not p else
        [t[:, :x.shape[1]].clone() for t in tk.topk_compress_cuda(
            torch.nn.functional.pad(x, (0, p)), theta, block=block,
            ef=torch.nn.functional.pad(e, (0, p)))]
        for x, e, p in zip(xs, efs, pads)]
    nbytes = sum(topk_bytes(x, e) for x, e in zip(xs, efs))
    ms = time_ms(round_k)
    lead = dict(last_timing)
    call_ms = time_ms(round_k, host_paced=True)
    old_ms = time_ms(per_leaf)
    old_lead = dict(last_timing)
    plain_ms = time_ms(round_p, iters=3, warmup=1)
    bound_ms, bound_by = bound(0, nbytes, torch.float32)
    main = dict(case=f"resnet20 round: {len(xs)} leaves at their own "
                f"lengths, R=64, block 256, f32 x/ef, in place, one launch",
                elements=sum(x.numel() for x in xs), bytes=nbytes,
                launches_per_call=1, max_abs_err=worst, ms=ms,
                call_ms=call_ms, host_queue_ms=lead["host_queue_ms"],
                lead_ms=lead["lead_ms"], lead_lengthened=lead["lengthened"],
                per_leaf_ms=old_ms,
                per_leaf_host_queue_ms=old_lead["host_queue_ms"],
                per_leaf_launches=len(xs), ragged_leaves=sum(map(bool, pads)),
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)
    print("topk " + json.dumps(main))

    # where the kernel does real work: FEMNIST-CNN's fc1_w at R = 64
    L = int(np.prod(femnist_fc1))
    x = torch.randn((R, L), generator=gen, device="cuda")
    ef = 0.3 * torch.randn((R, L), generator=gen, device="cuda")
    err = topk_case(tk, gen, R=R, L=L, block=block, dtype=torch.float32,
                    x=x, ef=ef, theta=theta, label="femnist fc1_w")
    nbytes = topk_bytes(x, ef)
    bound_f, by_f = bound(0, nbytes, torch.float32)
    big = dict(case=f"femnist fc1_w {tuple(femnist_fc1)}, R=64, block 256, "
               f"f32 x/ef", elements=x.numel(), bytes=nbytes,
               max_abs_err=err,
               ms=time_ms(lambda: tk.topk_compress_cuda(x, theta, ef=ef,
                                                        block=block)),
               plain_ms=time_ms(lambda: tk.topk_compress_plain(
                   x, theta, ef=ef, block=block), iters=3, warmup=1),
               bound_ms=bound_f, bound_by=by_f, library_ms=None)
    print("topk " + json.dumps(big))
    print(f"topk: {n_cases + 1} one-leaf cases bitwise equal to the plain "
          f"version")
    del x, ef, xs, efs, xs_w, efs_w, many
    torch.cuda.empty_cache()
    main["max_abs_err"] = max(worst, err)
    return main


def topk_wide_case(tk, R, L, xd, ed, small_L, theta, label):
    """The grouped kernel in place on a table of an (R, L) leaf of x
    type ``xd`` and EF type ``ed`` and a small f32 leaf with f32 EF: two
    type pairs, two launches, held bit for bit to the plain version.  The
    large leaf's inputs are drawn in column chunks of whole blocks from
    seeds of their own and drawn again after the launch, and the plain
    version runs chunk by chunk on them: blocks are independent and only
    the last one is padded, so that is the plain version on the leaf,
    with no second copy of it on the card.  Returns the case's numbers."""
    block, W = 1024, 1 << 26
    chunks = [(a, min(a + W, L)) for a in range(0, L, W)]

    def draw(i):
        a, b = chunks[i]
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        x = torch.randn((R, b - a), generator=g, device="cuda")
        ef = 0.3 * torch.randn((R, b - a), generator=g, device="cuda")
        if b == L:  # an all-zero block past 2^31, then the ragged tail
            x[-1, -(block + L % block):] = 0.0
            ef[-1, -(block + L % block):] = 0.0
        return x.to(xd), ef.to(ed)

    x = torch.empty((R, L), dtype=xd, device="cuda")
    ef = torch.empty((R, L), dtype=ed, device="cuda")
    for i, (a, b) in enumerate(chunks):
        x[:, a:b], ef[:, a:b] = draw(i)
    g = torch.Generator(device="cuda").manual_seed(11)
    xs = torch.randn((R, small_L), generator=g, device="cuda")
    es = 0.3 * torch.randn((R, small_L), generator=g, device="cuda")
    want_s = tk.topk_compress_leaves_plain([xs], theta, block=block,
                                           efs=[es])[0]
    before = tk.LAUNCHES["topk_compress"]
    table = lambda: tk.topk_compress_leaves_cuda(
        [x, xs], theta, block=block, efs=[ef, es],
        outs=[(x, ef), (xs, es)])
    table()
    torch.cuda.synchronize()
    launches = tk.LAUNCHES["topk_compress"] - before
    if launches != 2:
        fail(f"grouped top-k: {launches} launches for two type pairs "
             f"({label})")
    if not all(torch.equal(_raw(a), _raw(b))
               for a, b in zip((xs, es), want_s)):
        fail(f"grouped top-k differs from the plain version on the small "
             f"f32 leaf ({label})")
    for i, (a, b) in enumerate(chunks):
        xc, ec = draw(i)
        m, r = tk.topk_compress_leaves_plain([xc], theta, block=block,
                                             efs=[ec])[0]
        if not (torch.equal(_raw(x[:, a:b]), _raw(m))
                and torch.equal(_raw(ef[:, a:b]), _raw(r))):
            fail(f"grouped top-k differs from the plain version ({label}, "
                 f"columns {a}:{b} of ({R}, {L}) {xd}, ef {ed})")
        del xc, ec, m, r
    nbytes = topk_bytes(x, ef) + topk_bytes(xs, es)
    bound_ms, bound_by = bound(0, nbytes, torch.float32)
    out = dict(case=f"mamba2-1.3b round: ({R}, {L}) {str(xd)[6:]} x, "
               f"{str(ed)[6:]} EF, + ({R}, {small_L}) f32, block {block}, "
               f"in place", elements=R * (L + small_L), bytes=nbytes,
               launches_per_call=launches, max_abs_err=0.0,
               ms=time_ms(table, iters=3, warmup=1), bound_ms=bound_ms,
               bound_by=bound_by)
    print("topk " + json.dumps(out))
    del x, ef, xs, es
    torch.cuda.empty_cache()
    return out


def topk_mamba2_cases(tk, configs, mamba2):
    """The grouped kernel at a mamba2-1.3B round's shapes: R = 4 replicas,
    block 1024, its largest leaf (w_in, bf16, num_layers x d_model x
    proj_in per replica).  With the round's own EF (the parameters' type)
    beside the f32 A_log leaf, and with f32 EF at w_in's length + 300
    (ragged) beside a ragged f32 leaf."""
    from repro_torch.tree import flatten
    cfg = configs.get_config("mamba2_1p3b").model
    one = flatten(mamba2.init(cfg.replace(num_layers=1, vocab_size=256),
                              seed=0, device="cpu"))
    per_replica = lambda name: one[name].numel() * cfg.num_layers
    L_in, L_a = per_replica("layers/w_in"), per_replica("layers/A_log")
    R = 4
    print(f"topk mamba2 cases: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated before")
    if R * L_in <= 2**31:
        fail(f"w_in's {R} x {L_in} entries do not pass 2^31")
    theta = torch.tensor(SPARSE_THETA, device="cuda")  # phase 12's
    bf16, f32 = torch.bfloat16, torch.float32
    return [topk_wide_case(tk, R, L_in, bf16, bf16, L_a, theta,
                           "mamba2 w_in, bf16 EF"),
            topk_wide_case(tk, R, L_in + 300, bf16, f32, 1000, theta,
                           "mamba2 w_in + 300, f32 EF")]


# ---------------------------------------------------------------------------
# phases 6 and 7: the FedSim round
# ---------------------------------------------------------------------------

HIST_KEYS = ("loss", "rho_mean", "theta_mean", "time", "energy")


def fedsim_agrees(fedsim):
    """A small MLP FedSim (8 devices in 4 clusters, the ResNet-20
    configuration's round and budgets) for 3 rounds on the card and on the
    CPU, from the same parameters and masked-step bits."""
    def three_rounds(dev):
        sim = fedsim.make_sim("hcef", model="mlp", n_devices=8, n_clusters=4,
                              n_train=2048, device=dev)
        return [sim.run_round() for _ in range(3)]

    cpu, card = three_rounds("cpu"), three_rounds("cuda")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(card, cpu) for k in HIST_KEYS)
    print(f"fedsim small: card vs CPU over 3 rounds, largest relative "
          f"deviation of {HIST_KEYS} {worst:.3e} (tolerance {FEDSIM_RTOL}); "
          f"theta_mean {[round(h['theta_mean'], 4) for h in card]}")
    if not worst <= FEDSIM_RTOL:
        fail("the FedSim path on the card disagrees with the CPU path")


def fedsim_full(fedsim, tk):
    """ResNet-20 at the paper's topology: FEDSIM_ROUNDS rounds of
    ``FedSim.run`` as the launcher drives it, every top-k launch counted:
    one a round (all 59 leaves and their efs are f32)."""
    t0 = time.perf_counter()
    sim = fedsim.make_sim("hcef", model="resnet20", device="cuda")
    torch.cuda.synchronize()
    n_leaves = len(sim.params)
    n_params = sum(p[0].numel() for p in sim.params.values())
    per_round = topk_launches(list(sim.params.values()),
                              list(sim.ef.values()), tk)
    print(f"fedsim resnet20: {n_params} params in {n_leaves} leaves, "
          f"{sim.cfg.n_devices} devices in {sim.cfg.n_clusters} clusters, "
          f"set up in {time.perf_counter() - t0:.1f} s")
    sim.timings = {}
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    sim.run(FEDSIM_ROUNDS, eval_every=5,
            on_round=fedsim.print_round(sim, "resnet20 "))
    launches = tk.LAUNCHES["topk_compress"]
    hist, walls = sim.history, sim.round_ms
    if len(hist) != FEDSIM_ROUNDS:
        fail(f"the run stopped after {len(hist)} of {FEDSIM_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if not min(h["theta_mean"] for h in hist) < 1.0:
        fail("theta_mean is 1 in every round: Q dropped nothing")
    if per_round != 1 or launches != per_round * FEDSIM_ROUNDS:
        fail(f"{launches} top-k launches, expected one a round for the "
             f"{n_leaves} leaves ({per_round}) x {FEDSIM_ROUNDS} rounds")
    if sim.budget.l < 2:
        fail(f"{sim.budget.l} gossip rounds, expected 2")
    if any(b["time"] < a["time"] or b["energy"] < a["energy"]
           for a, b in zip(hist, hist[1:])):
        fail("simulated time or energy decreased")
    acc = hist[-1]["acc"]
    if not 0.0 <= acc <= 1.0:
        fail(f"accuracy {acc}")
    med = lambda v: float(np.percentile(v, 50))
    stats = dict(rounds=FEDSIM_ROUNDS, gossip_rounds=sim.budget.l,
                 round_wall_ms_p50=med(walls), round_wall_ms=walls,
                 phase_ms_p50={k: med(v) for k, v in sim.timings.items()},
                 launches=launches, acc=acc,
                 loss=[h["loss"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 rho_mean=[h["rho_mean"] for h in hist],
                 time_s=hist[-1]["time"], energy_j=hist[-1]["energy"],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("fedsim " + json.dumps(stats))
    return launches


# ---------------------------------------------------------------------------
# phase 8: the SSD scan kernels
# ---------------------------------------------------------------------------

def ssd_inputs(gen, *, b, s, h, p, g, n, dtype, regime="test",
               zero_x=False):
    """x, dt, A, B, C on the card; x, B, C normal.  ``regime="test"``
    draws dt ~ U(0.001, 0.1) and A ~ -U(0.5, 2) as tests/test_kernels.py
    does; ``"model"`` draws them as mamba2's init gives them (dt =
    softplus(N(0, 1)), about 0.7, and A = -1): a 256-step chunk's decay
    then reaches about exp(-180), where exp(cs) and the state decays
    underflow."""
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    ru = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device="cuda")
    x = torch.zeros((b, s, h, p), device="cuda") if zero_x else rn(b, s, h, p)
    if regime == "model":
        dt = torch.nn.functional.softplus(rn(b, s, h))
        A = -torch.ones(h, device="cuda")
    else:
        dt, A = ru(0.001, 0.1, b, s, h), -ru(0.5, 2.0, h)
    return [x.to(dtype), dt, A, rn(b, s, g, n).to(dtype),
            rn(b, s, g, n).to(dtype)]


def layer_inputs(configs, mamba2, gen):
    """x, dt, A, B, C as the first layer of mamba2-1.3B at full width hands
    them to ``ops.ssd`` (``models/mamba2.py:_block``): seeded weights, two
    random sequences of 512 tokens, as the main path's local step has."""
    from repro_torch.models.common import dtype_of, rms_norm
    cfg = configs.get_config("mamba2_1p3b").model.replace(num_layers=1)
    params = mamba2.init(cfg, seed=9, device="cuda")
    w = mamba2.layer_list(params)[0]
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                           device="cuda")
    with torch.no_grad():
        x = params["emb"][tokens].to(dtype_of(cfg.compute_dtype))
        _, xs, Bm, Cm, dt, _ = mamba2._block_core(
            cfg, rms_norm(x, w["ln"], cfg.norm_eps), w)
        A = -torch.exp(w["A_log"])
    return [t.contiguous() for t in (xs, dt, A, Bm, Cm)], cfg.ssm_chunk


def ssd_work(*, b, s, h, p, g, n, chunk, dtype, f32_pipes=False):
    """(forward, backward), each ({type: operations}, bytes), that the
    inputs need: the causal half of each chunk's L x L products, 2
    operations per multiply-add.  G = C Bt is formed once per (b, group,
    chunk) and shared by the group's heads; the backward forms G again, and
    dC = dG B and dB = dGt C once per group (dG summed over the group's
    heads first).  bf16 inputs run every product on the tensor cores (bf16
    in, f32 accumulation; an f32 operand as a bf16 pair is two products of
    the same size, which the count leaves out), so all of it counts at the
    bf16 peak; with ``f32_pipes`` they count as before the tensor-core
    kernels: G at the bf16 peak (exact there), the rest at the f32 peak.
    f32 inputs count everything at the f32 peak.  Bytes: each input read
    once, each output written once (the forward's chunk states included,
    the backward's scratch not)."""
    nc = -(-s // chunk)
    tri = sum(min(chunk, s - c * chunk) * (min(chunk, s - c * chunk) + 1)
              // 2 for c in range(nc))          # (l, s) pairs with s <= l
    state = 2 * s * n * p                       # y_off and S_new per step
    cb = 2 * b * g * tri * n                    # G = C Bt, per group

    def ops(rest):
        if dtype == torch.float32:
            return {torch.float32: rest + cb}
        if f32_pipes:
            return {torch.float32: rest, torch.bfloat16: cb}
        return {torch.bfloat16: rest + cb}
    fwd = ops(2 * b * h * (tri * p + state))
    bwd = ops(2 * b * g * tri * 2 * n + 2 * b * h * (2 * tri * p
                                                     + 2 * state))
    e = torch.tensor([], dtype=dtype).element_size()
    io = b * s * (2 * h * p + 2 * g * n) * e + b * s * h * 4 + h * 4
    states = b * h * nc * p * n * 4
    return (fwd, io + states), (bwd, 2 * io + states)


def ssd_case(ss, gen, args, *, label, chunk, zero_x=False, timed=False):
    """Both kernels against their plain versions on one input (x, dt, A, B,
    C); returns the worst (forward, backward) errors and, if ``timed``,
    the timings."""
    dtype = args[0].dtype
    b, s, h, p = args[0].shape
    g, n = args[3].shape[2:]
    shape = dict(b=b, s=s, h=h, p=p, g=g, n=n)
    plans = [ss.plan(dtype, b, s, h, p, g, n, chunk, backward=bwd)
             for bwd in (False, True)]
    route = plans[0].route
    if route != plans[1].route or route != (
            "tc" if dtype == torch.bfloat16 else "simt"):
        fail(f"SSD kernels: {dtype} ran {[q.route for q in plans]} "
             f"({label}); bf16 runs the tensor-core kernels, f32 the SIMT")
    y, states = ss.ssd_fwd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    y_p = ss.ssd_plain(*args, chunk=chunk)
    y64 = ss.ssd_plain(*[a.double() for a in args], chunk=chunk)
    scale_f = max(float(y64.abs().max()), 1e-30)
    lim = tol["atol"] + tol["rtol"] * y64.abs()

    def meets(out):
        # and within rtol of y's largest entry: atol alone would pass
        # anything on small activations (mamba2's layer gives |y| < 1)
        d = (out.double() - y64).abs()
        return (bool((d <= lim).all()) and float(d.max())
                <= tol["rtol"] * scale_f), float(d.max())
    ok_f, err_f = meets(y)
    plain_ok, err_fp = meets(y_p)
    if not plain_ok:
        ok_f = err_f <= SSD_PLAIN_FACTOR * err_fp
    if dtype == torch.bfloat16:  # and within the plain bf16 version's reach
        ok_f &= err_f <= SSD_PLAIN_FACTOR * err_fp
    if not bool(torch.isfinite(y.float()).all()):
        fail(f"SSD forward kernel: non-finite y ({label})")
    if zero_x and not bool((y == 0).all()):
        fail(f"SSD forward kernel: nonzero y for x = 0 ({label})")
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    leaves_k = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ss.ssd_cuda(*leaves_k, chunk=chunk), leaves_k,
                              dy)
    torch.cuda.synchronize()
    leaves_p = [a.clone().requires_grad_() for a in args]
    y_pg = ss.ssd_plain(*leaves_p, chunk=chunk)
    plain = torch.autograd.grad(y_pg, leaves_p, dy, retain_graph=True)
    leaves_64 = [a.double().requires_grad_() for a in args]
    want = torch.autograd.grad(ss.ssd_plain(*leaves_64, chunk=chunk),
                               leaves_64, dy.double())
    err_b, abs_b, plain_b, ok_b = 0.0, 0.0, 0.0, True
    per_grad = {}
    for name, a, pl, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                              want):
        if a.dtype != pl.dtype or a.shape != pl.shape:
            fail(f"SSD backward kernel: {name} {a.dtype} {tuple(a.shape)}, "
                 f"plain {pl.dtype} {tuple(pl.shape)} ({label})")
        if not bool(torch.isfinite(a.float()).all()):
            fail(f"SSD backward kernel: non-finite {name} ({label})")
        scale = max(float(w.abs().max()), 1e-30)
        e = float((a.double() - w).abs().max())
        e_plain = float((pl.double() - w).abs().max())
        err_b, abs_b = max(err_b, e / scale), max(abs_b, e)
        plain_b = max(plain_b, e_plain / scale)
        per_grad[name] = [e / scale, e_plain / scale]
        tol_g = SSD_BWD_TOL[dtype] * scale
        ok_b &= e <= (tol_g if e_plain <= tol_g
                      else SSD_PLAIN_FACTOR * e_plain)
    row = dict(case=label, dtype=str(dtype)[6:], chunk=chunk, **shape,
               kernel=route,
               launches_per_call=[q.launches for q in plans],
               max_abs_err=err_f, plain_max_abs_err=err_fp, tol=tol["atol"],
               fwd_err_of_max=err_f / scale_f,
               fwd_plain_err_of_max=err_fp / scale_f,
               bwd_max_abs_err=abs_b, bwd_err_of_max=err_b,
               bwd_plain_err_of_max=plain_b,
               bwd_tol_of_max=SSD_BWD_TOL[dtype],
               bwd_kernel_and_plain_err_of_max=per_grad)
    if timed:
        (f_ops, f_bytes), (b_ops, b_bytes) = ssd_work(
            chunk=chunk, dtype=dtype, **shape)
        with torch.no_grad():
            row["fwd_ms"] = time_ms(lambda: ss.ssd_fwd_cuda(*args,
                                                            chunk=chunk))
            row["fwd_plain_ms"] = time_ms(
                lambda: ss.ssd_plain(*args, chunk=chunk), iters=3, warmup=1)
            row["bwd_ms"] = time_ms(lambda: ss.ssd_bwd_cuda(
                dy, *args, states, chunk=chunk))
        row["bwd_plain_ms"] = time_ms(lambda: torch.autograd.grad(
            y_pg, leaves_p, dy, retain_graph=True), iters=3, warmup=1)
        with torch.no_grad():
            row["fwd_split_us"] = kernel_split(
                lambda: ss.ssd_fwd_cuda(*args, chunk=chunk))
            row["bwd_split_us"] = kernel_split(
                lambda: ss.ssd_bwd_cuda(dy, *args, states, chunk=chunk))
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(f_ops, f_bytes)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound(b_ops, b_bytes)
        if dtype == torch.bfloat16:  # what the f32 pipes would allow
            (f32_f, _), (f32_b, _) = ssd_work(chunk=chunk, dtype=dtype,
                                              f32_pipes=True, **shape)
            row["fwd_bound_f32_pipes_ms"] = bound(f32_f, f_bytes)[0]
            row["bwd_bound_f32_pipes_ms"] = bound(f32_b, b_bytes)[0]
        gflop = lambda ops: {str(d)[6:]: v / 1e9 for d, v in ops.items()}
        row.update(fwd_gflop=gflop(f_ops), fwd_mb=f_bytes / 1e6,
                   bwd_gflop=gflop(b_ops), bwd_mb=b_bytes / 1e6)
    print("ssd " + json.dumps(row))
    if not (ok_f and ok_b):
        fail(f"SSD kernels disagree with the plain versions: {row}")
    return row


def ssd_phase(ss, configs, mamba2):
    gen = torch.Generator(device="cuda").manual_seed(8)
    chunk = SSD_MAIN["chunk"]
    shape = {k: v for k, v in SSD_MAIN.items() if k != "chunk"}
    drawn = lambda dtype, **kw: ssd_inputs(gen, dtype=dtype,
                                           **{**shape, **kw})
    rows = []
    for b, s, h, p, g, n, c in SSD_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(ssd_case(
                ss, gen, ssd_inputs(gen, b=b, s=s, h=h, p=p, g=g, n=n,
                                    dtype=dtype), label="grid", chunk=c))
    # the main path's own inputs: one full-width layer's activations
    layer = layer_inputs(configs, mamba2, gen)[0]
    main = ssd_case(ss, gen, layer, label="mamba2 layer 0", chunk=chunk,
                    timed=True)
    rows.append(ssd_case(ss, gen, layer, chunk=chunk // 2,  # nc = 4
                         label="mamba2 layer 0, chunk 128"))
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(ssd_case(ss, gen, drawn(dtype), chunk=chunk,
                             label="main shape"))
        rows.append(ssd_case(ss, gen, drawn(dtype, regime="model"),
                             chunk=chunk, label="main shape, model dt/A"))
        rows.append(ssd_case(ss, gen, drawn(dtype, s=300), chunk=chunk,
                             label="padded s=300"))
    rows.append(ssd_case(ss, gen, drawn(torch.bfloat16, zero_x=True),
                         chunk=chunk, zero_x=True, label="x = 0"))
    print(f"ssd: {len(rows) + 1} cases within tolerance; forward worst "
          f"{max(r['max_abs_err'] for r in rows + [main]):.3e} absolute, "
          f"{max(r['fwd_err_of_max'] for r in rows + [main]):.3e} of y's "
          f"max; backward "
          f"worst {max(r['bwd_err_of_max'] for r in rows + [main]):.3e} "
          f"of each gradient's max")
    common = dict(library_ms=None, max_abs_err=main["max_abs_err"])
    return ({**common, "ms": main["fwd_ms"], "plain_ms": main["fwd_plain_ms"],
             "bound_ms": main["fwd_bound_ms"],
             "bound_by": main["fwd_bound_by"]},
            {**common, "max_abs_err": main["bwd_max_abs_err"],
             "ms": main["bwd_ms"], "plain_ms": main["bwd_plain_ms"],
             "bound_ms": main["bwd_bound_ms"],
             "bound_by": main["bwd_bound_by"]})


# ---------------------------------------------------------------------------
# phase 9: the HCEF round step on mamba2
# ---------------------------------------------------------------------------

def small_round_agrees(configs, mamba2, rnd_mod, base):
    """Three rounds (the last a gossip round) of the smoke mamba2's round
    step on the card and on the CPU, from the same parameters, tokens,
    controls and bits: losses, statistics and parameters within
    ROUND_RTOL / ROUND_ATOL."""
    from repro_torch.tree import flatten
    cfg = configs.smoke_model(configs.get_config("mamba2_1p3b").model)
    hcef = base.HCEFConfig(tau=4, q=3, eta=0.1)
    topo = base.FLTopology(2, 2)
    params0 = mamba2.init(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    rng = np.random.default_rng(3)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 40)))
              for _ in range(3)]
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    theta = np.array([0.5, 0.25, 1.0, 0.1])
    runs = {}
    for dev in ("cpu", "cuda"):
        state = rnd_mod.init_state(cfg, hcef, topo, params0, device=dev)
        hist = []
        for r in range(3):
            step = rnd_mod.make_round_step(cfg, hcef, topo, gossip=r == 2)
            state, m = step(state, {"tokens": tokens[r]}, rho, theta, 7 + r)
            hist.append({k: v.cpu().numpy() for k, v in m.items()})
        runs[dev] = (hist, {k: v.cpu() for k, v in
                            flatten(state.params).items()})
    worst = 0.0
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        for k in ("loss", "g2", "sigma2"):
            worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                            / np.abs(b[k]))))
        if not np.array_equal(a["steps"], b["steps"]):
            fail("the card's round drew other masked-step bits")
    perr = max(float((runs["cuda"][1][k] - v).abs().max())
               for k, v in runs["cpu"][1].items())
    print(f"mamba2 small round: card vs CPU over 3 rounds, largest relative "
          f"deviation of loss/g2/sigma2 {worst:.3e} (tolerance {ROUND_RTOL}),"
          f" largest parameter deviation {perr:.3e} (tolerance "
          f"{ROUND_ATOL})")
    if not (worst <= ROUND_RTOL and perr <= ROUND_ATOL):
        fail("the mamba2 round step on the card disagrees with the CPU")


def mamba2_topk_launches(configs, mamba2, tk):
    """Top-k launches a round of mamba2-1.3B: one per (parameter type, EF
    type) pair of its leaves (EF holds the parameters' type).  The leaves
    and their types do not depend on the depth, so one layer tells."""
    from repro_torch.tree import flatten
    cfg = configs.get_config("mamba2_1p3b").model.replace(num_layers=1)
    leaves = list(flatten(mamba2.init(cfg, seed=0, device="cuda")).values())
    n = topk_launches(leaves, leaves, tk)
    print(f"mamba2 top-k: {len(leaves)} leaves of types "
          f"{sorted({str(x.dtype) for x in leaves})}: {n} launches a round")
    del leaves
    torch.cuda.empty_cache()
    return n


def mamba2_full(train, ss, tk, topk_per_round):
    """The launcher's entry point on mamba2-1.3B at full width: every SSD
    and top-k launch of the run counted (top-k: ``topk_per_round`` a
    round), the run's numbers checked."""
    argv = ["--arch", "mamba2_1p3b", "--full", "--rounds",
            str(MAMBA2_ROUNDS), "--seq", "511"]
    print("python -m repro_torch.launch.train " + " ".join(argv))
    torch.cuda.empty_cache()
    ss.reset_launches()
    tk.reset_launches()
    out = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ss.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"])
    cfg, hist = out["cfg"], out["history"]
    tau, R = 4, 4  # the configuration's HCEFConfig and the host topology
    steps = MAMBA2_ROUNDS * R * tau
    want = {"ssd_scan_fwd": steps * cfg.num_layers * (2 if cfg.remat else 1),
            "ssd_scan_bwd": steps * cfg.num_layers,
            "topk_compress": MAMBA2_ROUNDS * topk_per_round}
    if len(hist) != MAMBA2_ROUNDS:
        fail(f"the launcher ran {len(hist)} of {MAMBA2_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    if any(b["time"] < a["time"] or b["energy"] < a["energy"]
           for a, b in zip(hist, hist[1:])):
        fail("simulated time or energy decreased")
    if not hist[-1]["gossip"] or any(h["gossip"] for h in hist[:-1]):
        fail("expected gossip in the last round only")
    med = lambda v: float(np.percentile(v, 50))
    stats = dict(rounds=MAMBA2_ROUNDS, layers=cfg.num_layers,
                 d_model=cfg.d_model, params=out["n_params"],
                 round_wall_ms_p50=med(out["round_ms"]),
                 round_wall_ms=out["round_ms"],
                 phase_ms_p50={k: med(v) for k, v in out["timings"].items()},
                 phase_ms=out["timings"],
                 launches_per_round={k: v / MAMBA2_ROUNDS
                                     for k, v in launches.items()},
                 loss=[h["loss"] for h in hist],
                 rho_mean=[h["rho_mean"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 time_s=hist[-1]["time"], energy_j=hist[-1]["energy"],
                 peak_mem_gb=out["peak_mem_gb"])
    print("mamba2 " + json.dumps(stats))
    TRAIN_CELLS["mamba2"] = dict(cfg=cfg, replicas=R, tau=tau,
                                 seqs_per_step=2, positions=512,
                                 params=out["n_params"],
                                 p50_ms=stats["round_wall_ms_p50"],
                                 peak_gb=out["peak_mem_gb"])
    return launches


# ---------------------------------------------------------------------------
# phase 10: the wire kernels
# ---------------------------------------------------------------------------

def _bits(t):
    """A tensor's bits as integers, for bit-for-bit comparisons."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}
                  .get(t.dtype, t.dtype))


def wire_blocks(gen, m, nb, wb, k_b):
    """(m, nb, wb) f32 on the card: block 0 all zero; block 1 with fewer
    nonzeros than k_b; block 2 with k_b + 5 magnitudes equal to its k_b-th
    largest; block 3 with magnitudes spaced below the bisection's
    resolution (max * 2^-16); the rest normal.  Signs random."""
    x = torch.randn((m, nb, wb), generator=gen, device="cuda")
    x[:, 0] = 0.0
    x[:, 1] = 0.0
    nz = k_b // 2
    if nz:
        x[:, 1, :nz] = torch.randn((m, nz), generator=gen, device="cuda")
    thr = x[:, 2].abs().sort(dim=-1, descending=True).values[:, k_b - 1]
    pick = torch.randperm(wb, generator=gen, device="cuda")[:min(wb, k_b + 5)]
    x[:, 2, pick] = thr[:, None]
    dense = 1.0 + torch.arange(wb, device="cuda") * 2.0 ** -22
    dense[0] = 2.0
    x[:, 3] = dense[torch.randperm(wb, generator=gen, device="cuda")]
    sign = torch.randint(0, 2, x.shape, generator=gen, device="cuda") * 2 - 1
    return (x * sign).contiguous()


def offset_forms(wb):
    """The offset forms the encode writes at wire block wb."""
    return ("i32", "p4") + (("u8",) if wb <= 256 else ())


def encoded_same(wp, got, want, omode, wb, what):
    """The encode kernel's (vals, offsets, scale) in form ``omode``
    against the plain encode's, its int32 offsets packed by
    ``pack_offsets_plain``, bit for bit."""
    if omode != "i32":
        want = (want[0], wp.pack_offsets_plain(want[1], wb=wb, mode=omode),
                want[2])
    for name, a, b in zip(("vals", "off", "scale"), got, want):
        if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
            fail(f"wire encode kernel ({omode} offsets) differs from its "
                 f"plain version in {name} ({what})")


def wire_check(wp, xb, k_b, wd, label, zero_payload=False):
    """encode (every offset form), p4 pack and p4 unpack against their
    plain versions on xb, bit for bit; the unpack also gives back the
    offsets, and an all-zero payload decodes to offset 0.  Returns
    (payload, off)."""
    wb = xb.shape[-1]
    want = wp.encode_blocks_plain(xb, k_b, wire_dtype=wd)
    for omode in offset_forms(wb):
        got = wp.encode_blocks_cuda(xb, k_b, wire_dtype=wd, omode=omode)
        torch.cuda.synchronize()
        encoded_same(wp, got, want, omode, wb,
                     f"{label} wb={wb} k_b={k_b} {wd}")
    off = want[1]
    packed = wp.pack_offsets_cuda(off, wb=wb)
    torch.cuda.synchronize()
    if not torch.equal(packed, wp.pack_offsets_plain(off, wb=wb,
                                                     mode="p4")):
        fail(f"p4 pack kernel differs from its plain version ({label} "
             f"wb={wb} k_b={k_b})")
    if zero_payload:  # a partial rotation's zero rows ride along
        packed = torch.cat([packed, torch.zeros_like(packed)])
    back = wp.unpack_offsets_cuda(packed, wb=wb, k_b=k_b)
    torch.cuda.synchronize()
    if not torch.equal(back, wp.unpack_offsets_plain(packed, wb=wb, k_b=k_b,
                                                     mode="p4")):
        fail(f"p4 unpack kernel differs from its plain version ({label} "
             f"wb={wb} k_b={k_b})")
    if not torch.equal(back[:off.shape[0]], off):
        fail(f"p4 unpack did not give back the offsets ({label})")
    if zero_payload and back[off.shape[0]:].any():
        fail(f"a zero payload decoded to nonzero offsets ({label})")
    return packed, off


def _bitmap_bits(packed, lo_bytes):
    """(n, nbytes) p4 bytes -> (n, 8 bm_bytes) int32 bits of the bitmap."""
    bm = packed[:, lo_bytes:].to(torch.int32)
    sh = torch.arange(8, dtype=torch.int32, device=packed.device)
    return ((bm[..., None] >> sh) & 1).reshape(bm.shape[0], -1)


def _with_bits(packed, lo_bytes, bits):
    sh = torch.arange(8, dtype=torch.int32, device=packed.device)
    out = packed.clone()
    out[:, lo_bytes:] = (bits.reshape(bits.shape[0], -1, 8) << sh).sum(
        -1).to(torch.uint8)
    return out


def p4_payloads(wp, gen, wb, k_b, n=3):
    """(packed, off) on the card: n valid p4 blocks (off: their int32
    offsets, (n, k_b)), n all-zero ones, n with fewer than k_b set bits
    (the first r < k_b kept), n with more (the last clear bit and about
    half the others set) and n of random bytes."""
    off = torch.rand((n, wb), generator=gen, device="cuda").argsort(
        dim=1)[:, :k_b].sort(dim=1).values.to(torch.int32)
    valid = wp.pack_offsets_plain(off, wb=wb, mode="p4")
    lo_bytes, _ = wp._p4_sizes(wb, k_b)
    bits = _bitmap_bits(valid, lo_bytes)
    keep = torch.randint(0, k_b, (n, 1), generator=gen, device="cuda")
    short = _with_bits(valid, lo_bytes, bits * (bits.cumsum(1) <= keep))
    clear = 1 - bits
    last = clear * (clear.flip(1).cumsum(1).flip(1) == 1)
    half = (torch.rand(bits.shape, generator=gen, device="cuda") < 0.5).int()
    full = _with_bits(valid, lo_bytes, bits | last | half)
    rand = torch.randint(0, 256, valid.shape, generator=gen, device="cuda",
                         dtype=torch.uint8)
    packed = torch.cat([valid, torch.zeros_like(valid), short, full, rand])
    nset = _bitmap_bits(packed, lo_bytes).sum(1)
    if not ((nset[2 * n:3 * n] < k_b).all() and (nset[3 * n:4 * n] > k_b)
            .all() and not nset[n:2 * n].any()):
        fail(f"p4 payloads at wb {wb}, k_b {k_b}: set bits {nset.tolist()}")
    return packed, off


def _at_phase(t, phase):
    """A copy of t whose data starts ``phase`` bytes past a 16-byte
    boundary."""
    n = t.numel() * t.element_size()
    buf = torch.empty(n + 32, dtype=torch.uint8, device=t.device)
    base = (-buf.data_ptr()) % 16 + phase
    view = buf[base:base + n].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def p4_grid(wp, gen):
    """The p4 pack and unpack kernels, both routes, against their plain
    versions bit for bit over P4_BLOCKS and k_b 1, 7, wb / 10, wb / 2 -
    1, wb - 1, wb: the pack on valid offsets, the unpack on p4_payloads
    at input byte phases 0 and 7.  Returns the cases run."""
    n = 0
    for wb in P4_BLOCKS:
        ks = sorted({k for k in (1, 7, wb // 10, wb // 2 - 1, wb - 1, wb)
                     if 1 <= k <= wb})
        routes = sorted({wp.encode_route(wb), "block"})
        for k_b in ks:
            packed, off = p4_payloads(wp, gen, wb, k_b)
            want_p = wp.pack_offsets_plain(off, wb=wb, mode="p4")
            want_u = wp.unpack_offsets_plain(packed, wb=wb, k_b=k_b,
                                             mode="p4")
            for route in routes:
                got = wp.pack_offsets_cuda(off[None], wb=wb,
                                           _force_block=route == "block")
                torch.cuda.synchronize()
                if not torch.equal(got[0], want_p):
                    fail(f"p4 pack kernel ({route}) differs from its plain "
                         f"version (wb={wb} k_b={k_b})")
                for phase in (0, 7):
                    got = wp.unpack_offsets_cuda(
                        _at_phase(packed[None], phase), wb=wb, k_b=k_b,
                        _force_block=route == "block")
                    torch.cuda.synchronize()
                    if not torch.equal(got[0], want_u):
                        bad = (got[0] != want_u).any(1).nonzero()[:, 0]
                        fail(f"p4 unpack kernel ({route}) differs from its "
                             f"plain version (wb={wb} k_b={k_b} byte phase "
                             f"{phase}, blocks {bad.tolist()} of 5 kinds x "
                             f"{packed.shape[0] // 5})")
                    n += 1
        print(f"wire p4 wb={wb}: pack and unpack on routes {routes}, k_b "
              f"{ks}, valid / zero / short / over-full / random bitmaps")
    return n


def p4_wide_case(wp, gen, packed_tile, wb, k_b):
    """The unpack kernel once over P4_WIDE_BLOCKS blocks (more than 2^31
    int32 offsets out at k_b 615): every other block a valid block of
    ``packed_tile`` (the w_in chunk's), the others random bytes; held to
    the plain version chunk by chunk."""
    blocks = P4_WIDE_BLOCKS
    if blocks * k_b <= 2 ** 31:
        fail(f"the wide unpack case has {blocks * k_b} offsets, not > 2^31")
    nbytes = sum(wp._p4_sizes(wb, k_b))
    packed = torch.randint(0, 256, (blocks, nbytes), generator=gen,
                           device="cuda", dtype=torch.uint8)
    tile = packed_tile.reshape(-1, nbytes)
    reps = -(-(blocks // 2) // tile.shape[0])
    packed[::2] = tile.repeat(reps, 1)[:blocks // 2]
    t0 = time.perf_counter()
    out = wp.unpack_offsets_cuda(packed[None], wb=wb, k_b=k_b)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    step = 1 << 17
    for i in range(0, blocks, step):
        want = wp.unpack_offsets_plain(packed[i:i + step], wb=wb, k_b=k_b,
                                       mode="p4")
        if not torch.equal(out[i:i + step], want):
            fail(f"p4 unpack kernel over {blocks} blocks differs from its "
                 f"plain version in blocks {i}..{i + step}")
    print(f"wire p4 unpack over {blocks} blocks, wb {wb}, k_b {k_b} "
          f"({blocks * k_b} offsets, {packed.numel()} bytes in): bit for "
          f"bit the plain version by {-(-blocks // step)} chunks; one launch, "
          f"{ms:.1f} ms host wall")
    del packed, out
    torch.cuda.empty_cache()


def encode_rows_check(wp, x, rows, k_b, wd, wb, label):
    """The encode kernel on rows of x read in place, in every offset
    form, against ``encode_rows_plain`` (index_select, zero pad, encode)
    and ``pack_offsets_plain``, bit for bit.  Returns the cases run."""
    want = wp.encode_rows_plain(x, rows, k_b, wb=wb, wire_dtype=wd)
    for omode in offset_forms(wb):
        got = wp.encode_rows_cuda(x, rows, k_b, wb=wb, wire_dtype=wd,
                                  omode=omode)
        torch.cuda.synchronize()
        encoded_same(wp, got, want, omode, wb, f"rows {rows}, {label} "
                     f"L={x.shape[1]} wb={wb} k_b={k_b} {wd}")
    return len(offset_forms(wb))


def mix_means(gen, C, L):
    """(C, L) f32 on the card with zeros of both signs and tied
    magnitudes (tests/test_torch_wire_decode.py:cluster_means)."""
    x = torch.randn((C, L), generator=gen, device="cuda")
    x[:, ::7] = -0.0
    x[:, 3::11] = 0.0
    x[:, 5::13] = torch.sign(x[:, 5::13]) * 0.75
    return x


def mix_steps(col, wp, means, case, wd):
    """(steps, layout, wb) of one chunk's gossip of ``means``, the plans
    encoded on the card as the gossip encodes them."""
    hkind, C, wbk, L, levels, dense = case
    wb = col.wf.wire_block_of(L, wbk)
    plans = col._wire_plans(levels, L, wbk, wd,
                            torch.empty((), dtype=dense).element_size())
    layout = col._gossip_layout(hkind, C, 0.4, 0, tuple(plans))
    steps = []
    for o, coef in layout.bands:
        for key, rows, senders in layout.plans:
            if key[0] == "dense":
                sub = means if rows is None else means[list(rows)]
                payload, k_b = (sub.to(dense).contiguous(),), None
            else:
                payload, k_b = tuple(col._encode(means, rows, key[1], wb,
                                                 wd)), key[1]
            steps.append(wp.MixStep(o, tuple(coef), payload, k_b, senders))
    return steps, layout, wb


def decode_mix_check(wp, y, steps, wb, wd, diag, label):
    """The decode-and-mix kernel against ``decode_mix_plain`` on the card,
    bit for bit (-0 and +0 apart), and its launches a call."""
    before = wp.LAUNCHES["wire_decode_mix"]
    got = wp.decode_mix_cuda(y, steps, wb=wb, wire_dtype=wd, diag=diag)
    torch.cuda.synchronize()
    launches = wp.LAUNCHES["wire_decode_mix"] - before
    want = wp.decode_mix_plain(y, steps, wb=wb, wire_dtype=wd, diag=diag)
    if not torch.equal(_bits(got), _bits(want)):
        bad = int((_bits(got) != _bits(want)).sum())
        fail(f"decode-and-mix kernel differs from its plain version in "
             f"{bad} entries ({label} {wd}, {len(steps)} steps, diag "
             f"{diag is not None}): max |diff| "
             f"{float((got - want).abs().max())}")
    if launches != max(1, -(-len(steps) // wp.MIX_STEPS)) * -(
            -y.shape[0] // wp.MIX_ROWS):
        fail(f"decode-and-mix: {launches} launches for {len(steps)} steps")
    return launches


def payload_bytes(steps):
    """Bytes of the distinct payloads of ``steps``, each read once."""
    seen = {}
    for st in steps:
        for t in st.payload:
            if t is not None:
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def decode_mix_main(wp, col, means):
    """Phase 10's main chunk: the gossip of C = 2 cluster means of a w_in
    column chunk over a ring at levels GOSSIP_LEVELS (k_b 103 and 615,
    one sender row a plan): the decode-and-mix timed against its plain
    version and against the chain it replaced (the same ops with the p4
    unpack kernel), and the encode of each plan's sender row."""
    case = ("ring", 2, 1024, means.shape[1], GOSSIP_LEVELS, torch.bfloat16)
    steps, layout, wb = mix_steps(col, wp, means, case, "int4")
    decode_mix_check(wp, means, steps, wb, "int4", layout.diag,
                     "main chunk")
    kern = lambda: wp.decode_mix_cuda(means, steps, wb=wb, wire_dtype="int4",
                                      diag=layout.diag)
    plain = lambda: wp.decode_mix_plain(means, steps, wb=wb,
                                        wire_dtype="int4", diag=layout.diag)
    chain = lambda: wp.decode_mix_plain(
        means, steps, wb=wb, wire_dtype="int4", diag=layout.diag,
        unpack=lambda p, wb, k_b, mode: wp.unpack_offsets_cuda(p, wb=wb,
                                                               k_b=k_b))
    nbytes = 2 * means.numel() * 4 + payload_bytes(steps)
    bound_ms, bound_by = bound(0, nbytes, torch.float32)
    k_bs = [key[1] for key, _, _ in layout.plans]
    row = dict(kernel="wire_decode_mix", case=f"main chunk: C=2 ring, Lc "
               f"{means.shape[1]}, int4, k_b {k_bs}, one sender a plan",
               steps=len(steps), bytes=nbytes, ms=time_ms(kern),
               call_ms=time_ms(kern, host_paced=True),
               plain_ms=time_ms(plain, iters=3, warmup=1),
               old_chain_ms=time_ms(chain, iters=3, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               max_abs_err=0.0, launches_per_call=1,
               kernel_split_us=kernel_split(kern))
    print("wire " + json.dumps(row))
    for (key, rows, _), lvl in zip(layout.plans, GOSSIP_LEVELS):
        k_b = key[1]
        encode_rows_check(wp, means, rows, k_b, "int4", wb, "main chunk")
        enc = lambda: wp.encode_rows_cuda(means, rows, k_b, wb=wb,
                                          wire_dtype="int4", omode="p4")
        nb = -(-means.shape[1] // wb)
        eb = means.shape[1] * 4 * len(rows) + len(rows) * nb * (
            -(-k_b // 2) + sum(wp._p4_sizes(wb, k_b)) + 4)
        b_ms, b_by = bound(0, eb, torch.float32)
        print("wire " + json.dumps(dict(
            kernel="wire_encode", case=f"main chunk row {rows}, level "
            f"{lvl}, k_b {k_b}, read in place, p4 offsets",
            route=wp.encode_route(wb), ms=time_ms(enc), bound_ms=b_ms,
            bound_by=b_by, kernel_split_us=kernel_split(enc))))
    return row


def aten_kernel_ops(fn):
    """The PyTorch operators one call of ``fn`` runs that launch a device
    kernel (all but views and allocations), by name, in order.  Torch's
    dispatcher sees every operator; torch.profiler has dropped device
    events late in a run of this script (a chunk's 5 launches seen as 2),
    so launches are counted here and by the wrappers' counters."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    no_kernel = (aten.empty, aten.empty_like, aten.empty_strided)
    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or func.overloadpacket in no_kernel):
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops


def gossip_chunk(wp, col, means, cols):
    """One column chunk of the gossip through ``sparse_exchange_`` on the
    card (R = 4 bf16 rows, 2 clusters, levels GOSSIP_LEVELS, int4): bit
    for bit its plain route; no host synchronisation inside it
    (``torch.cuda.set_sync_debug_mode("error")``); GOSSIP_CHUNK_LAUNCHES
    device launches (the wire kernels' counters and the PyTorch operators
    that launch a kernel); its card time, its host-paced time and its
    launches by kernel as torch.profiler sees them (not gated)."""
    C, Dev = 2, 2
    x = means.repeat_interleave(Dev, dim=0).to(torch.bfloat16)
    kw = dict(clusters=C, dev=Dev, hkind="ring", wire_dtype="int4",
              wire_block=1024, cluster_theta=GOSSIP_LEVELS,
              chunk_cols=cols)
    want = x.clone()
    col.sparse_exchange_(want, impl="plain", **kw)
    got = x.clone()
    col.sparse_exchange_(got, **kw)
    torch.cuda.synchronize()
    if not torch.equal(_bits(got), _bits(want)):
        fail("a gossip chunk on the card differs from its plain route")
    checked = x.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        col.sparse_exchange_(checked, **kw)
    except RuntimeError as e:
        fail(f"a gossip chunk synchronised the host with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(_bits(checked), _bits(got)):
        fail("a gossip chunk under the sync check gave another result")
    counted = x.clone()
    wp.reset_launches()
    ops = aten_kernel_ops(lambda: col.sparse_exchange_(counted, **kw))
    launches = dict(wp.LAUNCHES)
    scratch = x.clone()
    run = lambda: col.sparse_exchange_(scratch, **kw)
    names = {k: n for k, (n, _) in kernel_profile(run).items()}
    row = dict(case=f"one chunk: sparse_exchange_ on (4, {x.shape[1]}) "
               f"bf16, C=2 ring, int4 levels {GOSSIP_LEVELS}",
               ms=time_ms(run), call_ms=time_ms(run, host_paced=True),
               device_launches=sum(launches.values()) + len(ops),
               wire_launches=launches, torch_kernel_ops=ops,
               profiler_launches_by_kernel=names, host_syncs=0)
    print("gossip_chunk " + json.dumps(row))
    want_wire = {"wire_encode": 2, "wire_pack": 0, "wire_unpack": 0,
                 "wire_decode_mix": 1}
    if (launches != want_wire
            or row["device_launches"] != GOSSIP_CHUNK_LAUNCHES):
        fail(f"a gossip chunk ran {row['device_launches']} device "
             f"launches (wire {launches}, PyTorch {ops}), expected "
             f"{GOSSIP_CHUNK_LAUNCHES} (wire {want_wire})")
    return row


def w_in_chunk(configs, mamba2, cols, wb=1024):
    """The main path's inputs: a column chunk of mamba2-1.3B's w_in (bf16
    weights, so many exactly tied magnitudes), one sender row in f32 as
    (1, cols / wb, wb) wire blocks, and the (2, cols) f32 cluster means of
    a C = 2 gossip chunk."""
    cfg = configs.get_config("mamba2_1p3b").model
    din, _, _, heads, conv_ch = mamba2._dims(cfg)
    per_layer = cfg.d_model * (din + conv_ch + heads)
    cfg = cfg.replace(num_layers=-(-2 * cols // per_layer))
    w_in = mamba2.init(cfg, seed=12, device="cuda")["layers"]["w_in"]
    flat = w_in.reshape(-1)
    xb = flat[:cols].float().reshape(1, -1, wb).contiguous()
    means = flat[:2 * cols].float().reshape(2, cols)
    return xb, means


def wire_phase(wp, configs, mamba2, cols):
    """Phase 10 at the gossip's column chunk of ``cols`` columns.  Returns
    {kernel: row}: the encode (p4 offsets, the gossip's form), pack and
    unpack at WIRE_MAIN_LEVEL on w_in, the decode-and-mix at the main
    chunk."""
    from repro_torch.dist import collectives as col
    from repro_torch.kernels import build
    # {kernel: (registers, spill bytes, stack, static smem, instances)}
    ptx = {k: dict(zip(("registers", "spill_store_bytes", "stack_bytes",
                        "static_smem_bytes", "instantiations"), v))
           for k, v in ptxas_summary(build.build_log).items()}
    gen = torch.Generator(device="cuda").manual_seed(10)
    n = 0
    for wb in WIRE_BLOCKS:
        ks = sorted({k for k in (1, 2, 7, wb // 10, wb // 2 - 1, wb - 1, wb)
                     if 1 <= k <= wb})
        for k_b in ks:
            xb = wire_blocks(gen, 2, 6, wb, k_b)
            for wd in WIRE_DTYPES:
                wire_check(wp, xb, k_b, wd, "grid", zero_payload=True)
                n += 1
        print(f"wire encode wb={wb}: the {wp.encode_route(wb)} kernel, "
              f"k_b {ks}, {len(ks) * len(WIRE_DTYPES)} cases")
    # rows read in place: row subsets of a strided (4, L) view, the last
    # block ragged, and wb = L < 32 (a leaf shorter than its wire block)
    nrows = 0
    for wb, L in [(wb, 3 * wb + wb // 2 + 1) for wb in WIRE_BLOCKS] + [
            (20, 20), (31, 31)]:
        x = mix_means(gen, 8, L).view(4, 2, L)[:, 0]
        for rows in (None, (1, 3), (2,)):
            for k_b in sorted({1, max(1, wb // 10), wb}):
                for wd in WIRE_DTYPES:
                    nrows += encode_rows_check(wp, x, rows, k_b, wd, wb,
                                               "rows")
    n_p4 = p4_grid(wp, gen)
    print(f"wire encode of rows in place: {nrows} cases (wb "
          f"{list(WIRE_BLOCKS) + [20, 31]}, ragged rows, row subsets, "
          f"row stride 2L), each on the kernel encode_route names")
    # the decode-and-mix against its plain version
    nmix = 0
    for case in MIX_CASES:
        for wd in WIRE_DTYPES:
            means = mix_means(gen, case[1], case[3])
            steps, layout, wb = mix_steps(col, wp, means, case, wd)
            for diag in (layout.diag, None):
                decode_mix_check(wp, means, steps, wb, wd, diag,
                                 f"{case[0]} C={case[1]} wb={case[2]}")
                nmix += 1
            decode_mix_check(wp, torch.full_like(means, -0.0), steps, wb,
                             wd, None, f"{case[0]} y=-0")
            nmix += 1
        print(f"wire decode-and-mix {case[0]} C={case[1]} wb={case[2]} "
              f"L={case[3]}: {len(steps)} steps, "
              f"{-(-len(steps) // wp.MIX_STEPS)} launches a call, bit for "
              f"bit in every dtype")
    wb = 1024
    xb, means = w_in_chunk(configs, mamba2, cols, wb)
    rows = {}
    for theta in WIRE_LEVELS:
        k_b = max(1, min(wb, int(np.ceil(theta * wb))))
        packed, off = wire_check(wp, xb, k_b, "int4", f"w_in theta={theta}",
                                 zero_payload=True)
        n += 1
        nb = xb.shape[1]
        lo_b, bm_b = wp._p4_sizes(wb, k_b)
        nbytes = lo_b + bm_b
        vals_b = -(-k_b // 2)

        def encode_plain():
            vals, o, scale = wp.encode_blocks_plain(xb, k_b,
                                                    wire_dtype="int4")
            return vals, wp.pack_offsets_plain(o, wb=wb, mode="p4"), scale

        works = {  # (bytes read once + written once, launch, plain)
            "wire_encode": (  # p4 offsets: the gossip's encode
                xb.numel() * 4 + nb * (vals_b + nbytes + 4),
                lambda: wp.encode_blocks_cuda(xb, k_b, wire_dtype="int4",
                                              omode="p4"),
                encode_plain),
            "wire_pack": (
                nb * (4 * k_b + nbytes),
                lambda: wp.pack_offsets_cuda(off, wb=wb),
                lambda: wp.pack_offsets_plain(off, wb=wb, mode="p4")),
            "wire_unpack": (  # the sender row and a zero payload
                2 * nb * (nbytes + 4 * k_b),
                lambda: wp.unpack_offsets_cuda(packed, wb=wb, k_b=k_b),
                lambda: wp.unpack_offsets_plain(packed, wb=wb, k_b=k_b,
                                                mode="p4"))}
        blocks_route = {  # the CTA-per-block kernels at the same shape
            "wire_pack": lambda: wp.pack_offsets_cuda(off, wb=wb,
                                                      _force_block=True),
            "wire_unpack": lambda: wp.unpack_offsets_cuda(
                packed, wb=wb, k_b=k_b, _force_block=True)}
        for name, (nbytes_io, kern, plain) in works.items():
            bound_ms, bound_by = bound(0, nbytes_io, torch.float32)
            row = dict(kernel=name, case=f"w_in chunk (1, {nb}, {wb}) f32, "
                       f"int4, theta {theta}", k_b=k_b, bytes=nbytes_io,
                       ms=time_ms(kern),
                       plain_ms=time_ms(plain, iters=3, warmup=1),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None, max_abs_err=0.0)
            if name in blocks_route:
                warp_kernel = ("pack" if name == "wire_pack" else
                               "unpack") + "_p4_warp_kernel"
                row.update(route=wp.encode_route(wb),
                           block_route_ms=time_ms(blocks_route[name]),
                           ptxas=ptx.get(warp_kernel))
            if name == "wire_encode":
                # the encode as the gossip ran it before the fused pack:
                # int32 offsets, then the pack kernel
                i32 = lambda: wp.encode_blocks_cuda(xb, k_b,
                                                    wire_dtype="int4")
                row.update(
                    offsets="p4", route=wp.encode_route(wb),
                    i32_ms=time_ms(i32),
                    i32_then_pack_ms=time_ms(
                        lambda: wp.pack_offsets_cuda(i32()[1], wb=wb)),
                    i32_bound_ms=bound(0, xb.numel() * 4 + nb * (
                        vals_b + 4 * k_b + 4), torch.float32)[0])
            if theta == WIRE_MAIN_LEVEL:
                row["kernel_split_us"] = kernel_split(kern)
                rows[name] = row
            print("wire " + json.dumps(row))
        if theta == WIRE_MAIN_LEVEL:
            p4_wide_case(wp, gen, packed[0], wb, k_b)
    rows["wire_decode_mix"] = decode_mix_main(wp, col, means)
    gossip_chunk(wp, col, means, cols)
    print(f"wire: {n} cases of the encode (in every offset form), p4 pack "
          f"and p4 unpack (zero payloads), {n_p4} of the p4 pack and unpack "
          f"on both routes, {nrows} of the encode of rows in place and "
          f"{nmix + 1} of the decode-and-mix bit for bit equal to the plain "
          f"versions")
    del xb, means
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 11 and 12: the fused round step with the sparse gossip wire
# ---------------------------------------------------------------------------

def sparse_setup(configs, base, compression, policies, full):
    """(cfg, hcef, topo, policy, quantized theta, cluster levels) of the
    fused round with the int4 wire."""
    import dataclasses
    bundle = configs.get_config("mamba2_1p3b")
    cfg = bundle.model if full else configs.smoke_model(bundle.model)
    hcef = dataclasses.replace(bundle.hcef, q=SPARSE_Q, sparse_gossip=True,
                               wire_dtype="int4", wire_ef=not full)
    if not full:
        hcef = dataclasses.replace(hcef, tau=2, eta=0.1)
    topo = base.FLTopology(2, 2)
    cluster_of = np.repeat(np.arange(2), 2)
    theta = compression.quantize_theta(SPARSE_THETA, hcef.theta_levels)
    levels = compression.cluster_levels_from_theta(
        SPARSE_THETA, hcef.theta_levels, cluster_of)
    if levels != (0.1, 0.6):
        fail(f"cluster levels {levels}, expected (0.1, 0.6)")
    return (cfg, hcef, topo, policies.make_train_policy(topo), theta,
            levels)


def _sparse_rounds(cfg, hcef, topo, policy, theta, levels, rnd_mod, params0,
                   tokens, lockstep):
    """SPARSE_ROUNDS fused rounds on the CPU and the card; with
    ``lockstep`` each round starts both from the card's state.  Yields
    (round, {device: metrics}, {device: params and estimates on the
    CPU})."""
    from repro_torch.tree import flatten, tree_map
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    states = {d: rnd_mod.init_state(cfg, hcef, topo, params0, device=d)
              for d in ("cpu", "cuda")}
    for r in range(SPARSE_ROUNDS):
        if lockstep:
            c = states["cuda"]
            cpu = lambda t: None if t is None else tree_map(
                lambda x: x.cpu().clone(), t)
            states["cpu"] = c._replace(
                params=cpu(c.params), momentum=cpu(c.momentum),
                ef=cpu(c.ef), wire_ef=cpu(c.wire_ef))
        step = rnd_mod.make_round_step(
            cfg, hcef, topo, policy, gossip=(r + 1) % SPARSE_Q == 0,
            cluster_levels=levels if r == 1 else None)
        mets, leaves = {}, {}
        for d in ("cpu", "cuda"):
            states[d], m = step(states[d], {"tokens": tokens[r]}, rho, theta,
                                11 + r)
            mets[d] = {k: v.cpu().numpy() for k, v in m.items()}
            lv = dict(flatten(states[d].params))
            for f in ("est_self", "est_wsum"):
                lv.update({f + "/" + k: v for k, v in
                           flatten(states[d].wire_ef[f]).items()})
            leaves[d] = {k: v.cpu() for k, v in lv.items()}
        yield r, mets, leaves


def small_sparse_round_agrees(configs, mamba2, rnd_mod, base, compression,
                              policies):
    """Phase 11: SPARSE_ROUNDS rounds of the smoke mamba2's fused round
    (int4 wire, levels (0.1, 0.6) in round 2 and the traced-theta
    fallback in round 4, wire EF) on the card and on the CPU, from the
    same parameters, tokens, controls and bits, twice:
    - eta = 0, each side on its own: Q sees zero deltas, so both wires get
      the same bits and everything (losses, statistics, parameters,
      estimates) must agree within ROUND_RTOL / ROUND_ATOL;
    - eta = 0.1 in lockstep (each round starts both sides from the card's
      state): losses and statistics within ROUND_RTOL; parameters and
      estimates within ROUND_ATOL except at most Q_FLIP_SHARE of the
      entries.  A delta entry at a block's top-k threshold can be kept on
      one side and left in the EF on the other (ROADMAP.md section 3),
      and the wire then carries it from that side only; without lockstep
      such a flip spreads through the next rounds' training."""
    import dataclasses
    from repro_torch.kernels import wire_pack as wp
    cfg, hcef, topo, policy, theta, levels = sparse_setup(
        configs, base, compression, policies, full=False)
    params0 = mamba2.init(cfg, torch.Generator().manual_seed(11),
                          device="cpu")
    wp.reset_launches()
    rng = np.random.default_rng(11)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (16, 40)))
              for _ in range(SPARSE_ROUNDS)]
    for eta, lockstep in ((0.0, False), (hcef.eta, True)):
        h = dataclasses.replace(hcef, eta=eta)
        worst, perr, flips, moved = 0.0, 0.0, 0, 0.0
        for r, mets, leaves in _sparse_rounds(cfg, h, topo, policy, theta,
                                              levels, rnd_mod, params0,
                                              tokens, lockstep):
            a, b = mets["cuda"], mets["cpu"]
            for k in ("loss", "g2", "sigma2"):
                worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                                / np.abs(b[k]))))
            if a.get("theta_wire") != b.get("theta_wire"):
                fail(f"theta_wire {a.get('theta_wire')} on the card, "
                     f"{b.get('theta_wire')} on the CPU")
            dev = {k: (leaves["cuda"][k] - v).abs()
                   for k, v in leaves["cpu"].items()}
            perr = max(perr, max(float(v.max()) for v in dev.values()))
            n = sum(int((v > ROUND_ATOL).sum()) for v in dev.values())
            total = sum(v.numel() for v in dev.values())
            flips = max(flips, n)
            moved = max(moved, max(float(v.abs().max()) for k, v in
                                   leaves["cpu"].items()
                                   if k.startswith("est_")))
        allowed = 0 if not lockstep else int(Q_FLIP_SHARE * total)
        print(f"mamba2 small sparse round (eta {eta}, lockstep "
              f"{lockstep}): card vs CPU over {SPARSE_ROUNDS} rounds (int4 "
              f"wire, levels {levels}, wire EF), largest relative deviation "
              f"of loss/g2/sigma2 {worst:.3e} (tolerance {ROUND_RTOL}), "
              f"largest parameter or estimate deviation {perr:.3e}, "
              f"entries above {ROUND_ATOL} in a round: at most {flips} of "
              f"{total} (allowed {allowed}); estimates moved {moved:.3e}")
        if not (worst <= ROUND_RTOL and flips <= allowed and moved > 0):
            fail("the fused round on the card disagrees with the CPU")
    # the wire-EF path: each cluster's own payload and the neighbours'
    # are decoded in the decode-and-mix kernel; the encode packs the
    # offsets itself
    launches = dict(wp.LAUNCHES)
    print(f"mamba2 small sparse round: wire launches on the card {launches}")
    if (launches["wire_pack"] or launches["wire_unpack"]
            or not launches["wire_encode"]
            or not launches["wire_decode_mix"]):
        fail(f"on the wire-EF path the encode and the decode-and-mix must "
             f"run and the standalone pack and unpack must not: {launches}")
    return launches


def predicted_wire_launches(cfg_params, levels, wire_block, wf, cols, bands,
                            clusters, mix_steps, mix_rows, wire_ef=False):
    """Launches of each wire kernel in one gossip round: per leaf and per
    wire plan (a level whose int4 encoding stays below the bf16 row), one
    encode a column chunk of ``cols`` (it writes the packed offsets: no
    standalone pack); a chunk's decode-and-mix per ``mix_steps`` steps (a
    step is a band of H and a plan, the dense plans included) and
    ``mix_rows`` clusters; no standalone unpack.  With ``wire_ef`` the
    estimates take two decode-and-mix calls a chunk: a step a plan (two
    with one plan), and those steps before the bands' steps."""
    want = {"wire_encode": 0, "wire_pack": 0, "wire_unpack": 0,
            "wire_decode_mix": 0}
    for L in cfg_params:
        wb = wf.wire_block_of(L, wire_block)
        chunks = -(-L // max(wb, cols // wb * wb))
        keys = set()
        for k_b in sorted({wf.wire_k(t, L, wire_block) for t in levels}):
            if wf.encoding_reaches_dense(k_b, L, wire_block, "int4", 2):
                keys.add("dense")
                continue
            keys.add(k_b)
            want["wire_encode"] += chunks
        launches = lambda steps: max(1, -(-steps // mix_steps)) * -(
            -clusters // mix_rows)
        own = len(keys) + (len(keys) == 1)
        want["wire_decode_mix"] += chunks * (
            launches(own) + launches(own + bands * len(keys)) if wire_ef
            else launches(bands * len(keys)))
    return want


def mamba2_sparse_full(configs, mamba2, rnd_mod, base, compression,
                       policies, wf, train, synthetic, wp, ss, tk):
    """Phase 12: ``make_round_step(..., policy=...)`` on mamba2-1.3B at
    full width, driven as the launcher drives its rounds; every launch
    counted and checked against the leaves' and chunks' prediction."""
    from repro_torch.tree import flatten
    cfg, hcef, topo, policy, theta, levels = sparse_setup(
        configs, base, compression, policies, full=True)
    R = topo.num_devices
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params0 = mamba2.init(cfg, gen, device="cuda")
    state = rnd_mod.init_state(cfg, hcef, topo, params0, device="cuda")
    del params0
    torch.cuda.synchronize()
    sizes = [v[0].numel() for v in flatten(state.params).values()]
    print(f"mamba2 sparse full width: {cfg.num_layers} layers, "
          f"{sum(sizes)} params in {len(sizes)} leaves, R={R}, int4 wire, "
          f"theta {SPARSE_THETA} -> levels {levels}, set up in "
          f"{time.perf_counter() - t0:.1f} s")
    steps = {g: rnd_mod.make_round_step(
        cfg, hcef, topo, policy, gossip=g, cluster_levels=levels if g
        else None) for g in (False, True)}
    corpus = synthetic.synthetic_tokens(cfg.vocab_size, n_seq=train.N_SEQ,
                                        seq_len=512, n_devices=R, beta=0.5)
    rng = np.random.default_rng(0)
    b_per_dev = hcef.tau * 2
    rho = np.ones(R)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wp.reset_launches()
    ss.reset_launches()
    tk.reset_launches()
    hist, walls, timings = [], [], {}
    for rnd in range(SPARSE_ROUNDS):
        gossip = (rnd + 1) % SPARSE_Q == 0
        idx = rng.integers(0, train.N_SEQ, (R, b_per_dev))
        tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
        t0 = time.perf_counter()
        state, m = steps[gossip](state, {"tokens": torch.from_numpy(tokens)},
                                 rho, theta, 1000 + rnd, timings=timings)
        loss = float(m["loss"].mean())
        walls.append((time.perf_counter() - t0) * 1e3)
        hist.append(dict(loss=loss, gossip=gossip, theta_wire=(
            float(m["theta_wire"]) if "theta_wire" in m else None)))
        print(f"round {rnd} loss={loss:.4f} gossip={gossip} "
              f"wall={walls[-1]:.0f}ms", flush=True)
    torch.cuda.synchronize()
    launches = dict(wp.LAUNCHES, **ss.LAUNCHES, **tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_gossip = sum(h["gossip"] for h in hist)
    per_round = predicted_wire_launches(
        sizes, levels, hcef.wire_block, wf, rnd_mod.gossip_cols(
            topo.clusters), bands=1,  # C = 2 ring
        clusters=topo.clusters, mix_steps=wp.MIX_STEPS,
        mix_rows=wp.MIX_ROWS)
    steps_run = SPARSE_ROUNDS * R * hcef.tau
    want = {k: v * n_gossip for k, v in per_round.items()}
    want.update(ssd_scan_fwd=steps_run * cfg.num_layers * (2 if cfg.remat
                                                            else 1),
                ssd_scan_bwd=steps_run * cfg.num_layers,
                topk_compress=SPARSE_ROUNDS * topk_launches(
                    list(flatten(state.params).values()),
                    list(flatten(state.ef).values()), tk))
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if n_gossip != 2 or any(h["theta_wire"] != (np.float32(0.6) if
                                                h["gossip"] else None)
                            for h in hist):
        fail(f"theta_wire {[h['theta_wire'] for h in hist]}, expected 0.6 "
             f"in rounds 2 and 4 only")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    if not peak <= PEAK_LIMIT_GB:
        fail(f"peak device memory {peak:.2f} GB above {PEAK_LIMIT_GB} GB")
    med = lambda v: float(np.percentile(v, 50))
    stats = dict(rounds=SPARSE_ROUNDS, gossip_rounds=n_gossip,
                 layers=cfg.num_layers, params=sum(sizes), levels=levels,
                 round_wall_ms_p50=med(walls), round_wall_ms=walls,
                 phase_ms_p50={k: med(v) for k, v in timings.items()},
                 phase_ms=timings,
                 wire_launches_per_gossip_round=per_round,
                 launches=launches, loss=[h["loss"] for h in hist],
                 peak_mem_gb=peak)
    print("mamba2_sparse " + json.dumps(stats))
    del state, steps
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 13: the gossip with the wire EF at full width
# ---------------------------------------------------------------------------

def wire_ef_full(gb, col, wp, rnd_mod, wf):
    """Phase 13: EF_ROUNDS gossip rounds with the CHOCO wire EF over
    mamba2-1.3B's leaves (``tools/gossip_bench.py``'s), every leaf's
    estimates (R, L) f32 from zero.  Gates: the first w_in chunk of the
    last round bit for bit ``_sparse_mix_rows(..., impl="plain")`` from
    the same inputs; finite leaves and estimates; the estimates moved;
    the wire launches as the leaves predict (two decode-and-mix calls a
    chunk, no standalone pack or unpack); peak <= PEAK_LIMIT_GB."""
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    leaves = gb.make_leaves()
    est = gb.zero_estimates(leaves)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    C, Dev, R = gb.C, gb.DEV, gb.C * gb.DEV
    cols = rnd_mod.gossip_cols(C)
    kw = gb.exchange_kw(cols)
    sizes = [x.shape[1] for x in leaves.values()]
    chunks = sum(len(col._col_chunks(L, wf.wire_block_of(L, 1024), cols))
                 for L in sizes)
    want_launches = predicted_wire_launches(
        sizes, gb.LEVELS, 1024, wf, cols, bands=1, clusters=C,
        mix_steps=wp.MIX_STEPS, mix_rows=wp.MIX_ROWS, wire_ef=True)
    est_gb = sum(e.numel() * e.element_size() for p in est.values()
                 for e in p) / 1e9
    print(f"mamba2 wire-EF gossip at full width: {len(leaves)} leaves, "
          f"{sum(sizes)} params, R={R} in {C} clusters, int4 levels "
          f"{gb.LEVELS}, estimates {est_gb:.2f} GB, chunks of {cols} "
          f"columns ({chunks} a round), set up in {setup_s:.1f} s")
    name = "layers/w_in"
    x = leaves[name]
    L = x.shape[1]
    wb = wf.wire_block_of(L, 1024)
    c1 = col._col_chunks(L, wb, cols)[0][1]
    plans = col._level_plans(L, x.element_size(), C, k=None, theta=None,
                             cluster_theta=gb.LEVELS, wire_block=1024,
                             wire_dtype="int4")
    layout = col._gossip_layout("ring", C, 0.4, 0, tuple(plans))
    walls, peaks, launches, want = [], [], [], None
    for r in range(EF_ROUNDS):
        if r == EF_ROUNDS - 1:  # the check's inputs, before the round
            rows = lambda t: t.view(C, Dev, L)[:, 0, :c1]
            want = col._sparse_mix_rows(
                rows(x).float(), layout, wb=wb, wire_dtype="int4",
                dense_dtype=x.dtype,
                wire_ef=tuple(rows(e).clone() for e in est[name]),
                impl="plain")
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wp.reset_launches()
        t0 = time.perf_counter()
        gb.gossip_round(leaves, cols, est)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        launches.append(dict(wp.LAUNCHES))
        print(f"wire-EF gossip round {r}: {walls[-1]:.1f} ms, wire launches "
              f"{launches[-1]}", flush=True)
    xv = x.view(C, Dev, L)[:, :, :c1]
    got = (xv, *(e.view(C, Dev, L)[:, :, :c1] for e in est[name]))
    for what, g, w in zip(("rows", "est_self", "est_wsum"), got, want):
        w = w.to(g.dtype)[:, None].expand_as(g)
        if not torch.equal(_bits(g), _bits(w)):
            fail(f"wire-EF gossip: the first {name} chunk's {what} differ "
                 f"from _sparse_mix_rows(impl='plain') in "
                 f"{int((_bits(g) != _bits(w)).sum())} entries")
    # checks by column slices: a whole leaf's temporaries would not fit
    slices = lambda t: (t[:, c:c + (1 << 24)] for c in range(0, t.shape[1],
                                                            1 << 24))
    finite = all(bool(torch.isfinite(sl).all()) for k in leaves
                 for t in (leaves[k], *est[k]) for sl in slices(t))
    moved = max(float(sl.abs().max()) for k in est
                for sl in slices(est[k][0]))
    peak = max(peaks)
    stats = dict(rounds=EF_ROUNDS, leaves=len(leaves), params=sum(sizes),
                 cols=cols, chunks_per_round=chunks, levels=gb.LEVELS,
                 estimates_gb=est_gb, round_ms=walls,
                 wire_launches=launches,
                 predicted_launches_per_round=want_launches,
                 decode_mix_launches_per_round=[
                     m["wire_decode_mix"] for m in launches],
                 peak_mem_gb=peak, est_self_max=moved, finite=finite,
                 first_w_in_chunk_columns=c1, setup_s=setup_s,
                 allocated_before_gb=before_gb)
    print("mamba2_wire_ef " + json.dumps(stats))
    if not finite:
        fail("wire-EF gossip: non-finite leaves or estimates")
    if not moved > 0:
        fail("wire-EF gossip: the estimates did not move")
    if any(m != want_launches for m in launches):
        fail(f"wire-EF gossip launches {launches}, expected "
             f"{want_launches} a round ({chunks} chunks)")
    if want_launches["wire_decode_mix"] != 2 * chunks:
        fail(f"wire-EF gossip: {want_launches['wire_decode_mix']} "
             f"decode-and-mix launches for {chunks} chunks, not two a chunk")
    if not peak <= PEAK_LIMIT_GB:
        fail(f"wire-EF gossip: peak device memory {peak:.2f} GB above "
             f"{PEAK_LIMIT_GB} GB")
    x_chunk = x[:, :c1].clone()
    est_chunk = tuple(e[:, :c1].clone() for e in est[name])
    del leaves, est, x, xv, got, want
    torch.cuda.empty_cache()
    wire_ef_chunk(col, wp, gb, x_chunk, est_chunk, cols)
    return launches[-1]


def wire_ef_chunk(col, wp, gb, x, est, cols):
    """One wire-EF gossip chunk (phase 13's first w_in chunk after its
    rounds: (R, Lc) bf16 rows and their two (R, Lc) f32 estimates, one
    chunk of ``cols``) through ``sparse_exchange_`` on the card: its card
    time (L2 flushed) beside the same chunk's without the EF in the same
    call, its host-paced time, its device launches (the wire kernels'
    counters and the PyTorch operators that launch a kernel) and each
    kernel's device time (torch.profiler, warm L2).  Gated: one chunk's
    wire launches (two encodes, two decode-and-mix, no pack or unpack)."""
    kw = gb.exchange_kw(cols)
    run = lambda: col.sparse_exchange_(x, wire_ef=est, **kw)
    no_ef = x.clone()
    run()
    torch.cuda.synchronize()
    wp.reset_launches()
    ops = aten_kernel_ops(run)
    launches = dict(wp.LAUNCHES)
    prof = kernel_profile(run)
    row = dict(case=f"one wire-EF chunk: sparse_exchange_ on "
               f"{tuple(x.shape)} bf16 and two f32 estimates, C={gb.C} "
               f"ring, int4 levels {gb.LEVELS}",
               ms=time_ms(run), call_ms=time_ms(run, host_paced=True),
               no_ef_ms=time_ms(lambda: col.sparse_exchange_(no_ef, **kw)),
               device_launches=sum(launches.values()) + len(ops),
               wire_launches=launches, torch_kernel_ops=ops,
               profiler_launches_by_kernel={k: n for k, (n, _) in
                                            prof.items()},
               kernel_split_us={k: us for k, (_, us) in prof.items()},
               profiled_us=sum(us for _, us in prof.values()))
    print("wire_ef_chunk " + json.dumps(row))
    want = {"wire_encode": 2, "wire_pack": 0, "wire_unpack": 0,
            "wire_decode_mix": 2}
    if launches != want:
        fail(f"a wire-EF chunk ran wire launches {launches}, expected "
             f"{want}")
    del x, est, no_ef
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 14: the attention backward kernel
# ---------------------------------------------------------------------------

# (B, S, H, KH, Dh, dtype, causal, window): G 1, 2 and 3, causal and not, a
# window, ragged S (65, 1000, 130), Dh 16, 32, 64, 128 and 256, in both
# types; bf16 Dh 128 over 16 query blocks; Dh 256 with one KV head (MQA,
# G 3 and 16) under a window, as recurrentgemma-9b's layers
BWD_CASES = [
    (1, 65, 3, 3, 16, torch.float32, True, 0),
    (2, 65, 4, 2, 64, torch.float32, False, 0),
    (1, 1000, 6, 2, 64, torch.float32, True, 96),
    (1, 130, 3, 1, 16, torch.float32, False, 16),
    (1, 200, 4, 2, 128, torch.float32, True, 0),
    (1, 65, 3, 3, 16, torch.bfloat16, True, 0),
    (2, 65, 4, 2, 64, torch.bfloat16, False, 0),
    (1, 1000, 6, 2, 64, torch.bfloat16, True, 96),
    (1, 1000, 4, 4, 16, torch.bfloat16, True, 0),
    (1, 130, 3, 1, 64, torch.bfloat16, False, 16),
    (1, 200, 4, 2, 32, torch.bfloat16, True, 0),
    (1, 200, 4, 2, 128, torch.bfloat16, True, 0),
    (1, 1024, 8, 2, 128, torch.bfloat16, True, 0),
    (1, 200, 3, 1, 256, torch.float32, True, 16),
    (1, 1000, 16, 1, 256, torch.bfloat16, True, 96),
    (2, 130, 4, 2, 256, torch.bfloat16, False, 0),
    (1, 65, 3, 3, 256, torch.bfloat16, True, 0),
]
# recurrentgemma-9b's attention layer in training (phases 2 and 14, timed):
# 16 query heads of 256 over one KV head, S 4096 under a 2048 window
GRIFFIN_LAYER = dict(B=1, S=4096, H=16, KH=1, Dh=256, window=2048)
# internvl2-2b's attention layer in training and seamless-m4t-large-v2's
# non-causal one (its encoder's and its cross-attention's shape in
# training) (phases 2 and 14, timed)
INTERNVL_LAYER = dict(B=2, S=2048, H=16, KH=8, Dh=128, causal=True)
SEAMLESS_LAYER = dict(B=2, S=2048, H=16, KH=16, Dh=64, causal=False)
# each gradient within this share of its largest entry (f32: the
# reference's 2e-5; bf16: 2e-2, the kernel rounds P and dS to bf16)
BWD_TOL_OF_MAX = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# prep, then bf16's one launch of both passes (dK/dV and dQ CTAs), or f32's
# two SIMT launches
BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_wgmma", "flash_bwd_dkdv_simt",
               "flash_bwd_dq_simt")
# the kernels that run bf16 (prep has a bf16 instantiation), and the bf16
# forward: none may spill
BWD_BF16_KERNELS = BWD_KERNELS[:2] + ("flash_fwd_tc",)


def attention_bwd_case(fa, gen, B, S, H, KH, Dh, dtype, causal, window,
                       timed=False):
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same inputs (q, k, v, dout seeded; out and lse from the forward
    kernel), twice for the same bits; at the timed shape also the plain
    version's and SDPA's backward times."""
    shape_q, shape_k = (B, S, H, Dh), (B, S, KH, Dh)
    q, dout = (torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(shape_k, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    share = BWD_TOL_OF_MAX[dtype]
    errs, of_max, ok = {}, {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        errs[name] = float((a.float() - b.float()).abs().max())
        of_max[name] = errs[name] / scale
        ok = ok and errs[name] <= share * scale
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    row = dict(B=B, S=S, H=H, KH=KH, Dh=Dh, dtype=str(dtype)[6:],
               causal=causal, window=window, max_abs_err=max(errs.values()),
               errs=errs, err_of_max=of_max, tol_of_max=share,
               deterministic=same)
    if timed:
        args = (q, k, v, out, lse, dout)
        row["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(*args, **kw))
        row["call_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_cuda(*args, **kw),
            host_paced=True)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_plain(*args, **kw), iters=3,
            warmup=1)
        if window:  # a boolean mask, K and V repeated to the heads
            call, row["library_backend"] = sdpa_yardstick(q, k, v, causal,
                                                          window)
            o, ins = call(requires_grad=True)
        else:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ins = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
            o = sdpa(*ins, is_causal=causal, enable_gqa=True)
        gt = dout.transpose(1, 2)
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            o, ins, gt, retain_graph=True))
        # which launch takes the time, prep or the passes (warm L2)
        row["split_us"] = kernel_split(
            lambda: fa.flash_attention_bwd_cuda(*args, **kw))
        pairs = B * live_pairs(S, S, causal, window, 0)
        flops = 5 * 2 * Dh * H * pairs  # S, dP, dV, dQ, dK: 5 products
        nbytes = (sum(t.numel() for t in (q, k, v, out, dout)) +
                  sum(t.numel() for t in got)) * q.element_size() + \
            lse.numel() * 4
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dtype)
        row["gflop"] = flops / 1e9
        row["mbytes"] = nbytes / 1e6
    print("attention_bwd " + json.dumps(row))
    if not ok:
        fail(f"the attention backward kernel disagrees with its plain "
             f"version: {row}")
    if not same:
        fail(f"the attention backward kernel gave other bits on a second "
             f"run: {row}")
    return row


def attention_fwd_train(fa, gen, B, S, H, KH, Dh, causal=True):
    """The training forward (``return_lse``) at a training layer (smollm-
    135M's; INTERNVL_LAYER, SEAMLESS_LAYER) against its plain version,
    timed beside SDPA's forward (K and V repeated to the query heads
    outside the timing, as phase 2) and its bound."""
    q = torch.randn((B, S, H, Dh), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    kw = dict(return_lse=True, causal=causal)
    out, lse = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    err, ok = max_err(out, ref, BF16_TOL)
    lse_err, lse_ok = max_err(lse, ref_lse, BF16_TOL)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                       iters=3, warmup=1)
    G = H // KH
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    flops = 4 * Dh * H * B * live_pairs(S, S, causal, 0, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + \
        lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes, torch.bfloat16)
    row = dict(kernel="flash_fwd_tc", B=B, S=S, H=H, KH=KH, Dh=Dh,
               dtype="bfloat16", causal=causal, max_abs_err=err,
               lse_max_abs_err=lse_err, tol=BF16_TOL["atol"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, gflop=flops / 1e9,
               mbytes=nbytes / 1e6)
    if not ok or not lse_ok:
        fail(f"the training forward disagrees with its plain version: {row}")
    return row


def attention_bwd_phase(fa, build):
    """Phase 14: every case of BWD_CASES (no bf16 attention kernel may
    spill), then smollm-135M's layer (B 2, S 2048, 9 heads, 3 KV heads, Dh
    64, bf16, causal), recurrentgemma-9b's (GRIFFIN_LAYER), internvl2-2b's
    (INTERNVL_LAYER) and seamless-m4t-large-v2's non-causal one
    (SEAMLESS_LAYER), timed: the backward's rows ({"internvl": row,
    "seamless": row} for the last two), and smollm's training forward's
    (printed after phase 16 with its launches)."""
    ptx = ptxas_summary(build.build_log)
    for name in BWD_KERNELS + BWD_BF16_KERNELS[2:]:
        regs, spills, stack, smem, n = ptx.get(name, (0, 0, 0, 0, 0))
        print(f"  ptxas: {name}: up to {regs} registers, {spills} bytes of "
              f"spill stores, {stack} bytes of stack, over {n} "
              f"instantiations")
        if name in BWD_BF16_KERNELS and (n == 0 or spills):
            fail(f"ptxas: {name}: {spills} bytes of spill stores over {n} "
                 f"instantiations (expected a build and no spill)")
    gen = torch.Generator(device="cuda").manual_seed(14)
    for case in BWD_CASES:
        attention_bwd_case(fa, gen, *case)
    main = attention_bwd_case(fa, gen, 2, 2048, 9, 3, 64, torch.bfloat16,
                              True, 0, timed=True)
    g = GRIFFIN_LAYER
    griffin = attention_bwd_case(fa, gen, g["B"], g["S"], g["H"], g["KH"],
                                 g["Dh"], torch.bfloat16, True, g["window"],
                                 timed=True)
    layers = {name: attention_bwd_case(
        fa, gen, c["B"], c["S"], c["H"], c["KH"], c["Dh"], torch.bfloat16,
        c["causal"], 0, timed=True)
        for name, c in (("internvl", INTERNVL_LAYER),
                        ("seamless", SEAMLESS_LAYER))}
    return (main, griffin, attention_fwd_train(fa, gen, 2, 2048, 9, 3, 64),
            layers)


# ---------------------------------------------------------------------------
# phases 15 and 16: the HCEF round step on the dense LM
# ---------------------------------------------------------------------------

LM_ROUNDS = 4  # phase 16: q = 4, round 4 gossips


def attention_layers(cfg):
    """The attention calls that ``cfg``'s forward makes: every layer of
    the decoder LM (with an encoder, each encoder layer and each decoder
    layer's cross-attention too), griffin's groups' attention blocks."""
    if cfg.family != "hybrid":
        return cfg.num_layers * (1 + cfg.cross_attention) + cfg.enc_layers
    from repro_torch.models import griffin
    n_groups, _, _, apg, _, _ = griffin._layout(cfg)
    return n_groups * apg


def noncausal_layers(cfg):
    """The non-causal attention calls of ``cfg``'s forward: the encoder's
    self-attention and the decoder's cross-attention."""
    return cfg.enc_layers + cfg.num_layers * cfg.cross_attention


def small_lm_round_agrees(configs, lm, rnd_mod, base, fa,
                          arch="smollm_135m", lockstep=False, rounds=3,
                          num_layers=None, flip_share=0.0):
    """``rounds`` rounds (the last a gossip round) of ``arch``'s smoke
    round step (f32, 2 layers or ``num_layers``, S 65, 2 x 2, tau 4) on
    the card (the f32 attention kernels, forward and backward) and on the
    CPU (the plain version under autograd), from the same parameters,
    tokens, frontend stand-ins (``train.frontend_stand_ins``), controls
    and bits: losses, statistics and parameters within ROUND_RTOL /
    ROUND_ATOL.  With ``lockstep`` each round starts the CPU
    from the card's state, so that a routing or top-k flip does not carry
    on into the later rounds, and the parameters are compared after every
    round; with ``flip_share`` as well, at most that share of the
    parameters may sit beyond ROUND_ATOL after a round (top-k threshold
    flips: an entry at its block's threshold kept on one side and left in
    the EF on the other)."""
    from repro_torch.launch.train import frontend_stand_ins
    from repro_torch.models.registry import get_model
    from repro_torch.tree import flatten, tree_map
    cfg = configs.smoke_model(configs.get_config(arch).model)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    hcef = base.HCEFConfig(tau=4, q=3, eta=0.1)
    topo = base.FLTopology(2, 2)
    params0 = get_model(cfg).init(cfg, torch.Generator().manual_seed(5),
                                  device="cpu")
    rng = np.random.default_rng(5)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 65)))
              for _ in range(rounds)]
    stand_ins = frontend_stand_ins(cfg, 32, 65, seed=5)
    frontend = [stand_ins() for _ in range(rounds)]
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    theta = np.array([0.5, 0.25, 1.0, 0.1])
    states = {d: rnd_mod.init_state(cfg, hcef, topo, params0, device=d)
              for d in ("cpu", "cuda")}
    hist = {d: [] for d in states}
    launches = {d: {} for d in states}
    to_cpu = lambda t: None if t is None else tree_map(  # noqa: E731
        lambda x: x.to("cpu", copy=True), t)
    perr, flips, total, far = 0.0, 0, 0, ""
    for r in range(rounds):
        if lockstep and r:
            c = states["cuda"]
            states["cpu"] = c._replace(params=to_cpu(c.params),
                                       momentum=to_cpu(c.momentum),
                                       ef=to_cpu(c.ef))
        step = rnd_mod.make_round_step(cfg, hcef, topo,
                                       gossip=r == rounds - 1)
        for d in states:
            fa.reset_launches()
            states[d], m = step(states[d],
                                {"tokens": tokens[r], **frontend[r]}, rho,
                                theta, 7 + r)
            hist[d].append({k: v.cpu().numpy() for k, v in m.items()})
            for k, v in fa.LAUNCHES.items():
                launches[d][k] = launches[d].get(k, 0) + v
        if lockstep or r == rounds - 1:
            want = flatten(states["cpu"].params)
            dev = {k: (v.cpu() - want[k]).abs() for k, v in flatten(
                states["cuda"].params).items()}
            total = sum(d.numel() for d in dev.values())
            flips = max(flips, sum(int((d > ROUND_ATOL).sum())
                                   for d in dev.values()))
            k_far = max(dev, key=lambda k: float(dev[k].max()))
            if float(dev[k_far].max()) > perr:
                perr, far = float(dev[k_far].max()), k_far
    worst = 0.0
    for a, b in zip(hist["cuda"], hist["cpu"]):
        for k in ("loss", "g2", "sigma2"):
            worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                            / np.abs(b[k]))))
        if not np.array_equal(a["steps"], b["steps"]):
            fail(f"the card's {arch} round drew other masked-step bits")
    steps = (rounds * topo.num_devices * hcef.tau
             * attention_layers(cfg))  # no remat
    want = {"flash_attention": steps, "flash_attention_bwd": steps,
            "paged_decode_attention": 0}
    print(f"{arch} small round{' (lockstep)' if lockstep else ''}: card vs "
          f"CPU over {rounds} rounds ({cfg.num_layers} layers), largest "
          f"relative deviation of loss/g2/sigma2 "
          f"{worst:.3e} (tolerance {ROUND_RTOL}), largest parameter "
          f"deviation {perr:.3e} in {far} (tolerance {ROUND_ATOL}; "
          f"{flips} of {total} entries beyond it in a round, "
          f"{int(flip_share * total)} allowed); card launches "
          f"{launches['cuda']}, CPU launches {launches['cpu']}")
    if launches["cuda"] != want or any(launches["cpu"].values()):
        fail(f"the {arch} round's attention launches: card "
             f"{launches['cuda']} (expected {want}), CPU {launches['cpu']} "
             f"(expected none)")
    if not (worst <= ROUND_RTOL and (perr <= ROUND_ATOL or (
            lockstep and flips <= int(flip_share * total)))):
        fail(f"the {arch} round step on the card disagrees with the CPU")


def lm_topk_launches(configs, lm, tk, arch="smollm_135m"):
    """Top-k launches a round of ``arch`` at full width: one per
    (parameter type, EF type) pair of its leaves; one layer tells, as for
    mamba2."""
    from repro_torch.tree import flatten
    cfg = configs.get_config(arch).model.replace(num_layers=1)
    leaves = list(flatten(lm.init(cfg, seed=0, device="cuda")).values())
    n = topk_launches(leaves, leaves, tk)
    print(f"{arch} top-k: {len(leaves)} leaves of types "
          f"{sorted({str(x.dtype) for x in leaves})}: {n} launches a round")
    del leaves
    torch.cuda.empty_cache()
    return n


def lm_full(train, fa, tk, topk_per_round, arch="smollm_135m"):
    """Phases 16 and 25: the launcher's entry point on ``arch`` at full
    width and depth (smollm-135M's 30 layers, granite-moe-1b-a400m's 24;
    bf16, remat; R = 4 in 2 x 2, tau = q = 4; 2 x 2048 tokens a step):
    every attention launch, forward and backward, and every top-k launch
    counted, the run's numbers checked, round p50 and peak gated."""
    name = arch.split("_")[0]
    argv = ["--arch", arch, "--full", "--rounds", str(LM_ROUNDS),
            "--seq", "2047"]
    print("python -m repro_torch.launch.train " + " ".join(argv))
    torch.cuda.empty_cache()
    fa.reset_launches()
    tk.reset_launches()
    out = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"])
    cfg, hist = out["cfg"], out["history"]
    tau, R = 4, 4  # the configuration's HCEFConfig and the host topology
    steps = LM_ROUNDS * R * tau
    want = {"flash_attention": steps * cfg.num_layers * (2 if cfg.remat
                                                         else 1),
            "flash_attention_bwd": steps * cfg.num_layers,
            "paged_decode_attention": 0,
            "topk_compress": LM_ROUNDS * topk_per_round}
    if len(hist) != LM_ROUNDS:
        fail(f"the launcher ran {len(hist)} of {LM_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    if not hist[-1]["gossip"] or any(h["gossip"] for h in hist[:-1]):
        fail("expected gossip in the last round only")
    med = lambda v: float(np.percentile(v, 50))
    p50 = med(out["round_ms"])
    stats = dict(rounds=LM_ROUNDS, layers=cfg.num_layers,
                 d_model=cfg.d_model, heads=cfg.num_heads,
                 kv_heads=cfg.num_kv_heads, params=out["n_params"],
                 tokens_per_step=2 * 2048,
                 round_wall_ms_p50=p50, round_wall_ms=out["round_ms"],
                 round_limit_ms=LM_ROUND_LIMIT_MS,
                 phase_ms_p50={k: med(v) for k, v in out["timings"].items()},
                 phase_ms=out["timings"],
                 launches_per_round={k: v / LM_ROUNDS
                                     for k, v in launches.items()},
                 loss=[h["loss"] for h in hist],
                 rho_mean=[h["rho_mean"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 time_s=hist[-1]["time"], energy_j=hist[-1]["energy"],
                 peak_mem_gb=out["peak_mem_gb"],
                 peak_limit_gb=PEAK_LIMIT_GB)
    print(f"{name} " + json.dumps(stats))
    TRAIN_CELLS[name] = dict(cfg=cfg, replicas=R, tau=tau, seqs_per_step=2,
                             positions=2048, params=out["n_params"],
                             p50_ms=p50, peak_gb=out["peak_mem_gb"])
    print(f"{name} round p50 {p50:.1f} ms against {LM_ROUND_LIMIT_MS} ms "
          f"({'met' if p50 <= LM_ROUND_LIMIT_MS else 'missed'}); peak "
          f"{out['peak_mem_gb']:.2f} GB against {PEAK_LIMIT_GB} GB")
    if out["peak_mem_gb"] > PEAK_LIMIT_GB:
        fail(f"peak {out['peak_mem_gb']:.2f} GB over {PEAK_LIMIT_GB} GB")
    if p50 > LM_ROUND_LIMIT_MS:
        fail(f"{name} round p50 {p50:.1f} ms over {LM_ROUND_LIMIT_MS} ms")
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases 17-20: degraded mode and cohorts
# ---------------------------------------------------------------------------

# phase 17: the passes after the decode-and-mix launch of a gossip chunk
# with a partitioned cluster: absorbed * means, + y, the where that keeps
# y where nothing was lost, the where that keeps a cut row's own mean
MASKED_EPILOGUE_PASSES = 4
FOLD_DROPPED = 13  # phase 17: devices of ResNet-20's 64 dropped
CHAOS_ROUNDS = 4   # phase 18
FEDSIM_ROUND_LIMIT_MS = 3600.0  # phase 19: phase 7's limit
FEDSIM_POPULATION = 1024        # phase 19
LM_POPULATION = 16              # phase 20


def conn_cases(C):
    """Phase 17's backhaul masks: cluster 1 (and cluster 0) cut alone,
    and every link but cluster 0's."""
    return [1 - np.eye(C)[1], 1 - np.eye(C)[0], np.eye(C)[0]]


def masked_mix_cases(col, gen):
    """The masked gossip (``_sparse_mix_rows(..., conn=)``: the conn mask
    folded into the decode-and-mix's coefficients and the two passes
    after it) on the card against its plain route, bit for bit: MIX_CASES
    at ring and at erdos_renyi, every wire dtype, conn_cases."""
    n = 0
    for hk0, C, wbk, L, levels, dense in MIX_CASES:
        means = mix_means(gen, C, L)
        for hkind in ("ring", "erdos_renyi"):
            for wd in WIRE_DTYPES:
                plans = col._wire_plans(levels, L, wbk, wd, torch.empty(
                    (), dtype=dense).element_size())
                layout = col._gossip_layout(hkind, C, 0.4, 0, tuple(plans))
                kw = dict(wb=col.wf.wire_block_of(L, wbk), wire_dtype=wd,
                          dense_dtype=dense)
                for conn in conn_cases(C):
                    want = col._sparse_mix_rows(means, layout, impl="plain",
                                                conn=conn, **kw)
                    got = col._sparse_mix_rows(means, layout, conn=conn,
                                               **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(_bits(got), _bits(want)):
                        fail(f"masked gossip differs from its plain route: "
                             f"{hkind} C={C} {wd} conn {conn.tolist()}")
                    cut = np.flatnonzero(conn == 0)
                    if not torch.equal(_bits(got[cut]), _bits(means[cut])):
                        fail(f"a partitioned row lost its own mean: {hkind} "
                             f"C={C} {wd}")
                    n += 1
    return n


def masked_gossip_chunk(wp, col, means, cols):
    """Phase 10's main chunk (C = 2, levels GOSSIP_LEVELS, int4) through
    ``sparse_exchange_`` with cluster 1 partitioned: bit for bit its plain
    route, the partitioned rows keeping their own mean, no host
    synchronisation inside it, one decode-and-mix launch and the
    GOSSIP_CHUNK_LAUNCHES of the unmasked chunk plus
    MASKED_EPILOGUE_PASSES; timed beside the unmasked chunk."""
    C, Dev = 2, 2
    x = means.repeat_interleave(Dev, dim=0).to(torch.bfloat16)
    conn = np.array([1.0, 0.0], np.float32)
    kw = dict(clusters=C, dev=Dev, hkind="ring", wire_dtype="int4",
              wire_block=1024, cluster_theta=GOSSIP_LEVELS,
              chunk_cols=cols)
    want = x.clone()
    col.sparse_exchange_(want, impl="plain", conn=conn, **kw)
    got = x.clone()
    col.sparse_exchange_(got, conn=conn, **kw)
    torch.cuda.synchronize()
    if not torch.equal(_bits(got), _bits(want)):
        fail("the masked gossip chunk on the card differs from its plain "
             "route")
    if not torch.equal(_bits(got[Dev:]), _bits(x[Dev:])):
        fail("the partitioned cluster's rows changed in the gossip")
    checked = x.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        col.sparse_exchange_(checked, conn=conn, **kw)
    except RuntimeError as e:
        fail(f"the masked gossip chunk synchronised the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(_bits(checked), _bits(got)):
        fail("the masked chunk under the sync check gave another result")
    counted = x.clone()
    wp.reset_launches()
    ops = aten_kernel_ops(lambda: col.sparse_exchange_(counted, conn=conn,
                                                       **kw))
    launches = dict(wp.LAUNCHES)
    total = sum(launches.values()) + len(ops)
    scratch = x.clone()
    masked = lambda: col.sparse_exchange_(scratch, conn=conn, **kw)
    plain_chunk = lambda: col.sparse_exchange_(scratch, **kw)
    row = dict(case=f"one chunk: sparse_exchange_ on (4, {x.shape[1]}) bf16,"
               f" C=2 ring, int4 levels {GOSSIP_LEVELS}, cluster 1 "
               f"partitioned", ms=time_ms(masked),
               unmasked_ms=time_ms(plain_chunk),
               call_ms=time_ms(masked, host_paced=True),
               device_launches=total, wire_launches=launches,
               epilogue_passes=total - GOSSIP_CHUNK_LAUNCHES,
               torch_kernel_ops=ops, host_syncs=0)
    print("masked_gossip_chunk " + json.dumps(row))
    want_wire = {"wire_encode": 2, "wire_pack": 0, "wire_unpack": 0,
                 "wire_decode_mix": 1}
    if (launches != want_wire
            or row["epilogue_passes"] != MASKED_EPILOGUE_PASSES):
        fail(f"the masked chunk ran {total} device launches (wire "
             f"{launches}, PyTorch {ops}), expected "
             f"{GOSSIP_CHUNK_LAUNCHES} + {MASKED_EPILOGUE_PASSES} (wire "
             f"{want_wire})")
    return row


def fold_after_topk(tk, compression, chaos_mod, leaf_shapes):
    """``fold_dropped_updates`` after the grouped top-k (one launch) on
    ResNet-20's 59 leaves at R = 64, block 256, FOLD_DROPPED devices
    dropped: contribution + ef_out == delta + ef_old on every leaf, the
    dropped rows contributing zeros."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    R = 64
    delta = {i: torch.randn((R,) + s, generator=gen, device="cuda")
             for i, s in enumerate(leaf_shapes)}
    ef = {i: 0.1 * torch.randn((R,) + s, generator=gen, device="cuda")
          for i, s in enumerate(leaf_shapes)}
    want = {k: delta[k] + ef[k] for k in delta}
    theta = torch.rand(R, generator=gen, device="cuda") * 0.9 + 0.05
    tk.reset_launches()
    comp, ef_new = compression.compress_delta(delta, ef, theta, block=256)
    torch.cuda.synchronize()
    launches = tk.LAUNCHES["topk_compress"]
    alive = np.ones(R, bool)
    alive[np.random.default_rng(17).choice(R, FOLD_DROPPED,
                                           replace=False)] = False
    contrib, ef_out = chaos_mod.fold_dropped_updates(comp, ef_new, alive)
    dead = torch.as_tensor(~alive, device="cuda")
    for k in want:
        if not torch.equal(contrib[k] + ef_out[k], want[k]):
            fail(f"fold after the top-k: leaf {k} loses an update")
        if contrib[k][dead].any():
            fail(f"fold after the top-k: a dropped device contributes "
                 f"(leaf {k})")
    print(f"fold after the grouped top-k: {len(want)} ResNet-20 leaves at "
          f"R={R}, {FOLD_DROPPED} devices dropped, contribution + ef_out == "
          f"delta + ef_old on every leaf ({launches} top-k launch)")
    if launches != 1:
        fail(f"{launches} top-k launches for ResNet-20's table, expected 1")


def masked_mix_phase(wp, col, tk, compression, chaos_mod, configs, mamba2,
                     cols, leaf_shapes):
    """Phase 17."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(17)
    n = masked_mix_cases(col, gen)
    print(f"masked gossip: {n} cases of MIX_CASES at ring and erdos_renyi, "
          f"every wire dtype, one cluster and all but one partitioned, bit "
          f"for bit the plain route")
    _, means = w_in_chunk(configs, mamba2, cols)
    row = masked_gossip_chunk(wp, col, means, cols)
    del means
    torch.cuda.empty_cache()
    fold_after_topk(tk, compression, chaos_mod, leaf_shapes)
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return row


def chaos_trace(chaos_mod, R, C, rounds, q, seed=2):
    """A fixed fault trace: [(alive, conn) or None] a round (None: every
    device alive and every link up, the unmasked step)."""
    plan = chaos_mod.FaultPlan(chaos_mod.ChaosConfig(
        seed=seed, dropout_prob=0.3, partition_prob=0.5,
        coordinator_fail_prob=0.3), R, C)
    out = []
    for r in range(rounds):
        f = plan.step(r, gossip_round=(r + 1) % q == 0)
        out.append(None if f.alive.all() and f.cluster_conn.all()
                   else (f.alive, f.cluster_conn))
    return out


def masks_of(col, faults, C, Dev):
    if faults is None:
        return {}
    alive, conn = faults
    return dict(alive=alive.astype(np.float32),
                alive_w=col.participation_weights(alive, clusters=C,
                                                  dev=Dev),
                conn=conn.astype(np.float32))


def lm_chaos_rounds(configs, lm, rnd_mod, base, col, trace, dev, params0,
                    tokens):
    """The smoke smollm's off-mesh step under ``trace`` on ``dev``:
    (history, parameters and EF on the CPU)."""
    from repro_torch.tree import flatten
    cfg = configs.smoke_model(configs.get_config("smollm_135m").model)
    hcef = base.HCEFConfig(tau=4, q=2, eta=0.1)
    topo = base.FLTopology(2, 2)
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    theta = np.array([0.5, 0.25, 1.0, 0.1])
    state = rnd_mod.init_state(cfg, hcef, topo, params0, device=dev)
    hist = []
    for r, faults in enumerate(trace):
        step = rnd_mod.make_round_step(cfg, hcef, topo, gossip=r % 2 == 1)
        state, m = step(state, {"tokens": tokens[r]}, rho, theta, 7 + r,
                        **masks_of(col, faults, 2, 2))
        hist.append({k: v.cpu().numpy() for k, v in m.items()})
    return hist, {f: {k: v.cpu() for k, v in
                      flatten(getattr(state, f)).items()}
                  for f in ("params", "ef")}


def sparse_chaos_rounds(configs, mamba2, rnd_mod, base, compression,
                        policies, col, params0, tokens, lockstep):
    """Phase 18's fused rounds: the smoke mamba2 with the int4 wire at
    levels (0.1, 0.6), no wire EF, device 3 dead every round and cluster 1
    partitioned in the gossip rounds, on the CPU and the card; with
    ``lockstep`` each round starts both from the card's state.  Yields
    (round, {device: metrics}, {device: parameters and EF on the CPU})."""
    import dataclasses
    from repro_torch.tree import flatten, tree_map
    cfg, hcef, topo, policy, theta, levels = sparse_setup(
        configs, base, compression, policies, full=False)
    hcef = dataclasses.replace(hcef, wire_ef=False)
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    states = {d: rnd_mod.init_state(cfg, hcef, topo, params0, device=d)
              for d in ("cpu", "cuda")}
    alive = np.array([1, 1, 1, 0], bool)
    for r in range(CHAOS_ROUNDS):
        gossip = (r + 1) % SPARSE_Q == 0
        if lockstep:
            c = states["cuda"]
            cpu = lambda t: None if t is None else tree_map(
                lambda x: x.cpu().clone(), t)
            states["cpu"] = c._replace(params=cpu(c.params),
                                       momentum=cpu(c.momentum),
                                       ef=cpu(c.ef))
        step = rnd_mod.make_round_step(cfg, hcef, topo, policy,
                                       gossip=gossip,
                                       cluster_levels=levels if gossip
                                       else None)
        masks = masks_of(col, (alive, np.array([True, not gossip])), 2, 2)
        mets, leaves = {}, {}
        for d in ("cpu", "cuda"):
            states[d], m = step(states[d], {"tokens": tokens[r]}, rho,
                                theta, 21 + r, **masks)
            mets[d] = {k: v.cpu().numpy() for k, v in m.items()}
            leaves[d] = {f + "/" + k: v.cpu()
                         for f in ("params", "ef")
                         for k, v in flatten(getattr(states[d], f)).items()}
        yield r, mets, leaves


def dead_cluster_on_card(configs, lm, rnd_mod, base, col, params0, tokens):
    """A gossip round with cluster 1 fully dropped and partitioned: its
    parameters kept bit for bit, its EF holding the pending update."""
    from repro_torch.tree import flatten
    cfg = configs.smoke_model(configs.get_config("smollm_135m").model)
    hcef = base.HCEFConfig(tau=4, q=2, eta=0.1)
    topo = base.FLTopology(2, 2)
    state = rnd_mod.init_state(cfg, hcef, topo, params0, device="cuda")
    before = {k: v.clone() for k, v in flatten(state.params).items()}
    step = rnd_mod.make_round_step(cfg, hcef, topo, gossip=True)
    state, _ = step(state, {"tokens": tokens[0]}, np.ones(4),
                    np.full(4, 0.3), 3, **masks_of(
                        col, (np.array([1, 1, 0, 0], bool),
                              np.array([True, False])), 2, 2))
    kept = all(torch.equal(_bits(v[2:]), _bits(before[k][2:]))
               for k, v in flatten(state.params).items())
    absorbed = max(float(v[2:].abs().max())
                   for v in flatten(state.ef).values())
    return kept, absorbed


def rounds_under_masks(configs, lm, mamba2, rnd_mod, base, compression,
                       policies, col, chaos_mod, train, wp):
    """Phase 18: the round step under the masks, card against CPU, and
    the card's own contracts.  Returns the fused run's wire launches."""
    t0 = time.perf_counter()
    cfg = configs.smoke_model(configs.get_config("smollm_135m").model)
    params0 = lm.init(cfg, torch.Generator().manual_seed(18), device="cpu")
    rng = np.random.default_rng(18)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 65)))
              for _ in range(CHAOS_ROUNDS)]
    trace = chaos_trace(chaos_mod, 4, 2, CHAOS_ROUNDS, 2)
    if all(f is None for f in trace):
        fail("the phase-18 chaos trace drops nothing")
    runs = {d: lm_chaos_rounds(configs, lm, rnd_mod, base, col, trace, d,
                               params0, tokens) for d in ("cpu", "cuda")}
    worst = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
                for a, b in zip(runs["cuda"][0], runs["cpu"][0])
                for k in ("loss", "g2", "sigma2"))
    perr = max(float((runs["cuda"][1][f][k] - v).abs().max())
               for f in ("params", "ef") for k, v in
               runs["cpu"][1][f].items())
    shown = [None if f is None else (f[0].tolist(), f[1].tolist())
             for f in trace]
    print(f"smollm small round under chaos: trace {shown}; card vs CPU over {CHAOS_ROUNDS} rounds, largest relative "
          f"deviation of loss/g2/sigma2 {worst:.3e} (tolerance {ROUND_RTOL}),"
          f" largest parameter or EF deviation {perr:.3e} (tolerance "
          f"{ROUND_ATOL})")
    if not (worst <= ROUND_RTOL and perr <= ROUND_ATOL):
        fail("the LM round under chaos on the card disagrees with the CPU")
    replay = lm_chaos_rounds(configs, lm, rnd_mod, base, col,
                             chaos_trace(chaos_mod, 4, 2, CHAOS_ROUNDS, 2),
                             "cuda", params0, tokens)
    if not all(torch.equal(_bits(replay[1][f][k]), _bits(v))
               for f in ("params", "ef")
               for k, v in runs["cuda"][1][f].items()):
        fail("a chaos run and its replay differ on the card")
    zero = chaos_mod.FaultPlan(chaos_mod.ChaosConfig(seed=2), 4, 2)
    zero_trace = [None if (f.alive.all() and f.cluster_conn.all()) else
                  (f.alive, f.cluster_conn)
                  for f in (zero.step(r, gossip_round=r % 2 == 1)
                            for r in range(CHAOS_ROUNDS))]
    a = lm_chaos_rounds(configs, lm, rnd_mod, base, col, zero_trace, "cuda",
                        params0, tokens)
    b = lm_chaos_rounds(configs, lm, rnd_mod, base, col,
                        [None] * CHAOS_ROUNDS, "cuda", params0, tokens)
    if not all(torch.equal(_bits(a[1][f][k]), _bits(v))
               for f in ("params", "ef") for k, v in b[1][f].items()):
        fail("zero fault probabilities differ from no chaos on the card")
    kept, absorbed = dead_cluster_on_card(configs, lm, rnd_mod, base, col,
                                          params0, tokens)
    print(f"on the card: chaos replay bit for bit, zero chaos bit for bit "
          f"no chaos; a dead partitioned cluster kept its parameters: "
          f"{kept}, its EF took up to {absorbed:.3e}")
    if not (kept and absorbed > 0):
        fail("a dead, partitioned cluster did not keep its model or its EF "
             "took nothing")
    # the fused branch under the masks
    mcfg = configs.smoke_model(configs.get_config("mamba2_1p3b").model)
    mparams = mamba2.init(mcfg, torch.Generator().manual_seed(19),
                          device="cpu")
    rng = np.random.default_rng(19)
    mtokens = [torch.from_numpy(rng.integers(0, mcfg.vocab_size, (16, 40)))
               for _ in range(CHAOS_ROUNDS)]
    wp.reset_launches()
    worst, flips, total = 0.0, 0, 0
    for r, mets, leaves in sparse_chaos_rounds(
            configs, mamba2, rnd_mod, base, compression, policies, col,
            mparams, mtokens, lockstep=True):
        a, b = mets["cuda"], mets["cpu"]
        for k in ("loss", "g2", "sigma2"):
            worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                            / np.abs(b[k]))))
        dev = {k: (leaves["cuda"][k] - v).abs()
               for k, v in leaves["cpu"].items()}
        flips = max(flips, sum(int((v > ROUND_ATOL).sum())
                               for v in dev.values()))
        total = sum(v.numel() for v in dev.values())
    launches = dict(wp.LAUNCHES)
    allowed = int(Q_FLIP_SHARE * total)
    print(f"mamba2 small sparse round under masks (device 3 dead, cluster 1 "
          f"cut in the gossip rounds, int4 levels {GOSSIP_LEVELS}, lockstep):"
          f" card vs CPU over {CHAOS_ROUNDS} rounds, largest relative "
          f"deviation of loss/g2/sigma2 {worst:.3e} (tolerance {ROUND_RTOL}),"
          f" entries above {ROUND_ATOL}: at most {flips} of {total} "
          f"(allowed {allowed}); wire launches on the card {launches}")
    if not (worst <= ROUND_RTOL and flips <= allowed):
        fail("the fused round under masks on the card disagrees with the "
             "CPU")
    if not (launches["wire_encode"] and launches["wire_decode_mix"]):
        fail(f"the masked fused round ran no wire kernels: {launches}")
    # population == R through the launcher: the same bits as no store
    argv = ["--arch", "smollm_135m", "--rounds", str(CHAOS_ROUNDS)]
    plain = train.main(argv)
    pop = train.main(argv + ["--population", "4"])
    from repro_torch.tree import flatten
    same = ([h["loss"] for h in plain["history"]]
            == [h["loss"] for h in pop["history"]]) and all(
        torch.equal(_bits(v), _bits(flatten(getattr(pop["state"], f))[k]))
        for f in ("params", "ef", "momentum")
        for k, v in flatten(getattr(plain["state"], f)).items())
    print(f"smollm smoke through the launcher at --population 4 (= R): bit "
          f"for bit the storeless run: {same}")
    if not same:
        fail("population == R differs from the fixed roster on the card")
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return launches


def fedsim_chaos_full(fedsim, tk, chaos_mod):
    """Phase 19: ResNet-20 at the paper's topology under chaos with a
    population of FEDSIM_POPULATION clients over the 64 slots,
    FEDSIM_ROUNDS rounds of ``FedSim.run``, every top-k launch counted and
    every cohort swap checked."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fedsim_pop_") as td:
        sim = fedsim.make_sim(
            "hcef", model="resnet20", device="cuda",
            chaos=chaos_mod.ChaosConfig(seed=0, dropout_prob=0.2,
                                        partition_prob=0.1,
                                        coordinator_fail_prob=0.2),
            population=FEDSIM_POPULATION, store_root=td,
            verify_conservation=True)
        torch.cuda.synchronize()
        print(f"fedsim resnet20 chaos+cohorts: {sim.cfg.n_devices} slots in "
              f"{sim.cfg.n_clusters} clusters over {FEDSIM_POPULATION} "
              f"clients (resident_max {sim.cfg.resident_max}), set up in "
              f"{time.perf_counter() - t0:.1f} s")
        sim.timings = {}
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launches()
        sim.run(FEDSIM_ROUNDS, eval_every=FEDSIM_ROUNDS,
                on_round=fedsim.print_round(sim, "resnet20 chaos "))
        launches = tk.LAUNCHES["topk_compress"]
        hist, walls = sim.history, sim.round_ms
        pages = {int(p.name[7:15]) for p in Path(td).glob("client_*.npy")}
        store = sim.pop_store
        took_part = set(np.flatnonzero(store.rounds_participated > 0))
    if len(hist) != FEDSIM_ROUNDS:
        fail(f"the run stopped after {len(hist)} of {FEDSIM_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if not all(bool(torch.isfinite(p).all()) for p in sim.params.values()):
        fail("non-finite parameters")
    parts = [h["participation"] for h in hist]
    if not min(parts) < 1.0:
        fail("participation is 1 in every round")
    # the first swap fills empty slots; every later one is checked
    checks = [h["swap_check"] for h in hist if "swap_check" in h]
    if len(checks) != FEDSIM_ROUNDS - 1 or not all(c["equal"]
                                                   for c in checks):
        fail(f"the population's sums moved across a swap: {checks}")
    if not any(c["ef_before"] != 0.0 for c in checks):
        fail("every swap paged a zero EF: the EF check proves nothing")
    if not pages <= took_part:
        fail(f"page files for clients that never took part: "
             f"{sorted(pages - took_part)[:8]}")
    if launches != FEDSIM_ROUNDS:
        fail(f"{launches} top-k launches, expected one a round")
    med = lambda v: float(np.percentile(v, 50))
    p50 = med(walls)
    stats = dict(rounds=FEDSIM_ROUNDS, population=FEDSIM_POPULATION,
                 slots=sim.cfg.n_devices, round_wall_ms_p50=p50,
                 round_wall_ms=walls, round_limit_ms=FEDSIM_ROUND_LIMIT_MS,
                 phase_ms_p50={k: med(v) for k, v in sim.timings.items()},
                 verify_swap_ms_p50=med([c["host_ms"] for c in checks]),
                 launches=launches, participation=parts,
                 n_deadline_missed=[h["n_deadline_missed"] for h in hist],
                 n_partitioned=[h["n_partitioned"] for h in hist],
                 cohort_new=[h["cohort_new"] for h in hist],
                 resident_clients=[h["resident_clients"] for h in hist],
                 page_files=len(pages), clients_took_part=len(took_part),
                 ef_sum_last_swap=checks[-1]["ef_before"],
                 state_sum_last_swap=checks[-1]["state_before"],
                 loss=[h["loss"] for h in hist], acc=hist[-1]["acc"],
                 theta_mean=[h["theta_mean"] for h in hist],
                 time_s=hist[-1]["time"], energy_j=hist[-1]["energy"],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 phase_s=time.perf_counter() - t0)
    print("fedsim_chaos " + json.dumps(stats))
    print(f"fedsim chaos+cohorts round p50 {p50:.1f} ms against "
          f"{FEDSIM_ROUND_LIMIT_MS} ms")
    if p50 > FEDSIM_ROUND_LIMIT_MS:
        fail(f"round p50 {p50:.1f} ms over {FEDSIM_ROUND_LIMIT_MS} ms")
    return launches


def lm_chaos_full(train, fa, tk, topk_per_round):
    """Phase 20: the launcher's entry point on smollm-135M at full width
    and depth under ``--chaos --population LM_POPULATION``, LM_ROUNDS
    rounds, every launch counted, every swap checked."""
    t0 = time.perf_counter()
    argv = ["--arch", "smollm_135m", "--full", "--rounds", str(LM_ROUNDS),
            "--seq", "2047", "--chaos", "--population", str(LM_POPULATION),
            "--verify-conservation"]
    print("python -m repro_torch.launch.train " + " ".join(argv))
    torch.cuda.empty_cache()
    fa.reset_launches()
    tk.reset_launches()
    out = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"])
    cfg, hist = out["cfg"], out["history"]
    tau, R = 4, 4
    steps = LM_ROUNDS * R * tau  # dropped devices run their steps too
    want = {"flash_attention": steps * cfg.num_layers * (2 if cfg.remat
                                                         else 1),
            "flash_attention_bwd": steps * cfg.num_layers,
            "paged_decode_attention": 0,
            "topk_compress": LM_ROUNDS * topk_per_round}
    if len(hist) != LM_ROUNDS:
        fail(f"the launcher ran {len(hist)} of {LM_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if not all("participation" in h for h in hist):
        fail("participation missing from a round")
    parts = [h["participation"] for h in hist]
    if not min(parts) < 1.0:
        fail("participation is 1 in every round")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    # the first swap fills empty slots; every later one is checked
    checks = [h["swap_check"] for h in hist if "swap_check" in h]
    if len(checks) != LM_ROUNDS - 1 or not all(c["equal"] for c in checks):
        fail(f"the population's sums moved across a swap: {checks}")
    if not all(c["state_before"] != 0.0 for c in checks):
        fail(f"a swap paged a zero state: the check proves nothing: "
             f"{checks}")
    if all(c["ef_before"] == 0.0 for c in checks):
        print("the EF conservation is vacuous on this path: every swap "
              "paged a zero EF; the whole-state sums carry the check here,"
              " phases 17-19 check a nonzero fold and EF")
    med = lambda v: float(np.percentile(v, 50))
    p50 = med(out["round_ms"])
    stats = dict(rounds=LM_ROUNDS, layers=cfg.num_layers,
                 population=LM_POPULATION, slots=R, params=out["n_params"],
                 tokens_per_step=2 * 2048, round_wall_ms_p50=p50,
                 round_wall_ms=out["round_ms"],
                 round_limit_ms=LM_ROUND_LIMIT_MS,
                 phase_ms_p50={k: med(v) for k, v in out["timings"].items()},
                 phase_ms=out["timings"],
                 swap_bytes_per_round=out["swap_bytes"],
                 launches_per_round={k: v / LM_ROUNDS
                                     for k, v in launches.items()},
                 participation=parts,
                 n_deadline_missed=[h["n_deadline_missed"] for h in hist],
                 n_partitioned=[h["n_partitioned"] for h in hist],
                 degraded=[h["degraded"] for h in hist],
                 cohorts=[h["cohort"] for h in hist], swap_checks=checks,
                 loss=[h["loss"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 peak_mem_gb=out["peak_mem_gb"], peak_limit_gb=PEAK_LIMIT_GB,
                 phase_s=time.perf_counter() - t0)
    print("smollm_chaos " + json.dumps(stats))
    print(f"smollm chaos+cohorts round p50 {p50:.1f} ms against "
          f"{LM_ROUND_LIMIT_MS} ms; peak {out['peak_mem_gb']:.2f} GB against "
          f"{PEAK_LIMIT_GB} GB")
    if p50 > LM_ROUND_LIMIT_MS:
        fail(f"round p50 {p50:.1f} ms over {LM_ROUND_LIMIT_MS} ms")
    if out["peak_mem_gb"] > PEAK_LIMIT_GB:
        fail(f"peak {out['peak_mem_gb']:.2f} GB over {PEAK_LIMIT_GB} GB")
    return launches


# ---------------------------------------------------------------------------
# phases 21-23: the overlap engine
# ---------------------------------------------------------------------------

# phase 21: the device launches of phase 10's main chunk with every
# cluster stale: the synchronous chunk's (two encodes, one decode-and-mix,
# two copies) and the bf16 -> f32 copy of the stale rows the encodes read
STALE_CHUNK_LAUNCHES = GOSSIP_CHUNK_LAUNCHES + 1
OVERLAP_ROUNDS = 4  # phases 22-23: q = 2, rounds 2 and 4 gossip
# phase 23's launcher run: the stale set of its gossip round (round 4 at q
# = 4), worked out on the host (fl.cost_model.decide_stale_clusters, the
# launcher's controller and heterogeneity model) for smollm-135M's
# 134,515,008 parameters: per-device times (1237.7, 912.0, 1525.1, 1150.7)
# s and a backhaul of 43.0 s put cluster 1 alone past the 0.9 quantile
# deadline (at 0.5 and below both clusters are stale)
LAUNCHER_STALE_QUANTILE = 0.9
LAUNCHER_STALE_SET = [1]


def stale_cases(C):
    """Phase 21's (stale set, backhaul mask): every cluster, cluster 1
    alone, every cluster with cluster 1 partitioned."""
    return [(tuple(range(C)), None), ((1,), None),
            (tuple(range(C)), 1 - np.eye(C, dtype=np.float32)[1])]


def stale_mix_cases(col, gen):
    """``_sparse_mix_rows(..., stale=)`` on the card against its plain
    route, bit for bit: MIX_CASES at ring and erdos_renyi, every wire
    dtype, stale_cases."""
    n = 0
    for _, C, wbk, L, levels, dense in MIX_CASES:
        means, stale = mix_means(gen, C, L), mix_means(gen, C, L)
        for hkind in ("ring", "erdos_renyi"):
            for wd in WIRE_DTYPES:
                plans = col._wire_plans(levels, L, wbk, wd, torch.empty(
                    (), dtype=dense).element_size())
                layout = col._gossip_layout(hkind, C, 0.4, 0, tuple(plans))
                kw = dict(wb=col.wf.wire_block_of(L, wbk), wire_dtype=wd,
                          dense_dtype=dense)
                for st, conn in stale_cases(C):
                    sk = dict(stale=stale, stale_clusters=st, conn=conn)
                    want = col._sparse_mix_rows(means, layout, impl="plain",
                                                **sk, **kw)
                    got = col._sparse_mix_rows(means, layout, **sk, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(_bits(got), _bits(want)):
                        fail(f"stale gossip differs from its plain route: "
                             f"{hkind} C={C} {wd} stale {st} conn "
                             f"{None if conn is None else conn.tolist()}")
                    n += 1
    return n


def encode_on_side(col, stale, kw, side):
    """``stale_payloads`` on the side stream after the current stream's
    work, as the overlap step runs them; the current stream then waits
    for them."""
    main = torch.cuda.current_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        pre = col.stale_payloads(stale, **kw)
        done = torch.cuda.Event()
        done.record()
    main.wait_event(done)
    for chunk in pre:
        for payload, _ in chunk:
            for t in payload:
                if t is not None:
                    t.record_stream(main)
    return pre


def stale_gossip_chunk(wp, col, means, cols):
    """Phase 10's main chunk (C = 2, levels GOSSIP_LEVELS, int4) with
    every cluster stale: encoded ahead of time on a side stream
    (``stale_payloads``), then ``sparse_exchange_(payloads=)``, bit for
    bit the in-line stale chunk and its plain route; no host
    synchronisation; STALE_CHUNK_LAUNCHES device launches, the wire's
    the synchronous chunk's; timed beside the synchronous chunk."""
    C, Dev = 2, 2
    x = means.repeat_interleave(Dev, dim=0).to(torch.bfloat16)
    s = means.flip(1).repeat_interleave(Dev, dim=0).to(torch.bfloat16)
    kw = dict(clusters=C, dev=Dev, hkind="ring", wire_dtype="int4",
              wire_block=1024, cluster_theta=GOSSIP_LEVELS,
              chunk_cols=cols)
    st = dict(stale=s, stale_clusters=(0, 1))
    side = torch.cuda.Stream()
    want = x.clone()
    col.sparse_exchange_(want, impl="plain", **st, **kw)
    inline = x.clone()
    col.sparse_exchange_(inline, **st, **kw)
    got = x.clone()
    col.sparse_exchange_(got, payloads=encode_on_side(col, s, kw, side),
                         **kw)
    fresh = x.clone()
    col.sparse_exchange_(fresh, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(_bits(inline), _bits(want))
            and torch.equal(_bits(got), _bits(want))):
        fail("the stale gossip chunk (in line, or encoded ahead on the "
             "side stream) differs from its plain route")
    if torch.equal(_bits(got), _bits(fresh)):
        fail("the stale gossip chunk gave the fresh chunk's bits")
    checked = x.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        col.sparse_exchange_(checked, payloads=encode_on_side(
            col, s, kw, side), **kw)
    except RuntimeError as e:
        fail(f"the stale gossip chunk synchronised the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(_bits(checked), _bits(got)):
        fail("the stale chunk under the sync check gave another result")
    counted = x.clone()
    wp.reset_launches()
    ops = [op for op in aten_kernel_ops(lambda: col.sparse_exchange_(
        counted, payloads=encode_on_side(col, s, kw, side), **kw))
        if "record_stream" not in op]
    launches = dict(wp.LAUNCHES)
    scratch = x.clone()
    pre = encode_on_side(col, s, kw, side)
    row = dict(case=f"one chunk: sparse_exchange_ on (4, {x.shape[1]}) bf16,"
               f" C=2 ring, int4 levels {GOSSIP_LEVELS}, every cluster "
               f"stale", device_launches=sum(launches.values()) + len(ops),
               wire_launches=launches, torch_kernel_ops=ops, host_syncs=0,
               sync_ms=time_ms(lambda: col.sparse_exchange_(scratch, **kw)),
               stale_inline_ms=time_ms(
                   lambda: col.sparse_exchange_(scratch, **st, **kw)),
               ahead_ms=time_ms(lambda: col.sparse_exchange_(
                   scratch, payloads=encode_on_side(col, s, kw, side),
                   **kw)),
               side_encode_ms=time_ms(lambda: col.stale_payloads(s, **kw)),
               main_mix_ms=time_ms(lambda: col.sparse_exchange_(
                   scratch, payloads=pre, **kw)))
    print("stale_gossip_chunk " + json.dumps(row))
    want_wire = {"wire_encode": 2, "wire_pack": 0, "wire_unpack": 0,
                 "wire_decode_mix": 1}
    if (launches != want_wire
            or row["device_launches"] != STALE_CHUNK_LAUNCHES):
        fail(f"the stale chunk ran {row['device_launches']} device launches "
             f"(wire {launches}, PyTorch {ops}), expected "
             f"{STALE_CHUNK_LAUNCHES} (wire {want_wire})")
    return row


def stale_mix_phase(wp, col, configs, mamba2, cols):
    """Phase 21."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    n = stale_mix_cases(col, gen)
    print(f"stale gossip: {n} cases of MIX_CASES at ring and erdos_renyi, "
          f"every wire dtype, every cluster stale, cluster 1 stale, every "
          f"cluster stale with cluster 1 partitioned, bit for bit the plain "
          f"route")
    _, means = w_in_chunk(configs, mamba2, cols)
    stale_gossip_chunk(wp, col, means, cols)
    del means
    torch.cuda.empty_cache()
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s")


def _copy_state(state, fields, device):
    """An overlap state (or its fl) with every tensor copied to
    ``device``."""
    from repro_torch.tree import tree_map
    cp = lambda t: None if t is None else tree_map(
        lambda x: x.to(device, copy=True), t)
    fl = state.fl
    return state._replace(fl=fl._replace(**{f: cp(getattr(fl, f))
                                            for f in fields}),
                          pending=cp(state.pending))


def _leaves_of(state, fields):
    from repro_torch.tree import flatten
    out = {f + "/" + k: v.cpu() for f in fields
           for k, v in flatten(getattr(state.fl, f)).items()}
    out.update({"pending/" + k: v.cpu()
                for k, v in flatten(state.pending).items()})
    return out


def _overlap_lockstep(rnd_mod, cfg, hcef, topo, params0, tokens, rho, theta,
                      step_of, seed):
    """OVERLAP_ROUNDS overlap rounds on the CPU and the card, each round
    starting both from the card's state (a top-k threshold flip would
    otherwise spread through the later rounds).  Returns (largest
    relative deviation of loss/g2/sigma2, most entries beyond ROUND_ATOL
    in a round, entries, stale_frac a round (-1: none))."""
    fields = ("params", "ef", "momentum")
    states = {d: rnd_mod.init_overlap_state(cfg, hcef, topo, params0,
                                            device=d)
              for d in ("cpu", "cuda")}
    worst, flips, total, fracs = 0.0, 0, 0, []
    for r in range(OVERLAP_ROUNDS):
        states["cpu"] = _copy_state(states["cuda"], fields, "cpu")
        step = step_of(r)
        mets, leaves = {}, {}
        for d in ("cpu", "cuda"):
            states[d], m = step(states[d], {"tokens": tokens[r]}, rho,
                                theta, seed + r)
            mets[d] = {k: v.cpu().numpy() for k, v in m.items()}
            leaves[d] = _leaves_of(states[d], fields)
        a, b = mets["cuda"], mets["cpu"]
        for k in ("loss", "g2", "sigma2"):
            worst = max(worst, float(np.max(np.abs(a[k] - b[k])
                                            / np.abs(b[k]))))
        if a.get("stale_frac") != b.get("stale_frac"):
            fail("stale_frac differs between the card and the CPU")
        fracs.append(float(a.get("stale_frac", -1)))
        dev = {k: (leaves["cuda"][k] - v).abs()
               for k, v in leaves["cpu"].items()}
        flips = max(flips, sum(int((v > ROUND_ATOL).sum())
                               for v in dev.values()))
        total = sum(v.numel() for v in dev.values())
    return worst, flips, total, fracs


def overlap_small(configs, lm, mamba2, rnd_mod, base, compression, policies,
                  wp):
    """Phase 22: the overlap step at staleness 1, card against CPU in
    lockstep, at smoke size: losses and statistics within ROUND_RTOL, the
    state (parameters, EF, momentum, pending) within ROUND_ATOL but for
    Q_FLIP_SHARE of its entries; on the card staleness 0 and an empty
    stale set give the synchronous step's bits."""
    import dataclasses
    from repro_torch.tree import flatten
    t0 = time.perf_counter()
    topo = base.FLTopology(2, 2)
    rho = np.array([0.9, 0.6, 0.8, 0.7])
    # the smoke smollm off the mesh: round 2 every cluster stale, round 4
    # cluster 1 alone
    cfg = configs.smoke_model(configs.get_config("smollm_135m").model)
    hcef = base.HCEFConfig(tau=4, q=2, eta=0.1, overlap=True, staleness=1)
    params0 = lm.init(cfg, torch.Generator().manual_seed(22), device="cpu")
    rng = np.random.default_rng(22)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 65)))
              for _ in range(OVERLAP_ROUNDS)]
    theta = np.array([0.5, 0.25, 1.0, 0.1])
    worst, flips, total, fracs = _overlap_lockstep(
        rnd_mod, cfg, hcef, topo, params0, tokens, rho, theta,
        lambda r: rnd_mod.make_overlap_round_step(
            cfg, hcef, topo, gossip=r % 2 == 1,
            stale_clusters=(1,) if r == 3 else None), 7)
    allowed = int(Q_FLIP_SHARE * total)
    print(f"smollm small overlap round (off the mesh, staleness 1, "
          f"lockstep): card vs CPU over {OVERLAP_ROUNDS} rounds, stale_frac "
          f"{fracs}, largest relative deviation of loss/g2/sigma2 "
          f"{worst:.3e} (tolerance {ROUND_RTOL}), entries above "
          f"{ROUND_ATOL}: at most {flips} of {total} (allowed {allowed})")
    if fracs != [-1, 1.0, -1, 0.5]:
        fail(f"stale_frac {fracs}, expected [-, 1.0, -, 0.5]")
    if not (worst <= ROUND_RTOL and flips <= allowed):
        fail("the off-mesh overlap round on the card disagrees with the CPU")
    # the smoke mamba2's fused branch, every cluster stale (the side
    # stream on the card)
    mcfg, mh, _, policy, mtheta, levels = sparse_setup(
        configs, base, compression, policies, full=False)
    mh = dataclasses.replace(mh, wire_ef=False, overlap=True, staleness=1)
    mparams = mamba2.init(mcfg, torch.Generator().manual_seed(22),
                          device="cpu")
    mtokens = [torch.from_numpy(rng.integers(0, mcfg.vocab_size, (16, 40)))
               for _ in range(OVERLAP_ROUNDS)]
    wp.reset_launches()
    worst, flips, total, fracs = _overlap_lockstep(
        rnd_mod, mcfg, mh, topo, mparams, mtokens, rho, mtheta,
        lambda r: rnd_mod.make_overlap_round_step(
            mcfg, mh, topo, policy, gossip=(r + 1) % SPARSE_Q == 0,
            cluster_levels=levels if (r + 1) % SPARSE_Q == 0 else None), 31)
    launches = dict(wp.LAUNCHES)
    allowed = int(Q_FLIP_SHARE * total)
    print(f"mamba2 small overlap round (fused, int4 levels {levels}, every "
          f"cluster stale, lockstep): card vs CPU over {OVERLAP_ROUNDS} "
          f"rounds, stale_frac {fracs}, largest relative deviation of "
          f"loss/g2/sigma2 {worst:.3e} (tolerance {ROUND_RTOL}), entries "
          f"above {ROUND_ATOL}: at most {flips} of {total} (allowed "
          f"{allowed}); wire launches on the card {launches}")
    if fracs != [-1, 1.0, -1, 1.0]:
        fail(f"stale_frac {fracs}, expected [-, 1.0, -, 1.0]")
    if not (worst <= ROUND_RTOL and flips <= allowed):
        fail("the fused overlap round on the card disagrees with the CPU")
    if not (launches["wire_encode"] and launches["wire_decode_mix"]):
        fail(f"the fused overlap round ran no wire kernels: {launches}")
    # on the card: staleness 0 and an empty stale set are the synchronous
    # step, pending included
    same = []
    for c, h, p, pol, th, lv in (
            (cfg, hcef, params0, None, theta, None),
            (mcfg, mh, mparams, policy, mtheta, levels)):
        sync_h = dataclasses.replace(h, overlap=False, staleness=0)
        tok = tokens[0] if pol is None else mtokens[0]
        ref = rnd_mod.init_state(c, sync_h, topo, p, device="cuda")
        ref, _ = rnd_mod.make_round_step(c, sync_h, topo, pol, gossip=True,
                                         cluster_levels=lv)(
            ref, {"tokens": tok}, rho, th, 5)
        for hh, stale in ((dataclasses.replace(h, staleness=0), None),
                          (h, ())):
            st = rnd_mod.init_overlap_state(c, hh, topo, p, device="cuda")
            st, _ = rnd_mod.make_overlap_round_step(
                c, hh, topo, pol, gossip=True, cluster_levels=lv,
                stale_clusters=stale)(st, {"tokens": tok}, rho, th, 5)
            got = _leaves_of(st, ("params", "ef", "momentum"))
            want = {f + "/" + k: v.cpu() for f in ("params", "ef",
                                                   "momentum")
                    for k, v in flatten(getattr(ref, f)).items()}
            ok = all(torch.equal(_bits(got[k]), _bits(v))
                     for k, v in want.items()) and all(
                torch.equal(_bits(got["pending/" + k[7:]]), _bits(v))
                for k, v in want.items() if k.startswith("params/"))
            same.append(ok)
    print(f"on the card: staleness 0 and an empty stale set give the "
          f"synchronous step's bits, pending included (smollm off the mesh,"
          f" mamba2 fused): {same}")
    if not all(same):
        fail("a synchronous-like overlap step differs from the synchronous "
             "step on the card")
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return launches


def _payload_bytes(pre):
    return sum(t.numel() * t.element_size() for chunks in pre.values()
               for chunk in chunks for payload, _ in chunk
               for t in payload if t is not None)


def lm_overlap_fused(configs, lm, rnd_mod, base, compression, policies, wf,
                     train, synthetic, wp, fa, tk, col, topk_per_round):
    """Phase 23, the fused branch: smollm-135M at full width, int4 at
    levels (0.1, 0.6), q = 2, OVERLAP_ROUNDS rounds, every cluster stale,
    run by the overlap step and by the synchronous step from the same
    state, tokens and controls; finite losses, launch counts, p50, peak,
    and the overlap verdict on CUDA events in every gossip round."""
    import dataclasses
    from repro_torch.tree import flatten
    bundle = configs.get_config("smollm_135m")
    cfg = bundle.model
    hcef = dataclasses.replace(bundle.hcef, q=SPARSE_Q, sparse_gossip=True,
                               wire_dtype="int4", overlap=True, staleness=1)
    topo = base.FLTopology(2, 2)
    R, C = topo.num_devices, topo.clusters
    theta = compression.quantize_theta(SPARSE_THETA, hcef.theta_levels)
    levels = compression.cluster_levels_from_theta(
        SPARSE_THETA, hcef.theta_levels, np.repeat(np.arange(C), 2))
    if levels != GOSSIP_LEVELS:
        fail(f"cluster levels {levels}, expected {GOSSIP_LEVELS}")
    policy = policies.make_train_policy(topo)
    corpus = synthetic.synthetic_tokens(cfg.vocab_size, n_seq=train.N_SEQ,
                                        seq_len=2048, n_devices=R, beta=0.5)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(OVERLAP_ROUNDS):
        idx = rng.integers(0, train.N_SEQ, (R, hcef.tau * 2))
        batches.append(torch.from_numpy(np.concatenate(
            [corpus[d, idx[d]] for d in range(R)])))
    rho = np.ones(R)
    out = {}
    for prog in ("overlap", "sync"):
        h = hcef if prog == "overlap" else dataclasses.replace(
            hcef, overlap=False, staleness=0)
        torch.cuda.empty_cache()
        params0 = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
        init = (rnd_mod.init_overlap_state if prog == "overlap"
                else rnd_mod.init_state)
        state = init(cfg, h, topo, params0, device="cuda")
        del params0
        make = (rnd_mod.make_overlap_round_step if prog == "overlap"
                else rnd_mod.make_round_step)
        steps = {g: make(cfg, h, topo, policy, gossip=g,
                         cluster_levels=levels if g else None)
                 for g in (False, True)}
        sizes = [v[0].numel() for v in flatten(
            (state.fl if prog == "overlap" else state).params).values()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in (wp, fa, tk):
            mod.reset_launches()
        hist, walls, timings, verdict = [], [], {}, []
        for rnd in range(OVERLAP_ROUNDS):
            gossip = (rnd + 1) % SPARSE_Q == 0
            events = {}
            t0 = time.perf_counter()
            state, m = steps[gossip](state, {"tokens": batches[rnd]}, rho,
                                     theta, 1000 + rnd, timings=timings,
                                     events=events)
            loss = float(m["loss"].mean())
            walls.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            hist.append(dict(loss=loss, gossip=gossip))
            if gossip:
                end = events["device_round_end"]
                if prog == "overlap":  # ms the encodes finished ahead
                    verdict.append(dict(
                        round=rnd, margin_ms=events["encode_end"]
                        .elapsed_time(end), encode_span_ms=events[
                            "encode_start"].elapsed_time(
                            events["encode_end"]),
                        gossip_ms=events["gossip_start"].elapsed_time(
                            events["gossip_end"])))
                else:  # ms after the device round the first encode came
                    verdict.append(dict(
                        round=rnd, lag_ms=end.elapsed_time(
                            events["gossip_start"]),
                        gossip_ms=events["gossip_start"].elapsed_time(
                            events["gossip_end"])))
            print(f"{prog} round {rnd} loss={loss:.4f} gossip={gossip} "
                  f"wall={walls[-1]:.0f}ms", flush=True)
        launches = dict(wp.LAUNCHES, **fa.LAUNCHES,
                        topk_compress=tk.LAUNCHES["topk_compress"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_gossip = sum(x["gossip"] for x in hist)
        per_round = predicted_wire_launches(
            sizes, levels, h.wire_block, wf, rnd_mod.gossip_cols(C),
            bands=1, clusters=C, mix_steps=wp.MIX_STEPS,
            mix_rows=wp.MIX_ROWS)
        steps_run = OVERLAP_ROUNDS * R * h.tau
        want = {k: v * n_gossip for k, v in per_round.items()}
        want.update(flash_attention=steps_run * cfg.num_layers * (
            2 if cfg.remat else 1),
            flash_attention_bwd=steps_run * cfg.num_layers,
            paged_decode_attention=0,
            topk_compress=OVERLAP_ROUNDS * topk_per_round)
        if not all(np.isfinite(x["loss"]) for x in hist):
            fail(f"{prog}: non-finite loss: {[x['loss'] for x in hist]}")
        if launches != want:
            fail(f"{prog}: launch counts {launches}, expected {want}")
        med = lambda v: float(np.percentile(v, 50))
        stats = dict(program=prog, rounds=OVERLAP_ROUNDS,
                     gossip_rounds=n_gossip, params=sum(sizes),
                     levels=levels, round_wall_ms_p50=med(walls),
                     round_wall_ms=walls,
                     phase_ms_p50={k: med(v) for k, v in timings.items()},
                     phase_ms=timings, verdict=verdict,
                     wire_launches_per_gossip_round=per_round,
                     launches=launches, loss=[x["loss"] for x in hist],
                     peak_mem_gb=peak)
        if prog == "overlap":
            kw = dict(clusters=C, dev=2, hkind=topo.backhaul,
                      wire_dtype=h.wire_dtype, wire_block=h.wire_block,
                      cluster_theta=levels,
                      chunk_cols=rnd_mod.gossip_cols(C))
            pend = flatten(state.pending)
            pre = {k: col.stale_payloads(p.view(R, -1), **kw)
                   for k, p in pend.items()}
            stats["stale_payload_bytes"] = _payload_bytes(pre)
            del pre
            stats["encode_all_ms"] = time_ms(lambda: [
                col.stale_payloads(p.view(R, -1), **kw)
                for p in pend.values()], iters=3, warmup=1)
            del pend
        print("smollm_overlap " + json.dumps(stats))
        if stats["round_wall_ms_p50"] > LM_ROUND_LIMIT_MS:
            fail(f"{prog}: round p50 {stats['round_wall_ms_p50']:.1f} ms "
                 f"over {LM_ROUND_LIMIT_MS} ms")
        if peak > PEAK_LIMIT_GB:
            fail(f"{prog}: peak {peak:.2f} GB over {PEAK_LIMIT_GB} GB")
        if len(verdict) != n_gossip or n_gossip != 2:
            fail(f"{prog}: {len(verdict)} verdicts for {n_gossip} gossip "
                 f"rounds")
        out[prog] = stats
        del state, steps
        torch.cuda.empty_cache()
    ov, sy = out["overlap"]["verdict"], out["sync"]["verdict"]
    print(f"overlap verdict on CUDA events: the side stream's last encode "
          f"ended {[round(v['margin_ms'], 3) for v in ov]} ms before the "
          f"main stream's device round; in the synchronous program the "
          f"first encode came {[round(v['lag_ms'], 3) for v in sy]} ms "
          f"after it; gossip phase {[round(v['gossip_ms'], 3) for v in ov]}"
          f" ms overlapped, {[round(v['gossip_ms'], 3) for v in sy]} ms "
          f"synchronous; stale payloads "
          f"{out['overlap']['stale_payload_bytes'] / 1e6:.1f} MB")
    if not (all(v["margin_ms"] > 0 for v in ov)
            and all(v["lag_ms"] > 0 for v in sy)):
        fail("the overlap verdict failed: the stale encodes did not finish "
             "inside the device round, or the synchronous encodes did not "
             "follow it")
    return {k: out["overlap"]["launches"][k] + out["sync"]["launches"][k]
            for k in out["sync"]["launches"]}


def lm_overlap_launcher(train, fa, tk, wp, wf, rnd_mod, topk_per_round):
    """Phase 23, the train launcher off the mesh: ``--overlap --staleness
    1 --stale-quantile LAUNCHER_STALE_QUANTILE`` on smollm-135M at full
    width, LM_ROUNDS rounds: the gossip round's stale set
    LAUNCHER_STALE_SET, phase 16's launch counts, one decode-and-mix (dense
    payloads) a leaf and chunk of the stale fold, p50 and peak."""
    from repro_torch.tree import flatten
    argv = ["--arch", "smollm_135m", "--full", "--rounds", str(LM_ROUNDS),
            "--seq", "2047", "--overlap", "--staleness", "1",
            "--stale-quantile", str(LAUNCHER_STALE_QUANTILE)]
    print("python -m repro_torch.launch.train " + " ".join(argv))
    torch.cuda.empty_cache()
    for mod in (fa, tk, wp):
        mod.reset_launches()
    out = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"])
    wire = dict(wp.LAUNCHES)
    cfg, hist = out["cfg"], out["history"]
    tau, R = 4, 4
    steps = LM_ROUNDS * R * tau
    want = {"flash_attention": steps * cfg.num_layers * (2 if cfg.remat
                                                         else 1),
            "flash_attention_bwd": steps * cfg.num_layers,
            "paged_decode_attention": 0,
            "topk_compress": LM_ROUNDS * topk_per_round}
    cols = rnd_mod.gossip_cols(2)
    sizes = [v[0].numel() for v in flatten(out["state"].fl.params).values()]
    chunks = sum(-(-L // max(wf.wire_block_of(L, 1024),
                             cols // wf.wire_block_of(L, 1024)
                             * wf.wire_block_of(L, 1024))) for L in sizes)
    want_wire = {"wire_encode": 0, "wire_pack": 0, "wire_unpack": 0,
                 "wire_decode_mix": chunks}
    stale = [h.get("stale") for h in hist]
    if len(hist) != LM_ROUNDS or not all(np.isfinite(h["loss"])
                                         for h in hist):
        fail(f"the overlap launcher: losses {[h['loss'] for h in hist]}")
    if stale != [None] * (LM_ROUNDS - 1) + [LAUNCHER_STALE_SET]:
        fail(f"stale sets {stale}, expected {LAUNCHER_STALE_SET} in the "
             f"gossip round only")
    if launches != want or wire != want_wire:
        fail(f"launch counts {launches} and {wire}, expected {want} and "
             f"{want_wire}")
    med = lambda v: float(np.percentile(v, 50))
    p50 = med(out["round_ms"])
    stats = dict(rounds=LM_ROUNDS, params=out["n_params"], stale=stale,
                 round_wall_ms_p50=p50, round_wall_ms=out["round_ms"],
                 round_limit_ms=LM_ROUND_LIMIT_MS,
                 phase_ms_p50={k: med(v) for k, v in out["timings"].items()},
                 phase_ms=out["timings"],
                 launches_per_round={k: v / LM_ROUNDS
                                     for k, v in launches.items()},
                 wire_launches=wire, loss=[h["loss"] for h in hist],
                 time_s=hist[-1]["time"], peak_mem_gb=out["peak_mem_gb"],
                 peak_limit_gb=PEAK_LIMIT_GB)
    print("smollm_overlap_launcher " + json.dumps(stats))
    print(f"smollm overlap launcher round p50 {p50:.1f} ms against "
          f"{LM_ROUND_LIMIT_MS} ms; peak {out['peak_mem_gb']:.2f} GB against"
          f" {PEAK_LIMIT_GB} GB")
    if p50 > LM_ROUND_LIMIT_MS:
        fail(f"round p50 {p50:.1f} ms over {LM_ROUND_LIMIT_MS} ms")
    if out["peak_mem_gb"] > PEAK_LIMIT_GB:
        fail(f"peak {out['peak_mem_gb']:.2f} GB over {PEAK_LIMIT_GB} GB")
    return launches, wire


# ---------------------------------------------------------------------------
# phases 24-26: the MoE family (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------

MOE_ARCH = "granite_moe_1b_a400m"
MOE_LAYER = dict(B=2, S=2048)  # phase 24: granite's training layer
TPOT_LIMIT_MS = 50.0  # phase 26: >= 20 tokens/s a request (phase 4's limit)


def moe_layer_phase(configs, lm):
    """Phase 24's layer: ``lm._moe_ffn`` at granite-moe-1b-a400m's
    training shape (B 2, S 2048, d_model 1024, 32 experts of width 512,
    top 8, bf16; weights of a seeded ``init``), forward and backward twice
    on the same inputs: the same bits (the routing is a stable sort, the
    dispatch's gradients gathers summed in k order), finite; its card ms
    forward and backward (CUDA events, L2 flushed) beside the expert
    GEMMs' bound, and the share of assignments capacity dropped."""
    cfg = configs.get_config(MOE_ARCH).model
    B, S = MOE_LAYER["B"], MOE_LAYER["S"]
    gen = torch.Generator(device="cuda").manual_seed(24)
    layer = lm.init(cfg.replace(num_layers=1), gen, device="cuda")["layers"]
    w = {k: layer[k][0].detach().requires_grad_()
         for k in ("router", "we_gate", "we_up", "we_down")}
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    dy = 1e-2 * torch.randn(x.shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
    inputs = [x] + list(w.values())

    def fwd_bwd():
        y = lm._moe_ffn(cfg, x, w)
        return [y] + list(torch.autograd.grad(y, inputs, dy))

    a, b = fwd_bwd(), fwd_bwd()
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in a):
        fail("non-finite MoE layer output or gradient")
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    route = lm._moe_route(cfg, x.detach(), w["router"])
    kept = int(route.ok.sum())
    A = B * S * cfg.experts_per_token
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    rows = E * B * route.cap  # the expert GEMMs' padded rows
    gemm_flops = 3 * 2 * rows * D * F  # gate, up, down
    fwd_ms = time_ms(lambda: lm._moe_ffn(cfg, x, w), iters=10)
    y = lm._moe_ffn(cfg, x, w)
    bwd_ms = time_ms(lambda: torch.autograd.grad(y, inputs, dy,
                                                 retain_graph=True), iters=10)
    stats = dict(B=B, S=S, d_model=D, experts=E, top_k=cfg.experts_per_token,
                 d_ff=F, cap=route.cap, assignments=A, kept=kept,
                 dropped_share=1 - kept / A, padded_rows=rows,
                 same_bits_twice=same, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                 gemm_fwd_bound_ms=bound(gemm_flops, 0, torch.bfloat16)[0],
                 gemm_bwd_bound_ms=bound(2 * gemm_flops, 0,
                                         torch.bfloat16)[0])
    print("moe_layer " + json.dumps(stats))
    if not same:
        fail("the MoE layer's forward and backward differ between two runs "
             "on the same inputs")


def decode_graphs_agree(lm, fa, cfg):
    """Phases 4 and 26's check of ``lm.DecodeGraphs``: three decode steps
    of ``cfg`` at full width with 2 layers (8 slots, ragged lengths, one
    empty), with each layer's work but the pool's read and write replayed
    as CUDA graphs and run eagerly, from the same cache: logits and the written pages within the
    bf16 tolerance (the same bits printed), and the paged decode kernel
    launched eagerly, once a layer and step, in both."""
    cfg = cfg.replace(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(26)
    params = lm.init(cfg, gen, device="cuda")
    params = dict(params, layers=lm.layer_list(params))
    B, P = SLOTS, 8
    cache0 = lm.init_paged_cache(cfg, 1 + B * P, PAGE, device="cuda")
    for t in cache0.values():
        t.normal_(generator=gen)
    table = torch.arange(1, 1 + B * P, dtype=torch.int32,
                         device="cuda").view(B, P)
    kv_len = torch.tensor([3, 17, 40, 64, 90, 100, 111, 0],
                          dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           device="cuda")
    runs = {}
    for mode, graphs in (("eager", None), ("graphs", lm.DecodeGraphs())):
        cache = {k: v.clone() for k, v in cache0.items()}
        fa.reset_launches()
        with torch.inference_mode():
            logits = [lm.decode_step_paged(cfg, params, cache, tokens, table,
                                           kv_len + i, graphs=graphs)[0]
                      for i in range(3)]
        torch.cuda.synchronize()
        runs[mode] = (torch.stack(logits), cache,
                      fa.LAUNCHES["paged_decode_attention"])
    (le, ce, ne), (lg, cg, ng) = runs["eager"], runs["graphs"]
    err, ok = max_err(lg, le, dict(atol=2e-2, rtol=2e-2))
    same = torch.equal(lg, le) and all(torch.equal(cg[k], ce[k])
                                       for k in ce)
    print(f"decode graphs: {cfg.name} 2 layers, 3 steps: max |logit diff| "
          f"{err:.3e}, the same bits {same}; paged decode launches "
          f"{ng} with graphs, {ne} eager")
    if not (ok and all(torch.allclose(cg[k].float(), ce[k].float(),
                                      atol=2e-2, rtol=2e-2) for k in ce)):
        fail("the decode step with CUDA graphs disagrees with the eager one")
    if not ng == ne == 3 * cfg.num_layers:
        fail(f"paged decode launches {ng} / {ne}, expected "
             f"{3 * cfg.num_layers}")


def moe_profile(configs, lm, rnd_mod, profiling):
    """Phase 25's trace: one local step of granite's round at full width
    (what ``device_round`` does for a device tau times a round: forward
    and backward under remat over the per-layer leaves, the gradients'
    norm, the in-place SGD update with f32 momentum; B 2, S 2048),
    traced with the launchers' ``--profile`` (CPU and CUDA activity):
    the device's busy share and its kernels by time.  One step, not a
    round: a traced round's 220k device events take the profiler about
    two minutes to read."""
    from repro_torch.optim.sgd import sgd_update_
    cfg = configs.get_config(MOE_ARCH).model
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(25)
    leaves, rebuild = rnd_mod._per_layer(lm.init(cfg, gen, device="cuda"))
    moms = [torch.zeros(v.shape, dtype=torch.float32, device="cuda")
            for v in leaves]
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda")

    def step():
        ps = [v.detach().requires_grad_() for v in leaves]
        loss = lm.loss_fn(cfg, rebuild(ps), {"tokens": tokens})
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            gn2 = sum(torch.sum(torch.square(g.float())) for g in grads)
        sgd_update_(ps, grads, moms, lr=0.05, momentum=0.9)
        return loss, gn2

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / 3
    with torch.profiler.profile(
            activities=profiling.activities(torch.device("cuda"))) as prof:
        t0 = time.perf_counter()
        loss, gn2 = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not (torch.isfinite(loss) and torch.isfinite(gn2)):
        fail("non-finite loss or gradient in granite's traced step")
    busy = profiling.busy_ms(profiling.device_events(prof.events())[0])
    print(f"granite local step: {untraced * 1e3:.1f} ms untraced, "
          f"{wall * 1e3:.1f} ms traced; the device busy {busy:.1f} ms, "
          f"{busy / 1e3 / untraced:.3f} of the untraced step")
    profiling.print_profile(prof, wall)


# ---------------------------------------------------------------------------
# phases 27 and 28: the hybrid family (griffin)
# ---------------------------------------------------------------------------

GRIFFIN_ARCH = "recurrentgemma_9b"
GRIFFIN_SMALL_LAYERS = (3, 5)  # one group; and two trailing rglru blocks
GRIFFIN_SMALL_ROUNDS = 2       # the second gossips
RGLRU_LAYER = dict(B=1, S=4096, W=4096)  # recurrentgemma-9b's, one step
# phase 28: full width at depth 5 (one rglru, rglru, attn group and the two
# trailing rglru blocks, as the 38-layer model ends), R = 2 in 2 clusters
# x 1 device, tau = q = 4, one sequence of 4096 tokens a step
GRIFFIN_DEPTH = 5
GRIFFIN_TOPO = (2, 1)
GRIFFIN_ROUNDS = 4
GRIFFIN_SEQ = 4096
GRIFFIN_PARAMS = 2_174_889_984  # 4 x 234,913,792 + 186,654,720 + emb
# phases 29-31: internvl2-2b's ViT-stub frontend and seamless-m4t-large-v2's
# encoder and cross-attention
MULTIMODAL_ARCHS = ("internvl2_2b", "seamless_m4t_large_v2")
MULTIMODAL_SMALL_ROUNDS = 2  # the second gossips
# phases 30-31: full width and depth at R = 2 in 2 clusters x 1 device (a
# replica's state is about 8 bytes a parameter: four replicas of either
# would pass PEAK_LIMIT_GB), tau = q = 4, 2 x 2048 tokens a step (phase
# 16's shape: the launcher's --seq 2047)
MULTIMODAL_TOPO = (2, 1)
MULTIMODAL_ROUNDS = 4
MULTIMODAL_SEQ = 2047
INTERNVL_PARAMS = 1_889_634_304
SEAMLESS_PARAMS = 2_034_886_656
# the first round's mean loss within this of ln(vocab): weights N(0, 0.02^2)
# give logits of about 0.02 sqrt(d_model) a column
LOSS0_TOL = 1.0


def rglru_layer(ops):
    """The RG-LRU scan (``ops.rglru``: plain PyTorch, the reference has no
    kernel for it) at recurrentgemma-9b's width, one step's inputs (f32,
    as the gates give them): against the sequential oracle, then its
    forward and its backward timed with CUDA events after an L2 flush,
    beside the bound of the bytes they must move."""
    B, S, W = RGLRU_LAYER["B"], RGLRU_LAYER["S"], RGLRU_LAYER["W"]
    gen = torch.Generator(device="cuda").manual_seed(27)
    log_a = -0.1 * torch.rand((B, S, W), generator=gen, device="cuda")
    gated = torch.randn((B, S, W), generator=gen, device="cuda")
    dhs = torch.randn((B, S, W), generator=gen, device="cuda")
    hs, h_last = ops.rglru(log_a, gated)
    want, want_last = ops.rglru(log_a, gated, impl="ref")
    err = max(float((hs - want).abs().max()),
              float((h_last - want_last).abs().max()))
    scale = float(want.abs().max())
    fwd_ms = time_ms(lambda: ops.rglru(log_a, gated))
    la, gx = (t.clone().requires_grad_() for t in (log_a, gated))
    out, _ = ops.rglru(la, gx)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (la, gx), dhs,
                                                 retain_graph=True))
    n = B * S * W * 4
    row = dict(B=B, S=S, W=W, dtype="float32", route="plain (log-depth "
               "scan)", levels=int(np.ceil(np.log2(S))), max_abs_err=err,
               err_of_max=err / scale, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               # log_a and gated in, hs out; the backward also dhs in and
               # two gradients out
               fwd_bound_ms=bound(0, 3 * n, torch.float32)[0],
               bwd_bound_ms=bound(0, 5 * n, torch.float32)[0])
    print("rglru_layer " + json.dumps(row))
    if not err <= F32_TOL["atol"] + F32_TOL["rtol"] * scale:
        fail(f"the RG-LRU scan disagrees with its sequential oracle: {row}")
    del la, gx, out
    torch.cuda.empty_cache()


def griffin_small(configs, lm, rnd_mod, base, fa, ops):
    """Phase 27: the smoke recurrentgemma-9b's round step, card against
    CPU (``small_lm_round_agrees`` at 3 and 5 layers,
    GRIFFIN_SMALL_ROUNDS rounds in lockstep: the f32 attention kernels on
    the card, the plain versions under autograd on the CPU; the
    parameters within ROUND_ATOL but for Q_FLIP_SHARE top-k threshold
    flips: at 5 layers a 1e-7 relative perturbation of the initial
    weights moves 4 entries of a w_down by 1.8e-4 on the CPU alone), then
    ``rglru_layer``."""
    for layers in GRIFFIN_SMALL_LAYERS:
        small_lm_round_agrees(configs, lm, rnd_mod, base, fa,
                              arch=GRIFFIN_ARCH, rounds=GRIFFIN_SMALL_ROUNDS,
                              num_layers=layers, lockstep=True,
                              flip_share=Q_FLIP_SHARE)
    rglru_layer(ops)


@contextlib.contextmanager
def counted_calls(module, name, counts):
    """Counts the calls of ``module.name`` into counts[name] while open."""
    fn = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)
    setattr(module, name, counted)
    try:
        yield counts
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def synced_calls(module, name, ms):
    """Times each call of ``module.name`` between two synchronisations of
    the card, adding its ms to ms[name], while open."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    setattr(module, name, timed)
    try:
        yield ms
    finally:
        setattr(module, name, fn)


def full_width_rounds(name, cfg, hcef, topo, *, rounds, seq, seqs_per_step,
                      n_params_want, rnd_mod, train, synthetic, fa, tk):
    """``rounds`` rounds of ``cfg`` (full width) through
    ``make_round_step``, driven as the train launcher drives its rounds
    (the HCEF controller, the device-skewed corpus and its numpy stream,
    the frontend stand-ins of ``train.frontend_stand_ins``, the Eq. 8/9
    time and energy accounting) at ``topo`` with ``seqs_per_step``
    sequences of ``seq + 1`` tokens a step.  Every attention launch
    (forward and backward, the non-causal ones apart, and with an encoder
    the cross-attention's forwards by their calls) and every top-k launch
    counted; losses finite, gossip in the last round only, round p50 and
    peak gated.  Returns (launches, stats)."""
    from repro_torch.core.controller import BudgetState
    from repro_torch.fl.baselines import make_controller
    from repro_torch.fl.cost_model import round_energy, round_time
    from repro_torch.fl.heterogeneity import HeterogeneityModel
    from repro_torch.models import lm
    from repro_torch.models.registry import get_model
    from repro_torch.tree import flatten
    R = topo.num_devices
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params0 = get_model(cfg).init(cfg, gen, device="cuda")
    n_params = sum(v.numel() for v in flatten(params0).values())
    if n_params != n_params_want:
        fail(f"{cfg.name} at {cfg.num_layers} layers: {n_params} "
             f"parameters, expected {n_params_want}")
    state = rnd_mod.init_state(cfg, hcef, topo, params0, device="cuda")
    del params0
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    topk_per_round = topk_launches(list(flatten(state.params).values()),
                                   list(flatten(state.ef).values()), tk)
    print(f"{name} full width: {cfg.num_layers} layers"
          f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
          f", {n_params} params, R={R} ({topo.clusters} x "
          f"{topo.devices_per_cluster}), state {state_gb:.2f} GB, "
          f"{topk_per_round} top-k launches a round, set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    steps = {g: rnd_mod.make_round_step(cfg, hcef, topo, gossip=g)
             for g in (False, True)}
    controller = make_controller("hcef", hcef.tau, theta_min=hcef.theta_min,
                                 rho_min=hcef.rho_min)
    het = HeterogeneityModel(num_devices=R, model_bits=n_params * 16)
    budget = BudgetState(time_budget=hcef.time_budget or np.inf,
                         energy_budget=hcef.energy_budget or np.inf,
                         phi=max(rounds // hcef.q, 1), q=hcef.q,
                         backhaul_time=het.backhaul_time())
    cluster_of = np.repeat(np.arange(topo.clusters),
                           topo.devices_per_cluster)
    corpus = synthetic.synthetic_tokens(cfg.vocab_size, n_seq=train.N_SEQ,
                                        seq_len=seq + 1, n_devices=R,
                                        beta=0.5)
    rng = np.random.default_rng(0)
    b_per_dev = hcef.tau * seqs_per_step
    stand_ins = train.frontend_stand_ins(cfg, R * b_per_dev, seq + 1,
                                         seed=0)
    fa.reset_launches()
    tk.reset_launches()
    hist, walls, timings, calls = [], [], {}, {}
    with counted_calls(lm, "_cross_attention", calls):
        for rnd in range(rounds):
            t0 = time.perf_counter()
            reports = het.sample_round(rnd)
            rho, theta = controller.controls(reports, budget)
            gossip = (rnd + 1) % hcef.q == 0
            idx = rng.integers(0, train.N_SEQ, (R, b_per_dev))
            tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
            state, m = steps[gossip](
                state, {"tokens": torch.from_numpy(tokens), **stand_ins()},
                rho, theta, 1000 + rnd, timings=timings)
            t, _ = round_time(rho, theta, reports.mu, reports.nu, hcef.tau,
                              cluster_of, gossip=gossip,
                              backhaul=het.backhaul_time())
            e = round_energy(rho, theta, reports.mu, reports.nu,
                             reports.alpha, reports.p, hcef.tau)
            budget.charge(t, e, gossip)
            loss = float(m["loss"].mean())
            walls.append((time.perf_counter() - t0) * 1e3)
            hist.append(dict(loss=loss, gossip=gossip,
                             rho_mean=float(np.mean(rho)),
                             theta_mean=float(np.mean(theta)),
                             time=budget.time_spent_prev
                             + budget.time_spent_this))
            print(f"round {rnd} loss={loss:.4f} "
                  f"rho={hist[-1]['rho_mean']:.2f} "
                  f"theta={hist[-1]['theta_mean']:.2f} gossip={gossip} "
                  f"wall={walls[-1]:.0f}ms", flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"],
                    noncausal_fwd=fa.NONCAUSAL["flash_attention"],
                    noncausal_bwd=fa.NONCAUSAL["flash_attention_bwd"],
                    cross_fwd=calls.get("_cross_attention", 0))
    local_steps = rounds * R * hcef.tau
    remat = 2 if cfg.remat else 1
    n_attn, n_nc = attention_layers(cfg), noncausal_layers(cfg)
    want = {"flash_attention": local_steps * n_attn * remat,
            "flash_attention_bwd": local_steps * n_attn,
            "paged_decode_attention": 0,
            "topk_compress": rounds * topk_per_round,
            "noncausal_fwd": local_steps * n_nc * remat,
            "noncausal_bwd": local_steps * n_nc,
            "cross_fwd": (local_steps * cfg.num_layers * remat
                          if cfg.cross_attention else 0)}
    med = lambda v: float(np.percentile(v, 50))  # noqa: E731
    p50 = med(walls)
    per_round = {k: v / rounds for k, v in launches.items()}
    stats = dict(rounds=rounds, layers=cfg.num_layers,
                 enc_layers=cfg.enc_layers, attention_layers=n_attn,
                 d_model=cfg.d_model, lru_width=cfg.lru_width,
                 heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                 head_dim=cfg.head_dim, window=cfg.window,
                 vocab=cfg.vocab_size, frontend=cfg.frontend,
                 params=n_params, replicas=R,
                 tokens_per_step=seqs_per_step * (seq + 1),
                 state_gb=state_gb, round_wall_ms_p50=p50,
                 round_wall_ms=walls, round_limit_ms=LM_ROUND_LIMIT_MS,
                 phase_ms_p50={k: med(v) for k, v in timings.items()},
                 phase_ms=timings, launches_per_round=per_round,
                 attention_per_local_step={
                     "causal_self_fwd": (launches["flash_attention"]
                                         - launches["noncausal_fwd"])
                     / local_steps,
                     "encoder_fwd": (launches["noncausal_fwd"]
                                     - launches["cross_fwd"]) / local_steps,
                     "cross_fwd": launches["cross_fwd"] / local_steps,
                     "causal_bwd": (launches["flash_attention_bwd"]
                                    - launches["noncausal_bwd"])
                     / local_steps,
                     "noncausal_bwd": launches["noncausal_bwd"]
                     / local_steps},
                 loss=[h["loss"] for h in hist],
                 rho_mean=[h["rho_mean"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 time_s=hist[-1]["time"], peak_mem_gb=peak,
                 peak_limit_gb=PEAK_LIMIT_GB)
    print(f"{name} " + json.dumps(stats))
    TRAIN_CELLS[name] = dict(cfg=cfg, replicas=R, tau=hcef.tau,
                             seqs_per_step=seqs_per_step, positions=seq + 1,
                             params=n_params, p50_ms=p50, peak_gb=peak)
    print(f"{name} round p50 {p50:.1f} ms against {LM_ROUND_LIMIT_MS} ms "
          f"({'met' if p50 <= LM_ROUND_LIMIT_MS else 'missed'}); peak "
          f"{peak:.2f} GB against {PEAK_LIMIT_GB} GB")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if not hist[-1]["gossip"] or any(h["gossip"] for h in hist[:-1]):
        fail("expected gossip in the last round only")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    if peak > PEAK_LIMIT_GB:
        fail(f"peak {peak:.2f} GB over {PEAK_LIMIT_GB} GB")
    if p50 > LM_ROUND_LIMIT_MS:
        fail(f"{name} round p50 {p50:.1f} ms over {LM_ROUND_LIMIT_MS} ms")
    del state, steps
    torch.cuda.empty_cache()
    return launches, stats


def griffin_full(configs, rnd_mod, base, train, synthetic, fa, tk):
    """Phase 28: recurrentgemma-9b at full width (bf16, f32 momentum,
    remat) and depth GRIFFIN_DEPTH through ``full_width_rounds`` at R = 2
    (GRIFFIN_TOPO) and one sequence of GRIFFIN_SEQ tokens a step: at
    about 10 bytes a parameter a replica, four replicas would not fit.
    Then the launcher's smoke entry point."""
    bundle = configs.get_config(GRIFFIN_ARCH)
    cfg = bundle.model.replace(num_layers=GRIFFIN_DEPTH)
    hcef = dataclasses.replace(bundle.hcef, tau=4, q=4)
    launches, _ = full_width_rounds(
        "griffin", cfg, hcef, base.FLTopology(*GRIFFIN_TOPO),
        rounds=GRIFFIN_ROUNDS, seq=GRIFFIN_SEQ, seqs_per_step=1,
        n_params_want=GRIFFIN_PARAMS, rnd_mod=rnd_mod, train=train,
        synthetic=synthetic, fa=fa, tk=tk)

    # the launcher's entry point on the smoke griffin (f32 kernels)
    launcher_smoke(train, fa, GRIFFIN_ARCH, bundle.hcef.tau)
    return launches


def launcher_smoke(train, fa, arch, tau):
    """The train launcher's entry point on ``arch``'s smoke model for 2
    rounds on the card (the f32 attention kernels): finite losses, the
    attention launches (no remat), the non-causal ones apart."""
    argv = ["--arch", arch, "--rounds", "2"]
    print("python -m repro_torch.launch.train " + " ".join(argv))
    fa.reset_launches()
    out = train.main(argv)
    torch.cuda.synchronize()
    smoke = out["cfg"]
    steps = 2 * 4 * tau  # 2 rounds, R = 4
    runs = steps * attention_layers(smoke)
    want = {"flash_attention": runs * (2 if smoke.remat else 1),
            "flash_attention_bwd": runs, "paged_decode_attention": 0}
    nc = steps * noncausal_layers(smoke)
    want_nc = {"flash_attention": nc * (2 if smoke.remat else 1),
               "flash_attention_bwd": nc}
    print(f"the launcher's smoke {arch}: losses "
          f"{[h['loss'] for h in out['history']]}, attention launches "
          f"{dict(fa.LAUNCHES)}, non-causal {dict(fa.NONCAUSAL)}")
    if len(out["history"]) != 2 or not all(
            np.isfinite(h["loss"]) for h in out["history"]):
        fail(f"the launcher's smoke {arch}: {out['history']}")
    if dict(fa.LAUNCHES) != want or dict(fa.NONCAUSAL) != want_nc:
        fail(f"the launcher's smoke {arch}: attention launches "
             f"{dict(fa.LAUNCHES)}, non-causal {dict(fa.NONCAUSAL)}, "
             f"expected {want}, {want_nc}")


def multimodal_small(configs, lm, rnd_mod, base, fa, train):
    """Phase 29: the smoke internvl2-2b and seamless-m4t-large-v2, card
    against CPU (``small_lm_round_agrees``, MULTIMODAL_SMALL_ROUNDS rounds
    in lockstep, the parameters but for Q_FLIP_SHARE top-k threshold
    flips; seeded N(0, 1) patch embeddings and frames beside the tokens),
    then the launcher's entry point on both."""
    for arch in MULTIMODAL_ARCHS:
        small_lm_round_agrees(configs, lm, rnd_mod, base, fa, arch=arch,
                              rounds=MULTIMODAL_SMALL_ROUNDS, lockstep=True,
                              flip_share=Q_FLIP_SHARE)
    for arch in MULTIMODAL_ARCHS:
        launcher_smoke(train, fa, arch, configs.get_config(arch).hcef.tau)


def multimodal_full(arch, configs, rnd_mod, base, train, synthetic, fa, tk):
    """Phases 30 and 31: ``arch`` (internvl2-2b, seamless-m4t-large-v2) at
    full width and depth through ``full_width_rounds`` at R = 2
    (MULTIMODAL_TOPO), tau = q = 4, 2 x 2048 tokens a step with the
    launcher's stand-ins: ``full_width_rounds``'s gates, the parameter
    count exact, and the first round's loss within LOSS0_TOL of
    ln(vocab)."""
    bundle = configs.get_config(arch)
    cfg = bundle.model
    hcef = dataclasses.replace(bundle.hcef, tau=4, q=4)
    want = {"internvl2_2b": INTERNVL_PARAMS,
            "seamless_m4t_large_v2": SEAMLESS_PARAMS}[arch]
    launches, stats = full_width_rounds(
        arch.split("_")[0], cfg, hcef, base.FLTopology(*MULTIMODAL_TOPO),
        rounds=MULTIMODAL_ROUNDS, seq=MULTIMODAL_SEQ, seqs_per_step=2,
        n_params_want=want, rnd_mod=rnd_mod, train=train,
        synthetic=synthetic, fa=fa, tk=tk)
    ln_v = float(np.log(cfg.vocab_size))
    print(f"{arch}: first round's loss {stats['loss'][0]:.4f} against "
          f"ln(vocab) {ln_v:.4f}")
    if abs(stats["loss"][0] - ln_v) > LOSS0_TOL:
        fail(f"{arch}: first round's loss {stats['loss'][0]:.4f} not "
             f"within {LOSS0_TOL} of ln(vocab) {ln_v:.4f}")
    return launches


# ---------------------------------------------------------------------------
# phases 32-34: the static path (Engine.generate) of every family, the
# paged pool's int8 and contiguous modes
# ---------------------------------------------------------------------------

# phase 32: (arch, prompt length, cache positions) of the smoke configs;
# recurrentgemma-9b's window of 16 wraps in its 40-token prefill and its
# decode runs on past it
STATIC_SMALL = (("qwen2_7b", 24, 40), ("granite_moe_1b_a400m", 24, 40),
                ("mamba2_1p3b", 24, 40), ("recurrentgemma_9b", 40, 64),
                ("internvl2_2b", 24, 40), ("seamless_m4t_large_v2", 24, 40))
STATIC_SMALL_STEPS = 8
# greedy tokens of the two sides are compared until a row's top two CPU
# logits are closer than this (a near tie may break either way)
TOKEN_MARGIN = 1e-3
# phase 32's int8 pool in lockstep: the share of the written int8 entries
# one step apart (a value within f32 noise of a rounding boundary)
INT8_FLIP_SHARE = 1e-3
# leaves the generate check's weight scaling leaves alone (norms and the
# recurrent families' per-channel constants)
UNSCALED = ("ln", "norm", "A_log", "dt_bias", "D_skip", "log_lambda",
            "conv_b")
# phase 33: (arch, batch, prompt length); 64 new tokens each
STATIC_FULL = (("qwen2_7b", 8, 512), ("mamba2_1p3b", 8, 512),
               ("recurrentgemma_9b", 2, 3072), ("internvl2_2b", 8, 512),
               ("seamless_m4t_large_v2", 8, 512))
STATIC_NEW_TOKENS = 64
# phase 33's TTFT: the median of this many prefills at the timed shape
TTFT_SAMPLES = 3


def _to(tree, device, scale=1.0, path=""):
    """A nested dict of tensors on ``device``, every leaf but UNSCALED
    ones times ``scale``."""
    if isinstance(tree, dict):
        return {k: _to(v, device, scale, f"{path}/{k}")
                for k, v in tree.items()}
    keep = scale == 1.0 or any(u in path for u in UNSCALED)
    return tree.to(device) if keep else (tree * scale).to(device)


def static_launches(cfg, model):
    """{(call, kind): attention kernel launches} of one static prefill and
    one decode step of ``cfg`` (``model`` its module): causal
    self-attention (windowed in griffin), the encoder's non-causal
    self-attention and the non-causal cross-attention; the decode steps'
    self-attention is the plain ``ops.decode_attention`` (no kernel, as
    in the reference)."""
    if cfg.family == "ssm":
        return {}
    if cfg.family == "hybrid":
        return {("prefill", "causal"): model._layout(cfg)[-1]}
    out = {("prefill", "causal"): cfg.num_layers}
    if cfg.enc_layers:
        out.update({("prefill", "encoder"): cfg.enc_layers,
                    ("prefill", "cross"): cfg.num_layers,
                    ("decode", "cross"): cfg.num_layers})
    return out


class StaticRecorder:
    """Stands in for a model module under ``Engine.generate``: times each
    prefill and decode step to its logits (host clock after a
    synchronise), keeps a device flag per call that the logits are
    finite, the logits themselves on request, and the attention kernel
    launches of each call by kind (``fa.NONCAUSAL`` and the
    cross-attention's calls apart)."""

    def __init__(self, model, fa, keep_logits=False):
        self.model, self.fa = model, fa
        self.ms = {"prefill": [], "decode": []}
        self.finite, self.logits, self.calls = [], [], []
        self.keep_logits = keep_logits

    def init_cache(self, *a, **kw):
        return self.model.init_cache(*a, **kw)

    def _call(self, kind, fn, *a):
        fa = self.fa
        before = (fa.LAUNCHES["flash_attention"],
                  fa.NONCAUSAL["flash_attention"])
        cross = {}
        t0 = time.perf_counter()
        with counted_calls(sys.modules["repro_torch.models.lm"],
                           "_cross_attention", cross):
            logits, cache = fn(*a)
            torch.cuda.synchronize()
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.finite.append(torch.isfinite(logits).all())
        if self.keep_logits:
            self.logits.append(logits[:, -1].float().cpu())
        total = fa.LAUNCHES["flash_attention"] - before[0]
        noncausal = fa.NONCAUSAL["flash_attention"] - before[1]
        n_cross = cross.get("_cross_attention", 0)
        got = {"causal": total - noncausal,
               "encoder": noncausal - n_cross, "cross": n_cross}
        self.calls.append((kind, {k: v for k, v in got.items() if v}))
        return logits, cache

    def prefill(self, *a):
        return self._call("prefill", self.model.prefill, *a)

    def decode_step(self, *a):
        return self._call("decode", self.model.decode_step, *a)


def _static_inputs(cfg, B, S, seed):
    """Phase 32's seeded prompts and frontend stand-ins: N(0, 1) patch
    embeddings and N(0, 1) frames of the prompt's length (nonzero, so the
    card-vs-CPU check reads the patch path; phase 33 feeds the launcher's
    own, ``launch.serve.stand_ins``)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, S))
    extra = {}
    if cfg.frontend == "vit_stub":
        extra["patch_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        extra["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return prompts, extra


def _tokens_agree(ours, theirs, logits):
    """Rows of greedy tokens on two devices: equal until the first step
    whose reference logits (``logits``: one (B, V) a step) have their top
    two within TOKEN_MARGIN, where the rest of the row is not compared.
    Returns (agree, tokens compared)."""
    n = 0
    for r in range(ours.shape[0]):
        for t in range(ours.shape[1]):
            top2 = torch.topk(logits[t][r], 2).values
            if float(top2[0] - top2[1]) < TOKEN_MARGIN:
                break
            if ours[r, t] != theirs[r, t]:
                return False, n
            n += 1
    return True, n


def static_small(configs, registry, engine_mod, fa, card="cuda"):
    """Phase 32, the static path card against CPU in f32: each of
    STATIC_SMALL's smoke configs runs init_cache, prefill and
    STATIC_SMALL_STEPS decode steps on both, fed the CPU's greedy tokens:
    logits within 1e-4, the attention kernel launches of each call as
    ``static_launches`` says; then ``Engine.generate`` on both with the
    weights times 10, the greedy tokens equal where the margins allow."""
    for arch, S, max_len in STATIC_SMALL:
        cfg = configs.smoke_model(configs.get_config(arch).model)
        model = registry.get_model(cfg)
        params = model.init(cfg, seed=1, device="cpu")
        B = 3
        prompts, extra = _static_inputs(cfg, B, S, seed=1)
        batch = dict(tokens=prompts, **extra)
        enc = S if cfg.enc_layers else 0
        runs = {}
        for side, dev in (("cpu", "cpu"), ("card", card)):
            rec = StaticRecorder(model, fa, keep_logits=True)
            p = _to(params, dev)
            cache = rec.init_cache(cfg, B, max_len, enc_len=enc, device=dev)
            with torch.inference_mode():
                _, cache = rec.prefill(cfg, p, {
                    k: torch.as_tensor(v, device=dev)
                    for k, v in batch.items()}, cache)
                for step in range(STATIC_SMALL_STEPS):
                    tok = (runs["cpu"].logits[step] if side == "card"
                           else rec.logits[step]).argmax(-1)
                    _, cache = rec.decode_step(cfg, p, cache,
                                               tok[:, None].to(dev))
            runs[side] = rec
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(runs["cpu"].logits, runs["card"].logits))
        want = static_launches(cfg, model)
        calls = runs["card"].calls
        got_ok = all(c == {k[1]: v for k, v in want.items() if k[0] == kind}
                     for kind, c in calls)
        # Engine.generate, the weights times 10
        toks, taps = {}, {}
        for side, dev in (("cpu", "cpu"), ("card", card)):
            eng = engine_mod.Engine(
                cfg, _to(params, dev, 10.0), device=dev, max_len=max_len,
                batch_size=B, serve=engine_mod.ServeConfig(
                    max_new_tokens=STATIC_SMALL_STEPS))
            taps[side] = eng.model = StaticRecorder(model, fa,
                                                    keep_logits=True)
            toks[side] = eng.generate(prompts, extra_inputs=extra or None)
        agree, n = _tokens_agree(toks["card"], toks["cpu"],
                                 taps["cpu"].logits)
        print(f"static small {arch}: card vs CPU max |logit diff| "
              f"{diff:.3e} over 1 prefill + {STATIC_SMALL_STEPS} decode "
              f"steps; launches a call {calls[0][1]} / {calls[1][1]}; "
              f"generate's greedy tokens equal: {agree} ({n} of "
              f"{toks['cpu'].size} compared)")
        if not diff <= 1e-4:
            fail(f"{arch}: the static path on the card disagrees with the "
                 f"CPU")
        if not got_ok:
            fail(f"{arch}: attention launches {calls}, expected {want}")
        if not agree or n == 0:
            fail(f"{arch}: generate's greedy tokens differ on the card")


def _paged_lockstep(lm, cfg, params, kv_dtype, contiguous, card):
    """prefill_paged and STATIC_SMALL_STEPS decode_step_paged of ``cfg``
    card against CPU, the CPU's greedy tokens fed to both; before each
    decode step the card's pool is set to the CPU's (an int8 entry within
    f32 noise of a rounding boundary may round either way), so each step
    is held alone and a flip cannot carry into the next.  Returns (max
    |logit diff|, the largest share of int8 entries one step apart among
    the positions written below kv_len, the largest int8 step anywhere)."""
    rng = np.random.default_rng(5)
    B, S, ps, P = 3, 32, 8, 6
    NP = 1 + B * P
    table = (np.arange(1, NP) if contiguous
             else rng.permutation(np.arange(1, NP))).astype(np.int32)
    table = table.reshape(B, P)
    plen = np.array([5, 17, 32], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    state = {}
    for side, dev in (("cpu", "cpu"), ("card", card)):
        pool = lm.init_paged_cache(cfg, NP, ps, kv_dtype=kv_dtype, device=dev)
        p = _to(params, dev)
        with torch.inference_mode():
            logits, pool = lm.prefill_paged(
                cfg, p, {"tokens": torch.as_tensor(toks, device=dev)}, pool,
                torch.as_tensor(table, device=dev),
                torch.as_tensor(plen, device=dev))
        state[side] = [p, pool, [logits.cpu()], dev]
    kv_len = plen.copy()
    diff, share, step = 0.0, 0.0, 0
    for _ in range(STATIC_SMALL_STEPS + 1):
        cpu_pool, gpu_pool = state["cpu"][1], state["card"][1]
        written = torch.zeros((NP, ps), dtype=torch.bool)
        for b in range(B):
            pos = np.arange(kv_len[b])
            written[torch.as_tensor(table[b, pos // ps]).long(),
                    torch.as_tensor(pos % ps)] = True
        for name, t in cpu_pool.items():
            g = gpu_pool[name].cpu()
            if t.dtype == torch.int8:
                d = (g.int() - t.int()).abs()
                share = max(share, float(
                    (d[:, written] > 0).float().mean()))
                step = max(step, int(d.max()))
            else:
                diff = max(diff, float((g - t).abs().max()))
            gpu_pool[name].copy_(t)
        diff = max(diff, float((state["cpu"][2][-1]
                                - state["card"][2][-1]).abs().max()))
        if len(state["cpu"][2]) > STATIC_SMALL_STEPS:
            break
        tok = state["cpu"][2][-1][:, -1].argmax(-1)
        for p, pool, out, dev in state.values():
            with torch.inference_mode():
                logits, _ = lm.decode_step_paged(
                    cfg, p, pool, tok[:, None].to(dev),
                    torch.as_tensor(table, device=dev),
                    torch.as_tensor(kv_len, device=dev),
                    contiguous=contiguous)
            out.append(logits.cpu())
        kv_len += 1
    return diff, share, step


def paged_modes_small(configs, lm, fa, card="cuda"):
    """Phase 32's paged modes, card against CPU in f32 on the smoke
    qwen2-7b: the int8 pool (permuted table, ragged lengths) and the
    contiguous layout (identity table) in lockstep, logits and the pool's
    floats within 1e-4, int8 entries at most one step apart, in at most
    INT8_FLIP_SHARE of the written ones; neither launches the paged
    decode kernel (the reference's routing), the dense pool over the same
    table does."""
    cfg = configs.smoke_model(configs.get_config("qwen2_7b").model)
    params = lm.init(cfg, seed=2, device="cpu")
    for kv_dtype, contiguous in (("int8", False), (None, True),
                                 ("int8", True)):
        fa.reset_launches()
        diff, share, step = _paged_lockstep(lm, cfg, params, kv_dtype,
                                            contiguous, card)
        n = fa.LAUNCHES["paged_decode_attention"]
        print(f"paged small kv_dtype={kv_dtype} contiguous={contiguous}: "
              f"card vs CPU max diff {diff:.3e}, int8 entries a step apart "
              f"{share:.2e} (largest step {step}); paged decode kernel "
              f"launches {n}")
        if not (diff <= 1e-4 and share <= INT8_FLIP_SHARE and step <= 1):
            fail(f"the paged path (kv_dtype {kv_dtype}, contiguous "
                 f"{contiguous}) on the card disagrees with the CPU")
        if n:
            fail(f"the paged decode kernel ran {n} times in a mode the "
                 f"reference routes to the gather")


def prefill_parts(cfg, ops, ref):
    """(module, function) pairs phase 33 times inside ``cfg``'s prefill:
    mamba2's chunked scan (``ref.ssd_chunked``, plain PyTorch), griffin's
    RG-LRU (``ops.rglru``, plain PyTorch) and every family's attention
    kernel (``ops.flash_attention``)."""
    if cfg.family == "ssm":
        return ((ref, "ssd_chunked"),)
    if cfg.family == "hybrid":
        return ((ops, "rglru"), (ops, "flash_attention"))
    return ((ops, "flash_attention"),)


def static_full(arch, B, S, configs, registry, engine_mod, fa, stand_ins,
                profiling, ops, ref):
    """Phase 33: ``Engine.generate`` of ``arch`` at full width and depth
    (bf16, seeded random weights, greedy) on B prompts of S tokens with
    the launcher's prompts and stand-ins (``launch.serve.stand_ins``),
    STATIC_NEW_TOKENS out, after a warm-up generate at the same shape:
    finite logits, output (B, STATIC_NEW_TOKENS), the attention launches
    of every call as ``static_launches`` says, peak <= PEAK_LIMIT_GB;
    TTFT (the median of TTFT_SAMPLES prefills at that shape, the timed
    generate's first), TPOT p50 and tok/s printed.  Then where a
    prefill's time goes: one traced with torch.profiler (the device's
    busy share, its kernels by time), one with ``prefill_parts`` timed
    between synchronisations.  Returns the row and the attention
    launches of the timed generate."""
    cfg = configs.get_config(arch).model
    model = registry.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name} full width, {cfg.num_layers} layers: {n_params} "
          f"params ({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S))
    extra = stand_ins(cfg, B, S, rng) or None
    new = STATIC_NEW_TOKENS

    def engine(max_new, model=model):
        eng = engine_mod.Engine(cfg, params, device="cuda", max_len=S + new,
                                batch_size=B, serve=engine_mod.ServeConfig(
                                    max_new_tokens=max_new))
        eng.model = model
        return eng

    def generate(eng):
        out = eng.generate(prompts, extra_inputs=extra)
        torch.cuda.synchronize()
        return out

    generate(engine(2))  # first-call costs at this shape fall here
    rec = StaticRecorder(model, fa)
    eng = engine(new, rec)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = generate(eng)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    one = engine(1, rec)  # a generate of one token: the prefill, a sample
    for _ in range(TTFT_SAMPLES - 1):
        generate(one)
    one.model = model
    with torch.profiler.profile(
            activities=profiling.activities(torch.device("cuda"))) as prof:
        t0 = time.perf_counter()
        generate(one)
        traced = time.perf_counter() - t0
    print(f"prefill trace {arch}:")
    profiling.print_profile(prof, traced, top=6)
    parts = {}
    with contextlib.ExitStack() as stack:
        for mod, name in prefill_parts(cfg, ops, ref):
            stack.enter_context(synced_calls(mod, name, parts))
        t0 = time.perf_counter()
        generate(one)
        synced = (time.perf_counter() - t0) * 1e3
    want = static_launches(cfg, model)
    bad = [(kind, c) for kind, c in rec.calls
           if c != {k[1]: v for k, v in want.items() if k[0] == kind}]
    ttft = rec.ms["prefill"]
    row = dict(arch=arch, layers=cfg.num_layers, params=n_params, B=B,
               prompt=S, new_tokens=new, out_shape=list(out.shape),
               ttft_ms=float(np.median(ttft)), ttft_samples_ms=ttft,
               tpot_p50_ms=float(np.percentile(rec.ms["decode"], 50)),
               tok_per_s=out.size / wall, wall_s=wall,
               decode_steps=len(rec.ms["decode"]),
               launches_prefill=rec.calls[0][1],
               launches_decode=rec.calls[1][1] if len(rec.calls) > 1 else {},
               peak_mem_gb=peak, prefill_synced_ms=synced,
               prefill_parts_ms=parts)
    print("generate " + json.dumps(row))
    if not bool(torch.stack(rec.finite).all()):
        fail(f"{arch}: non-finite logits on the static path")
    if out.shape != (B, new) or len(rec.ms["decode"]) != new - 1:
        fail(f"{arch}: output {out.shape}, {len(rec.ms['decode'])} decode "
             f"steps for {new} tokens")
    if len(ttft) != TTFT_SAMPLES:
        fail(f"{arch}: {len(ttft)} prefills timed, not {TTFT_SAMPLES}")
    if bad:
        fail(f"{arch}: attention launches {bad[:2]}, expected {want}")
    if not peak <= PEAK_LIMIT_GB:
        fail(f"{arch}: peak {peak:.2f} GB over {PEAK_LIMIT_GB} GB")
    del eng, one, params, rec, prof
    torch.cuda.empty_cache()
    return row, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def static_decode_routes(fa, ops, ref, gen, cfg):
    """The plain static decode (``ops.decode_attention``, the reference's
    jnp route on every backend) at qwen2-7b's static shape of phase 33 (B
    8, 576 cached positions, 4 KV heads of 128, G 7, bf16) beside the
    paged decode kernel over an identity page table on the same K and V,
    and the int8 pool's route (gather, dequantize, direct decode) over
    that table: each timed, against its bound and the kernel's output."""
    B, T, KH, Dh = SLOTS, 512 + STATIC_NEW_TOKENS, cfg.num_kv_heads, \
        cfg.head_dim
    H = cfg.num_heads
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, T, KH, Dh), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kl = torch.full((B,), T, dtype=torch.int32, device="cuda")
    P = T // PAGE
    pages = [torch.cat([torch.zeros_like(t[0, :PAGE])[None],
                        t.reshape(B * P, PAGE, KH, Dh)]) for t in (k, v)]
    table = torch.arange(1, 1 + B * P, dtype=torch.int32,
                         device="cuda").view(B, P)
    quant = [ref.kv_quantize_int8(t) for t in pages]
    routes = {
        "static_plain": lambda: ops.decode_attention(
            q, k, v, kv_len=kl, return_stats=True),
        "paged_kernel": lambda: fa.paged_decode_attention_cuda(
            q, pages[0], pages[1], table, kl),
        "int8_gather": lambda: ops.paged_decode_attention(
            q, quant[0][0], quant[1][0], table, kl, k_scale=quant[0][1],
            v_scale=quant[1][1]),
    }
    ref_out = routes["static_plain"]()[0]
    kv_bytes = {"static_plain": 2 * k.numel() * 2,
                "paged_kernel": 2 * k.numel() * 2,
                "int8_gather": 2 * k.numel() * (1 + 4 / Dh)}
    rows = {}
    for name, fn in routes.items():
        err = float((fn()[0].float() - ref_out.float()).abs().max())
        ms = time_ms(fn)
        nbytes = kv_bytes[name] + 2 * q.numel() * 2
        bound_ms, bound_by = bound(4 * Dh * H * B * T, nbytes,
                                   torch.bfloat16)
        rows[name] = dict(B=B, positions=T, KH=KH, G=H // KH, Dh=Dh,
                          ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err_vs_static=err)
    print("static_decode_routes " + json.dumps(rows))
    if rows["paged_kernel"]["max_abs_err_vs_static"] > BF16_TOL["atol"]:
        fail("the paged kernel over an identity table disagrees with the "
             "static decode")
    return rows


# ---------------------------------------------------------------------------
# phases 35-38: the paper's experiments (repro_torch/experiments)
# ---------------------------------------------------------------------------

CAMPAIGN_ROUNDS = 60  # phase 35: Fig. 2/3 and Table 2 at run.py --full's
SWEEP_ROUNDS = 40     # the Fig. 4-7 sweeps at run.py --full's
GATE_ROUNDS = 3       # phase 35: HCEF card vs CPU
# budgets under which HCEF's theta falls to theta_min on the harness's
# CIFAR MLP (tests/test_torch_experiments.py's)
GATE_BUDGETS = dict(time_budget=2e4, energy_budget=2e3)
CFEL_CKPT = "ckpt_000030.npz"  # the example's last, after its 30 rounds
# phase 36: the paged decode kernel at the serving bench's page size, at
# smollm-135M's heads and qwen2-7b's; its pool of 11 pages a slot (24 +
# 64 positions)
BENCH_PAGE, BENCH_WIDTH = 8, 11
BENCH_DECODE = (("smollm_135m", 3, 3, 64), ("qwen2_7b", 4, 7, 128))
BENCH_KV_LEN = [0, 1, 7, 8, 9, 33, 80, 88]
BENCH_ARCHS = ("smollm_135m", "qwen2_7b")
BENCH_REQUIRE = 1.5  # the reference's --require, printed, not gated
OVERLAP_SWEEP_ROUNDS = 10  # phase 37: run.py's
COHORT_SWEEP_ROUNDS = 8
CKPT_ROUNDS = 2  # phase 38


def _digest(paths):
    """sha256 of every file under ``paths`` (caches left out)."""
    out = {}
    for root in paths:
        files = ([root] if root.is_file() else sorted(
            f for f in root.rglob("*")
            if f.is_file() and "__pycache__" not in f.parts))
        for f in files:
            out[str(f.relative_to(ROOT))] = hashlib.sha256(
                f.read_bytes()).hexdigest()
    return out


@contextlib.contextmanager
def results_elsewhere(common, label):
    """``common.RESULTS`` in a temporary directory while open; the JAX
    package's records (``benchmarks/``, ``BENCH_kernels.json``) hashed
    before and after, and the phase failed if they changed."""
    guarded = [ROOT / "benchmarks", ROOT / "BENCH_kernels.json"]
    guarded = [p for p in guarded if p.exists()]
    before = _digest(guarded)
    saved = common.RESULTS
    with tempfile.TemporaryDirectory(prefix="experiments_") as td:
        common.RESULTS = Path(td)
        try:
            yield Path(td)
        finally:
            common.RESULTS = saved
    after = _digest(guarded)
    print(f"{label}: {len(before)} files of benchmarks/ and "
          f"BENCH_kernels.json {'unchanged' if after == before else 'CHANGED'}")
    if after != before:
        fail(f"{label} changed the JAX package's records: "
             f"{sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))}")


@contextlib.contextmanager
def recorded_sims(common, tk):
    """Every FedSim ``common.make_sim`` makes while open: its ``run``
    counts its rounds, top-k launches and round walls into a record."""
    runs = []
    make = common.make_sim

    def make_sim(scheme, **kw):
        sim = make(scheme, **kw)
        rec = dict(scheme=scheme, **{k: kw[k] for k in (
            "dataset", "beta", "backhaul", "p_edge", "q", "tau")
            if k in kw})
        if np.isfinite(kw.get("time_budget", np.inf)):
            rec.update(time_budget=kw["time_budget"],
                       energy_budget=kw["energy_budget"])
        run = sim.run

        def counted_run(*a, **k):
            l0, n0 = tk.LAUNCHES["topk_compress"], len(sim.round_ms)
            hist = run(*a, **k)
            walls = sim.round_ms[n0:]
            rec.update(rounds=len(walls),
                       launches=tk.LAUNCHES["topk_compress"] - l0,
                       round_ms_p50=float(np.percentile(walls, 50)),
                       best_acc=max((h.get("acc", 0.0) for h in hist),
                                    default=0.0),
                       sim_time_s=hist[-1]["time"],
                       sim_energy_j=hist[-1]["energy"])
            return hist
        sim.run = counted_run
        runs.append(rec)
        return sim
    common.make_sim = make_sim
    try:
        yield runs
    finally:
        common.make_sim = make


def _same_bits(a, b):
    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        iview = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(iview[a.element_size()])
        b = b.contiguous().view(iview[b.element_size()])
    return torch.equal(a.cpu(), b.cpu())


def campaign_gate(common, vision, tk):
    """HCEF's first GATE_ROUNDS rounds from ``common.make_sim`` (CIFAR, 16
    devices in 8 clusters, 16,384 images, GATE_BUDGETS) on the card and on
    the CPU from the same parameters and masked-step bits: the history
    within FEDSIM_RTOL, the parameters within ROUND_ATOL but for
    Q_FLIP_SHARE top-k threshold flips, one top-k launch a card round."""
    params0 = vision(common.mlp_config("cifar"))[0](
        torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        sim = common.make_sim("hcef", params0=params0, device=dev,
                              **GATE_BUDGETS)
        tk.reset_launches()
        hist = [sim.run_round() for _ in range(GATE_ROUNDS)]
        runs[dev] = (hist, {k: v.cpu() for k, v in sim.params.items()},
                     tk.LAUNCHES["topk_compress"])
    (cpu, p_cpu, _), (card, p_card, launches) = runs["cpu"], runs["cuda"]
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(card, cpu) for k in HIST_KEYS)
    flips = sum(int(((p_card[k] - v).abs() > ROUND_ATOL).sum())
                for k, v in p_cpu.items())
    total = sum(v.numel() for v in p_cpu.values())
    allowed = int(Q_FLIP_SHARE * total)
    print(f"campaign gate: HCEF card vs CPU over {GATE_ROUNDS} rounds of "
          f"common.make_sim (cifar, 16 devices in 8 clusters), largest "
          f"relative deviation of {HIST_KEYS} {worst:.3e} (tolerance "
          f"{FEDSIM_RTOL}); parameters above {ROUND_ATOL}: {flips} of "
          f"{total} (allowed {allowed}); theta_mean "
          f"{[round(h['theta_mean'], 4) for h in card]}; top-k launches "
          f"{launches}")
    if not (worst <= FEDSIM_RTOL and flips <= allowed):
        fail("the harness's HCEF rounds on the card disagree with the CPU")
    if not max(h["theta_mean"] for h in card) < 1.0:
        fail("theta_mean is 1 in every gate round: Q dropped nothing")
    if launches != GATE_ROUNDS:
        fail(f"{launches} top-k launches in {GATE_ROUNDS} card rounds")


def campaign(common, figs, cfel, ckpt_mod, vision, tk):
    """Phase 35: the paper's campaign on the card (see the module
    docstring).  Returns the top-k launches of its runs."""
    fig23, fig4, fig5, fig67 = figs
    t0 = time.perf_counter()
    with results_elsewhere(common, "phase 35") as out_dir:
        campaign_gate(common, vision, tk)
        tk.reset_launches()
        with recorded_sims(common, tk) as runs:
            fig23.main(CAMPAIGN_ROUNDS)
            tables = {ds: json.loads((out_dir / f"fig23_{ds}.json")
                                     .read_text())
                      for ds in ("cifar", "femnist")}
            t_fig23 = time.perf_counter() - t0
            fig4.main(SWEEP_ROUNDS)
            fig5.main(SWEEP_ROUNDS)
            fig67.main(SWEEP_ROUNDS)
        launches = tk.LAUNCHES["topk_compress"]
        for i, rec in enumerate(runs):
            print(f"campaign run {i} " + json.dumps(rec))
        bad = [i for i, r in enumerate(runs)
               if "rounds" not in r or r["launches"] != r["rounds"]
               or not r["rounds"]]
        if bad:
            fail(f"campaign runs without one top-k launch a round: {bad}")
        n_rounds = sum(r["rounds"] for r in runs)
        for ds, out in tables.items():
            print(f"table2 {ds} (target acc {out['target_acc']}, simulated "
                  f"budgets {out['time_budget']:.1f} s / "
                  f"{out['energy_budget']:.1f} J; times and energies are "
                  f"the cost model's simulated seconds and joules, Eq. "
                  f"8/9) " + json.dumps(out["table2"]))
            for scheme, hist in out["histories"].items():
                if not all(np.isfinite(h["loss"]) for h in hist):
                    fail(f"non-finite loss in {ds} {scheme}")
        for name in ("fig4_noniid", "fig5_topology", "fig67_periods"):
            print(f"{name} " + (out_dir / f"{name}.json").read_text()
                  .replace("\n", ""))
        t_sweeps = time.perf_counter() - t0 - t_fig23
        # the CFEL example, then its last checkpoint into a fresh sim
        t1 = time.perf_counter()
        ck = out_dir / "cfel_ckpts"
        tk.reset_launches()
        sim = cfel.main(["--ckpt-dir", str(ck)])
        cfel_rounds, cfel_launches = sim.round, tk.LAUNCHES["topk_compress"]
        last = ckpt_mod.latest_checkpoint(ck)
        if last is None or last.name != CFEL_CKPT:
            fail(f"the CFEL example's last checkpoint is {last}")
        fresh = cfel.make_cfel_sim("hcef")
        fresh.restore(last)
        a, b = sim.run_round(), fresh.run_round()
        same = a == b and all(
            _same_bits(getattr(fresh, f)[k], v)
            for f in ("params", "ef", "mom")
            for k, v in getattr(sim, f).items())
        cfel_launches_all = tk.LAUNCHES["topk_compress"]
        print(f"cfel_cifar_train: {cfel_rounds} rounds, {cfel_launches} "
              f"top-k launches; restored {last.name} into a fresh sim, "
              f"round {a['round']} {'equal' if same else 'NOT EQUAL'} bit "
              f"for bit ({time.perf_counter() - t1:.1f} s)")
        if not same:
            fail("a restored CFEL checkpoint does not continue bit for bit")
        if cfel_launches != cfel_rounds:
            fail(f"{cfel_launches} top-k launches in the CFEL example's "
                 f"{cfel_rounds} rounds")
    print(f"phase 35: {len(runs)} FedSim runs, {n_rounds} rounds and "
          f"{launches} top-k launches; Fig. 2/3 {t_fig23:.1f} s, Fig. 4-7 "
          f"{t_sweeps:.1f} s")
    return launches + cfel_launches_all


@contextlib.contextmanager
def launches_by_mode(engine_cls, fa, counts):
    """Each ``Engine.generate`` / ``Engine.serve`` call's attention
    launches, added to counts[mode] (static, cont, cont_int8kv) with the
    calls counted, while open."""
    originals = {n: getattr(engine_cls, n) for n in ("generate", "serve")}

    def wrap(name):
        fn = originals[name]

        def call(self, *a, **kw):
            mode = ("static" if name == "generate" else
                    "cont_int8kv" if self.paged.kv_dtype == "int8"
                    else "cont")
            before = dict(fa.LAUNCHES)
            out = fn(self, *a, **kw)
            c = counts.setdefault(mode, {k: 0 for k in before})
            c["calls"] = c.get("calls", 0) + 1
            for k in before:
                c[k] += fa.LAUNCHES[k] - before[k]
            return out
        return call

    for n in originals:
        setattr(engine_cls, n, wrap(n))
    try:
        yield counts
    finally:
        for n, fn in originals.items():
            setattr(engine_cls, n, fn)


def serving_bench_phase(sb, fa, configs, engine_mod, wf, gen):
    """Phase 36 (see the module docstring).  Returns the attention
    launches of the benches and the decode kernel's rows at page size
    8."""
    ps8 = []
    for arch, KH, G, Dh in BENCH_DECODE:
        for dtype in (torch.bfloat16, torch.float32):
            row = decode_case(fa, gen, B=SLOTS, P=BENCH_WIDTH,
                              ps=BENCH_PAGE, KH=KH, G=G, Dh=Dh, dtype=dtype,
                              kv_len=BENCH_KV_LEN)
            ps8.append(dict({k: row[k] for k in (
                "KH", "G", "Dh", "dtype", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err")}, arch=arch))
    total = {k: 0 for k in fa.LAUNCHES}
    for arch in BENCH_ARCHS:
        t0 = time.perf_counter()
        cfg = configs.get_config(arch).model
        counts = {}
        with launches_by_mode(engine_mod.Engine, fa, counts):
            rows, detail = sb.bench_rows(smoke=False, arch=arch,
                                         device="cuda")
        L, wl = cfg.num_layers, detail["workload"]
        n_prefill = wl["n_requests"] + 2  # and the two warm-up requests
        st, co, i8 = counts["static"], counts["cont"], counts["cont_int8kv"]
        ok = (st["flash_attention"] == L * st["calls"]
              and st["paged_decode_attention"] == 0
              and co["flash_attention"] == L * n_prefill
              and co["paged_decode_attention"] > 0
              and co["paged_decode_attention"] % L == 0
              and i8["flash_attention"] == L * n_prefill
              and i8["paged_decode_attention"] == 0
              and all(c["flash_attention_bwd"] == 0
                      for c in counts.values()))
        ratio = (2 * cfg.num_kv_heads * cfg.head_dim * 4) / (
            2 * cfg.num_kv_heads * (cfg.head_dim + 4))
        speedup = detail["speedup_cont_vs_static"]
        for name, us, derived in rows:
            print(f"serving_bench {name},{us:.1f},{derived}")
        modes = {tag: {k: detail[tag][k] for k in (
            "tokens_per_s", "wall_s", "ttft_p50_ms", "ttft_p99_ms",
            "tpot_p50_ms", "tpot_p99_ms")}
            for tag in ("static", "continuous", "continuous_int8kv")}
        print(f"serving_bench {arch} " + json.dumps(dict(
            modes, launches=counts, kv_bytes_ratio=detail[
                "continuous_int8kv"]["kv_bytes_ratio"],
            speedup_cont_vs_static=speedup, workload=wl)))
        print(f"serving_bench {arch}: continuous vs static {speedup:.2f}x "
              f"(the reference's --require {BENCH_REQUIRE}: "
              f"{'OK' if speedup >= BENCH_REQUIRE else 'FAIL'}; not gated) "
              f"in {time.perf_counter() - t0:.1f} s")
        if not ok:
            fail(f"serving bench {arch}: attention launches by mode "
                 f"{counts} (L {L}, {n_prefill} prefills a serve)")
        if detail["continuous_int8kv"]["kv_bytes_ratio"] != ratio or \
                wf.kv_token_bytes(cfg.num_kv_heads, cfg.head_dim) != \
                2 * cfg.num_kv_heads * cfg.head_dim * 4:
            fail(f"serving bench {arch}: kv_bytes_ratio "
                 f"{detail['continuous_int8kv']['kv_bytes_ratio']} != "
                 f"{ratio}")
        for c in counts.values():
            for k in total:
                total[k] += c[k]
        torch.cuda.empty_cache()
    return total, ps8


def sweeps_phase(common, ov, cb, registry, tk, fa):
    """Phase 37 (see the module docstring).  Returns its kernel
    launches."""
    t0 = time.perf_counter()
    cfg, topo, hcef = ov.sweep_setup()
    params0 = registry.get_model(cfg).init(cfg, seed=0, device="cpu")
    a = ov._run(0, GATE_ROUNDS, cfg, topo, hcef, params0=params0,
                device="cuda")
    b = ov._run(0, GATE_ROUNDS, cfg, topo, hcef, params0=params0,
                device="cpu")
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    print(f"overlap sweep: staleness 0 card vs CPU over {GATE_ROUNDS} "
          f"rounds, losses {a} against {b}, largest relative deviation "
          f"{worst:.3e} (tolerance {ROUND_RTOL})")
    if not worst <= ROUND_RTOL:
        fail("the overlap sweep's rounds on the card disagree with the CPU")
    fa.reset_launches()
    tk.reset_launches()
    with results_elsewhere(common, "phase 37"):
        out = ov.main(OVERLAP_SWEEP_ROUNDS)
        checks = []
        rows = cb.bench_rows(smoke=True, device="cuda", checks=checks)
        for name, us, derived in rows:
            print(f"cohort_bench {name},{us:.1f},{derived}")
        sims = {}
        res = cb.sweep(rounds=COHORT_SWEEP_ROUNDS, verify_conservation=True,
                       on_sim=sims.__setitem__)
    launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES["topk_compress"])
    swaps = [h["swap_check"] for s in sims.values()
             for h in s.history if "swap_check" in h]
    ok = all(c["equal"] for c in checks + swaps)
    print(f"phase 37: overlap sweep modeled speedup "
          f"{out['modeled_speedup']:.4f}, final losses "
          f"{out['losses']['0'][-1]:.4f} / {out['losses']['1'][-1]:.4f}; "
          f"cohort sweep final (loss, acc) {json.dumps(res)}; "
          f"{len(checks)} bench swaps and {len(swaps)} sweep swaps "
          f"verified ({'equal' if ok else 'NOT EQUAL'}); launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        fail("a cohort swap did not keep the population's sums")
    if len(swaps) != 2 * (COHORT_SWEEP_ROUNDS - 1):
        fail(f"{len(swaps)} sweep swaps verified, expected "
             f"{2 * (COHORT_SWEEP_ROUNDS - 1)}")
    if not (launches["flash_attention"] and launches["flash_attention_bwd"]
            and launches["topk_compress"]):
        fail(f"the sweeps ran without the kernels: {launches}")
    return launches


def ckpt_full(train, ckpt_mod, fa, tk):
    """Phase 38 (see the module docstring).  Returns its kernel
    launches."""
    from repro_torch.tree import flatten
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ckpt_full_") as td:
        d = Path(td)
        fa.reset_launches()
        tk.reset_launches()
        out = train.main(["--arch", "smollm_135m", "--full", "--rounds",
                          str(CKPT_ROUNDS), "--seq", "2047",
                          "--ckpt-dir", td])
        launches = dict(fa.LAUNCHES,
                        topk_compress=tk.LAUNCHES["topk_compress"])
        tree = train.state_tree(out["state"])
        leaves = flatten(tree)
        est = sum(v.numel() * v.element_size() for v in leaves.values())
        names = sorted(p.name for p in d.glob("*.npz"))
        want = [f"ckpt_{r:06d}.npz" for r in range(CKPT_ROUNDS)]
        last = ckpt_mod.latest_checkpoint(d)
        t1 = time.perf_counter()
        back, meta = ckpt_mod.load_pytree(last, tree)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        got = flatten(back)
        same = set(got) == set(leaves) and all(
            _same_bits(got[k], v) for k, v in leaves.items())
        bf16 = sum(v.dtype == torch.bfloat16 for v in leaves.values())
        print("ckpt_full " + json.dumps(dict(
            files=names, latest=last.name if last else None, meta=meta,
            state_bytes=est, ckpts=[dict(c, path=Path(c["path"]).name)
                                    for c in out["ckpts"]],
            load_s=load_s, leaves=len(leaves), bf16_leaves=int(bf16),
            bit_for_bit=same, launches=launches,
            round_ms=out["round_ms"], s=time.perf_counter() - t0)))
    if names != want or last is None or last.name != want[-1]:
        fail(f"checkpoints {names}, latest {last}; expected {want}")
    if meta != {"round": CKPT_ROUNDS - 1}:
        fail(f"the last checkpoint's meta {meta}")
    if not (same and bf16):
        fail("the checkpoint does not load back bit for bit")
    return launches


# ---------------------------------------------------------------------------
# phases 39-41: the three examples, the kernel bench, the dry run
# ---------------------------------------------------------------------------

QS_ROUNDS = 3  # phase 39: the quickstart's rounds in lockstep
DEMO_RTOL = 1e-4  # phase 39: the demo's losses, card against CPU
# phase 39: serve_lm on one family of each kind (dense, MoE, SSM, hybrid,
# the ViT stub, the encoder-decoder), greedy, weights times 10
SERVE_KINDS = ("smollm_135m", "granite_moe_1b_a400m", "mamba2_1p3b",
               "recurrentgemma_9b", "internvl2_2b", "seamless_m4t_large_v2")
SERVE_CONTINUOUS = "granite_moe_1b_a400m"
# phase 41: the dry run's cells (the --all run is recorded in PERF.md)
DRYRUN_CELLS = (("smollm_135m", "train_4k"), ("smollm_135m", "prefill_32k"),
                ("smollm_135m", "decode_32k"), ("smollm_135m", "long_500k"),
                ("mamba2_1p3b", "long_500k"))
PEAK_BF16_FLOPS = 989e12  # the roofline's peak


def _state_fields(state):
    from repro_torch.tree import flatten
    return {f"{f}/{k}": v for f in ("params", "momentum", "ef")
            if getattr(state, f) is not None
            for k, v in flatten(getattr(state, f)).items()}


def quickstart_lockstep(quickstart, fa, tk):
    """The quickstart's first QS_ROUNDS rounds on the card and on the CPU
    from the same weights and bits, in lockstep: each round's row within
    ROUND_RTOL, the state within ROUND_ATOL but for Q_FLIP_SHARE top-k
    flips, then the card's state written into the CPU's.  Every attention
    launch, forward and backward, and every top-k launch of the card's
    rounds counted."""
    its = {dev: quickstart.rounds_iter(QS_ROUNDS, device=dev)
           for dev in ("cuda", "cpu")}
    cfg, topo, hcef = quickstart.setup()
    fa.reset_launches()
    tk.reset_launches()
    worst, flips_max, rows = 0.0, 0, []
    for rnd in range(QS_ROUNDS):
        card_row, card = next(its["cuda"])
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES, topk_compress=tk.LAUNCHES[
            "topk_compress"])
        cpu_row, cpu = next(its["cpu"])
        for k, v in card_row.items():
            worst = max(worst, abs(v - cpu_row[k]) / max(abs(cpu_row[k]),
                                                         1e-12))
        a, b = _state_fields(card), _state_fields(cpu)
        total = sum(v.numel() for v in b.values())
        flips = sum(int(((a[k].cpu() - v).abs() > ROUND_ATOL
                         + ROUND_RTOL * v.abs()).sum()) for k, v in b.items())
        flips_max = max(flips_max, flips)
        if flips > Q_FLIP_SHARE * total:
            fail(f"quickstart round {rnd}: {flips} of {total} state entries "
                 f"past ROUND_ATOL")
        with torch.no_grad():
            for k, v in b.items():
                v.copy_(a[k].cpu())
        rows.append(card_row)
    steps = QS_ROUNDS * topo.num_devices * hcef.tau
    want = {"flash_attention": steps * cfg.num_layers,
            "flash_attention_bwd": steps * cfg.num_layers,
            "paged_decode_attention": 0, "topk_compress": QS_ROUNDS}
    print(f"quickstart on the card: {json.dumps(rows)}; card vs CPU in "
          f"lockstep: largest relative deviation of a row {worst:.3e} "
          f"(tolerance {ROUND_RTOL}), state entries past {ROUND_ATOL} at "
          f"most {flips_max} a round; launches {launches}")
    if worst > ROUND_RTOL:
        fail("the quickstart's rounds on the card disagree with the CPU")
    if launches != want:
        fail(f"quickstart launches {launches}, expected {want}")
    return launches


def examples_phase(quickstart, demo, serve_lm, fa, tk):
    """Phase 39: the three examples on the card (see the module
    docstring).  Returns the kernel launches of their runs."""
    t0 = time.perf_counter()
    launches = quickstart_lockstep(quickstart, fa, tk)
    t_qs = time.perf_counter() - t0
    out = {dev: demo.run(device=dev, verbose=dev == "cuda")
           for dev in ("cuda", "cpu")}
    for name, want in (("resnet20_cifar10", 269_722),
                       ("femnist_cnn", 6_603_710)):
        card, cpu = out["cuda"][name], out["cpu"][name]
        dev = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                       cpu["losses"]))
        print(f"paper_models_demo {name}: {card['count']:,} params, "
              f"losses card {card['losses']} CPU {cpu['losses']}, largest "
              f"relative deviation {dev:.3e} (tolerance {DEMO_RTOL})")
        if card["count"] != want or cpu["count"] != want:
            fail(f"{name}: {card['count']} parameters, expected {want}")
        if dev > DEMO_RTOL:
            fail(f"{name}: the demo's losses on the card disagree")
    t_demo = time.perf_counter() - t0 - t_qs
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.models.registry import get_model
    serve_launches = {}
    for arch in SERVE_KINDS + ("continuous",):
        cont = arch == "continuous"
        arch = SERVE_CONTINUOUS if cont else arch
        cfg = smoke_model(get_config(arch).model)
        p0 = get_model(cfg).init(cfg, seed=0, device="cpu")
        got = {}
        for dev in ("cpu", "cuda"):
            fa.reset_launches()
            _, o = serve_lm.run(arch, temperature=0.0, continuous=cont,
                                device=dev, params=_to(p0, dev, 10.0),
                                verbose=False)
            got[dev] = ({r: v.tokens for r, v in o.items()} if cont
                        else o.tolist())
        torch.cuda.synchronize()
        n = dict(fa.LAUNCHES)
        serve_launches[("continuous " if cont else "") + arch] = n
        for k in launches:
            launches[k] += n.get(k, 0)
        same = got["cuda"] == got["cpu"]
        print(f"serve_lm {'--continuous ' if cont else ''}{arch} "
              f"({cfg.family}{', ' + cfg.frontend if cfg.frontend else ''}"
              f"): greedy tokens card {'==' if same else '!='} CPU; "
              f"launches {n}")
        if not same:
            fail(f"serve_lm {arch}: card {got['cuda']} CPU {got['cpu']}")
        attn = cfg.family not in ("ssm",)
        if attn and not n["flash_attention"]:
            fail(f"serve_lm {arch}: no attention kernel launch")
        if cont and not n["paged_decode_attention"]:
            fail("serve_lm --continuous: no paged decode kernel launch")
    print(f"phase 39: quickstart {t_qs:.1f} s, demo {t_demo:.1f} s, "
          f"serve_lm {time.perf_counter() - t0 - t_qs - t_demo:.1f} s")
    return launches


def _twin_agrees(name, a, b):
    """(worst error, ok) of a kernel row's output against its _plain
    twin's, at the kernel's gate."""
    if name.startswith("topk"):  # bit for bit (phase 5)
        ok = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                 for x, y in zip(a, b))
        return 0.0, ok
    if name.startswith("round"):  # the round gate, top-k flips allowed
        (pa, la), (pb, lb) = a, b
        total = sum(v.numel() for v in pb.values())
        flips = sum(int(((pa[k] - v).abs() > ROUND_ATOL
                         + ROUND_RTOL * v.abs()).sum())
                    for k, v in pb.items())
        dl = float(((la - lb).abs() / lb.abs().clamp_min(1e-12)).max())
        return float(flips), flips <= Q_FLIP_SHARE * total and \
            dl <= ROUND_RTOL
    # attention and the SSD scan in f32: F32_TOL, the SSD's atol a share of
    # y's largest entry (phase 8)
    scale = float(b.abs().max()) if name.startswith("ssd") else 1.0
    err = float((a - b).abs().max())
    ok = bool(((a - b).abs() <= F32_TOL["atol"] * scale
               + F32_TOL["rtol"] * b.abs()).all())
    return err, ok


def kernels_bench_phase(kb, fa, tk, ss, wp):
    """Phase 40: ``kernels_bench --smoke`` on the card, every row printed,
    each kernel row's output held to its ``_plain`` twin's.  Returns the
    rows and their launches by kernel (the bench's own: not the main
    path's)."""
    for m in (fa, tk, ss, wp):
        m.reset_launches()
    rows = kb.bench(device="cuda", smoke=True)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES, **tk.LAUNCHES, **ss.LAUNCHES,
                    **wp.LAUNCHES)
    print("name,us_per_call,derived")
    for name, us, derived, _ in rows:
        print(f"{name},{us:.1f},{derived}")
    by = {r[0]: r for r in rows}
    for name, _, derived, out in rows:
        if name.endswith("_plain") or name + "_plain" not in by:
            continue
        err, ok = _twin_agrees(name, out, by[name + "_plain"][3])
        print(f"kernels_bench {name}: {derived.split('|')[0]} against "
              f"plain {'agree' if ok else 'DISAGREE'} ({err:.3e})")
        if not derived.startswith("kernel"):
            fail(f"kernels_bench {name} did not run its kernel: {derived}")
        if not ok:
            fail(f"kernels_bench {name} disagrees with its plain twin")
    print(f"kernels_bench launches (comparisons, not a main path): "
          f"{launches}")
    return rows


def dryrun_phase(dryrun, roofline, wire_report):
    """Phase 41: the dry run's DRYRUN_CELLS, one sparse train cell per
    wire dtype, the wire report with --require int8/int4:2.0, the
    roofline, phase 16's smollm cell beside its measured peak, and the
    model FLOPs of every training cell the script ran beside its p50."""
    from repro_torch.configs.base import FLTopology, ShapeConfig
    t0 = time.perf_counter()
    saved = dryrun.RESULTS_DIR
    with tempfile.TemporaryDirectory(prefix="dryrun_") as td:
        dryrun.RESULTS_DIR = Path(td)
        try:
            cells = [dryrun.run_cell(a, s, verbose=False)
                     for a, s in DRYRUN_CELLS]
            sparse = [dryrun.run_cell("smollm_135m", "train_4k",
                                      wire_dtype=wd, verbose=False)
                      for wd in WIRE_DTYPES]
            for c in cells + sparse:
                print(f"dryrun {c['arch']} {c['shape']} "
                      f"{c.get('wire_dtype', '')} {c['status']}: " +
                      json.dumps({k: c[k] for k in (
                          "count_s", "param_count", "memory", "fits_72gb",
                          "hlo", "reason", "error") if k in c}))
            bad = [c for c in cells + sparse if c["status"] == "error"]
            if bad:
                fail(f"dry-run cells in error: {bad}")
            paths = [str(dryrun.cell_path("smollm_135m", "train_4k", wd))
                     for wd in WIRE_DTYPES]
            try:
                wire_report.main(paths + ["--require", "int8/int4:2.0"])
            except SystemExit as e:
                fail(f"the wire report failed: exit {e.code}")
            roofline.main(results=Path(td))
        finally:
            dryrun.RESULTS_DIR = saved
    # phase 16's cell: smollm-135M, R = 4 in 2 x 2, tau 4, 2 x 2048 tokens
    run16 = TRAIN_CELLS.get("smollm")
    c16 = dryrun.lower_cell("smollm_135m", shape=ShapeConfig(
        "phase16", "train", 2048, 4 * 4 * 2), topo=FLTopology(2, 2),
        verbose=False)
    print(f"dryrun phase 16's smollm cell (R 4, 2 x 2048 tokens a step): "
          f"peak_est {c16['memory']['peak_est_bytes'] / 1e9:.2f} GB "
          f"(arguments {c16['memory']['argument_bytes'] / 1e9:.2f} GB) "
          f"beside the {run16['peak_gb']:.2f} GB phase 16 measured "
          f"(ungated: the count runs the plain attention on meta)")
    mfu = {}
    for name, c in TRAIN_CELLS.items():
        B = c["replicas"] * c["tau"] * c["seqs_per_step"]
        mf = roofline.model_flops(c["cfg"], "train", B, c["positions"],
                                  c["params"])
        mfu[name] = dict(layers=c["cfg"].num_layers, replicas=c["replicas"],
                         sequences=B, positions=c["positions"],
                         params=c["params"], model_flops=mf,
                         round_p50_ms=c["p50_ms"],
                         share_of_peak=mf / (c["p50_ms"] / 1e3
                                             * PEAK_BF16_FLOPS))
    print("model_flops_share " + json.dumps(mfu))
    print(f"phase 41: {len(cells) + len(sparse)} cells "
          f"{time.perf_counter() - t0:.1f} s")


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no port package under {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.configs import base
    from repro_torch.core import round as rnd_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.kernels import wire_pack as wp
    from repro_torch.core import compression
    from repro_torch.core import wire_format as wf
    from repro_torch.data import synthetic
    from repro_torch.dist import collectives as col
    from repro_torch.dist import policies
    from repro_torch.launch import fedsim, profiling, train
    from repro_torch.models import mamba2
    from repro_torch.models.vision import make_vision_model
    from repro_torch.launch.serve import poisson_requests, stand_ins
    from repro_torch.kernels import ref
    from repro_torch.models import lm, registry
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.page_manager import pages_for
    from repro_torch.runtime import chaos as chaos_mod
    from repro_torch.runtime import checkpoint as ckpt_mod
    from repro_torch.experiments import (cfel_cifar_train, cohort_bench,
                                         common, fig2_3_convergence,
                                         fig4_noniid, fig5_topology,
                                         fig67_periods, kernels_bench,
                                         overlap_sweep, paper_models_demo,
                                         quickstart, roofline, serve_lm,
                                         serving_bench, wire_bytes_report)
    from repro_torch.launch import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 compared at 2e-5
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- phase 1 -------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc wall {build.build_seconds})")
    for name, (regs, spills, stack, smem, n) in ptxas_summary(
            build.build_log).items():
        print(f"  ptxas: {name}: up to {regs} registers, {spills} bytes of "
              f"spill stores, {stack} bytes of stack, {smem} bytes of "
              f"static shared memory, over {n} instantiations")

    # the served stream fixes the main path's prefill and decode shapes:
    # every prefill runs at S_pad, every decode over `width` pages per slot
    cfg = configs.get_config("qwen2_7b").model
    reqs = serve_requests(poisson_requests, cfg, cfg.vocab_size)
    S_pad = engine_mod._align(max(len(r.prompt) for r in reqs), PAGE)
    width = pages_for(S_pad + max(r.max_new_tokens for r in reqs), PAGE)

    # -- phase 2 -------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    qwen = dict(H=cfg.num_heads, KH=cfg.num_kv_heads, Dh=cfg.head_dim)
    main_prefill = None
    for S in sorted({144, 512, 2048, S_pad}):
        row = prefill_case(fa, gen, S=S, dtype=torch.bfloat16, **qwen)
        if S == S_pad:
            main_prefill = row
    prefill_case(fa, gen, S=512, dtype=torch.float32, **qwen)
    for dtype in (torch.float32, torch.bfloat16):  # q_offset, ragged Skv
        prefill_case(fa, gen, S=200, Skv=328, H=8, KH=2, Dh=64, dtype=dtype,
                     window=96, q_offset=128)
    smollm = configs.get_config("smollm_135m").model
    prefill_case(fa, gen, S=144, H=smollm.num_heads, KH=smollm.num_kv_heads,
                 Dh=smollm.head_dim, dtype=torch.bfloat16)
    prefill_case(fa, gen, S=100, H=4, KH=2, Dh=16, dtype=torch.bfloat16)
    prefill_case(fa, gen, S=256, H=8, KH=2, Dh=64, dtype=torch.bfloat16,
                 window=64)
    # head dim 256 with one KV head under a window: an f32 case, a ragged
    # bf16 one, and recurrentgemma-9b's training layer beside masked SDPA
    g = GRIFFIN_LAYER
    prefill_case(fa, gen, S=200, H=3, KH=1, Dh=256, dtype=torch.float32,
                 window=96)
    prefill_case(fa, gen, S=300, H=16, KH=1, Dh=256, dtype=torch.bfloat16,
                 window=96)
    griffin_fwd = prefill_case(fa, gen, S=g["S"], H=g["H"], KH=g["KH"],
                               Dh=g["Dh"], dtype=torch.bfloat16,
                               window=g["window"], masked_library=True)
    # the training forwards of phases 30 and 31 at their layers
    layer_fwd = {name: attention_fwd_train(fa, gen, **c)
                 for name, c in (("internvl", INTERNVL_LAYER),
                                 ("seamless", SEAMLESS_LAYER))}
    for name, row in layer_fwd.items():
        print(f"attention_fwd_train {name} " + json.dumps(row))
    # the cross-attention's shapes: Sq 1 in the encdec decode step, Sq !=
    # Skv in its prefill
    cross_rows = [prefill_case(fa, gen, causal=False, **c)
                  for c in CROSS_CASES]

    # -- phase 3 -------------------------------------------------------------
    kv_len = [0, 1, 16, 100, 257, 333, S_pad + 31, width * PAGE - 1]
    shape = dict(B=SLOTS, P=width, ps=PAGE, KH=cfg.num_kv_heads,
                 G=cfg.num_heads // cfg.num_kv_heads, Dh=cfg.head_dim,
                 kv_len=kv_len)
    main_decode = decode_case(fa, gen, dtype=torch.bfloat16, **shape)
    decode_case(fa, gen, dtype=torch.float32, **shape)
    decode_case(fa, gen, dtype=torch.bfloat16,
                **dict(shape, KH=smollm.num_kv_heads, Dh=smollm.head_dim,
                       G=smollm.num_heads // smollm.num_kv_heads))
    cps, _ = fa.decode_split(SLOTS, cfg.num_kv_heads, width, PAGE,
                             fa._sm_count(0))
    span = cps * fa.DECODE_CHUNK  # positions a split owns
    edges = [span, span - 1, span + 1, 2 * span, 2 * span + 1, 3 * span - 1,
             PAGE, 0]
    decode_case(fa, gen, dtype=torch.bfloat16,
                **dict(shape, kv_len=[min(n, width * PAGE) for n in edges]))
    decode_case(fa, gen, dtype=torch.bfloat16,  # 67 MB of live K and V
                **dict(shape, P=LONG_CONTEXT // PAGE,
                       kv_len=[LONG_CONTEXT] * SLOTS))

    # -- phase 4 -------------------------------------------------------------
    small_path_agrees(lm, configs)
    decode_graphs_agree(lm, fa, cfg)
    m4 = serve_full(lm, engine_mod, cfg, fa, reqs, poisson_requests)
    launches = {k: m4[k] for k in fa.LAUNCHES}

    # -- phase 5 -------------------------------------------------------------
    init = lambda m: make_vision_model(fedsim.vision_config(m))[0](
        torch.Generator().manual_seed(0))
    leaf_shapes = [tuple(p.shape) for p in init("resnet20").values()]
    fc1 = tuple(init("femnist_cnn")["fc1_w"].shape)
    main_topk = topk_phase(tk, leaf_shapes, fc1)
    topk_mamba2_cases(tk, configs, mamba2)

    # -- phases 6 and 7 ------------------------------------------------------
    fedsim_agrees(fedsim)
    launches["topk_compress"] = fedsim_full(fedsim, tk)

    # -- phase 8 -------------------------------------------------------------
    main_ssd_fwd, main_ssd_bwd = ssd_phase(ss, configs, mamba2)

    # -- phase 9 -------------------------------------------------------------
    small_round_agrees(configs, mamba2, rnd_mod, base)
    m2 = mamba2_full(train, ss, tk,
                     mamba2_topk_launches(configs, mamba2, tk))
    launches.update(ssd_scan_fwd=m2["ssd_scan_fwd"],
                    ssd_scan_bwd=m2["ssd_scan_bwd"])

    # -- phase 10 ------------------------------------------------------------
    main_wire = wire_phase(wp, configs, mamba2, rnd_mod.GOSSIP_COLS)

    # -- phases 11 and 12 ----------------------------------------------------
    m11 = small_sparse_round_agrees(configs, mamba2, rnd_mod, base,
                                    compression, policies)
    m12 = mamba2_sparse_full(configs, mamba2, rnd_mod, base, compression,
                             policies, wf, train, synthetic, wp, ss, tk)
    launches.update({k: m12[k] for k in main_wire})

    # -- phase 13 ------------------------------------------------------------
    sys.path.insert(0, str(ROOT / "tools"))
    import gossip_bench
    m13 = wire_ef_full(gossip_bench, col, wp, rnd_mod, wf)
    # the standalone pack and unpack run on no main path: phases 11-13
    # decode every payload in the decode-and-mix kernel
    for k in ("wire_pack", "wire_unpack"):
        launches[k] = m11[k] + m12[k] + m13[k]

    # -- phase 14 ------------------------------------------------------------
    main_bwd, griffin_bwd, fwd_train, layer_bwd = attention_bwd_phase(
        fa, build)

    # -- phases 15 and 16 ----------------------------------------------------
    small_lm_round_agrees(configs, lm, rnd_mod, base, fa)
    m16 = lm_full(train, fa, tk, lm_topk_launches(configs, lm, tk))
    launches["flash_attention"] += m16["flash_attention"]
    launches["flash_attention_bwd"] = m16["flash_attention_bwd"]
    fwd_train["launches"] = m16["flash_attention"]  # all at that shape
    print("attention_fwd_train " + json.dumps(fwd_train))

    # -- phases 17-20: degraded mode and cohorts -----------------------------
    masked_mix_phase(wp, col, tk, compression, chaos_mod, configs, mamba2,
                     rnd_mod.GOSSIP_COLS, leaf_shapes)
    m18 = rounds_under_masks(configs, lm, mamba2, rnd_mod, base, compression,
                             policies, col, chaos_mod, train, wp)
    for k in ("wire_encode", "wire_decode_mix"):
        launches[k] += m18[k]
    launches["topk_compress"] += fedsim_chaos_full(fedsim, tk, chaos_mod)
    topk_lm = lm_topk_launches(configs, lm, tk)
    m20 = lm_chaos_full(train, fa, tk, topk_lm)
    for k in ("flash_attention", "flash_attention_bwd", "topk_compress"):
        launches[k] += m20[k]

    # -- phases 21-23: the overlap engine ------------------------------------
    stale_mix_phase(wp, col, configs, mamba2, rnd_mod.GOSSIP_COLS)
    m22 = overlap_small(configs, lm, mamba2, rnd_mod, base, compression,
                        policies, wp)
    t0 = time.perf_counter()
    m23 = lm_overlap_fused(configs, lm, rnd_mod, base, compression, policies,
                           wf, train, synthetic, wp, fa, tk, col, topk_lm)
    m23l, w23l = lm_overlap_launcher(train, fa, tk, wp, wf, rnd_mod, topk_lm)
    print(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    for k in ("wire_encode", "wire_decode_mix"):
        launches[k] += m22[k] + m23[k] + w23l[k]
    for k in ("flash_attention", "flash_attention_bwd", "topk_compress"):
        launches[k] += m23[k] + m23l[k]

    # -- phases 24-26: the MoE family ----------------------------------------
    t0 = time.perf_counter()
    small_lm_round_agrees(configs, lm, rnd_mod, base, fa, arch=MOE_ARCH,
                          lockstep=True)
    moe_layer_phase(configs, lm)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m25 = lm_full(train, fa, tk, lm_topk_launches(configs, lm, tk, MOE_ARCH),
                  arch=MOE_ARCH)
    moe_profile(configs, lm, rnd_mod, profiling)
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    granite = configs.get_config(MOE_ARCH).model
    decode_graphs_agree(lm, fa, granite)
    m26 = serve_full(lm, engine_mod, granite, fa,
                     serve_requests(poisson_requests, granite,
                                    cfg.vocab_size), poisson_requests,
                     tpot_limit_ms=TPOT_LIMIT_MS)
    print(f"phase 26 took {time.perf_counter() - t0:.1f} s")
    for k in ("flash_attention", "flash_attention_bwd", "topk_compress"):
        launches[k] += m25[k]
    for k in ("flash_attention", "paged_decode_attention"):
        launches[k] += m26[k]

    # -- phases 27 and 28: the hybrid family ---------------------------------
    t0 = time.perf_counter()
    griffin_small(configs, lm, rnd_mod, base, fa, ops)
    print(f"phase 27 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m28 = griffin_full(configs, rnd_mod, base, train, synthetic, fa, tk)
    print(f"phase 28 took {time.perf_counter() - t0:.1f} s")
    for k in ("flash_attention", "flash_attention_bwd", "topk_compress"):
        launches[k] += m28[k]

    # -- phases 29-31: the last two architectures ----------------------------
    t0 = time.perf_counter()
    multimodal_small(configs, lm, rnd_mod, base, fa, train)
    print(f"phase 29 took {time.perf_counter() - t0:.1f} s")
    layer_runs = {}
    for phase, (name, arch) in enumerate(zip(("internvl", "seamless"),
                                             MULTIMODAL_ARCHS), start=30):
        t0 = time.perf_counter()
        layer_runs[name] = multimodal_full(arch, configs, rnd_mod, base,
                                           train, synthetic, fa, tk)
        print(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
        for k in ("flash_attention", "flash_attention_bwd",
                  "topk_compress"):
            launches[k] += layer_runs[name][k]

    # -- phases 32-34: Engine.generate of every family, the paged modes ------
    t0 = time.perf_counter()
    static_small(configs, registry, engine_mod, fa)
    paged_modes_small(configs, lm, fa)
    print(f"phase 32 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    static_rows = {}
    for arch, B, S in STATIC_FULL:
        static_rows[arch], m33 = static_full(arch, B, S, configs, registry,
                                             engine_mod, fa, stand_ins,
                                             profiling, ops, ref)
        launches["flash_attention"] += m33["flash_attention"]
    decode_routes = static_decode_routes(fa, ops, ref, gen, cfg)
    print(f"phase 33 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m34 = serve_full(lm, engine_mod, cfg, fa, reqs, poisson_requests,
                     kv_dtype="int8")
    ratio = m4["pool_bytes"] / m34["pool_bytes"]
    print(f"phase 34: int8 pool {m34['pool_bytes']} bytes against the "
          f"bf16 pool's {m4['pool_bytes']} ({ratio:.4f}x), TPOT p50 "
          f"{m34['tpot_p50_ms']:.2f} ms (bf16 "
          f"{m4['tpot_p50_ms']:.2f}), paged decode kernel launches "
          f"{m34['paged_decode_attention']} (the reference's routing)")
    launches["flash_attention"] += m34["flash_attention"]
    same = [next((i for i, (a, b) in enumerate(zip(m4["tokens"][rid], toks))
                  if a != b), len(toks))
            for rid, toks in m34["tokens"].items()]
    print(f"phase 34: the int8 serve's greedy tokens equal the bf16 serve's "
          f"for the first {same} of each request's tokens ("
          f"{sum(same)} of {sum(map(len, m34['tokens'].values()))}; not "
          f"gated: one near tie parts the rest of a row)")
    print(f"phase 34 took {time.perf_counter() - t0:.1f} s")

    # -- phases 35-38: the paper's experiments -------------------------------
    t0 = time.perf_counter()
    launches["topk_compress"] += campaign(
        common, (fig2_3_convergence, fig4_noniid, fig5_topology,
                 fig67_periods), cfel_cifar_train, ckpt_mod,
        make_vision_model, tk)
    print(f"phase 35 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m36, ps8_rows = serving_bench_phase(serving_bench, fa, configs,
                                        engine_mod, wf, gen)
    print(f"phase 36 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m37 = sweeps_phase(common, overlap_sweep, cohort_bench, registry, tk, fa)
    print(f"phase 37 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m38 = ckpt_full(train, ckpt_mod, fa, tk)
    print(f"phase 38 took {time.perf_counter() - t0:.1f} s")
    for k in ("flash_attention", "paged_decode_attention"):
        launches[k] += m36[k]
    for k in ("flash_attention", "flash_attention_bwd", "topk_compress"):
        launches[k] += m37[k] + m38[k]

    # -- phases 39-41: the examples, the kernel bench, the dry run ----------
    t0 = time.perf_counter()
    m39 = examples_phase(quickstart, paper_models_demo, serve_lm, fa, tk)
    for k in ("flash_attention", "flash_attention_bwd",
              "paged_decode_attention", "topk_compress"):
        launches[k] += m39[k]
    print(f"phase 39 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels_bench_phase(kernels_bench, fa, tk, ss, wp)
    print(f"phase 40 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_phase(dryrun, roofline, wire_bytes_report)
    print(f"phase 41 took {time.perf_counter() - t0:.1f} s")

    # -- report --------------------------------------------------------------
    kernels = []
    for name, src, replaces, row in (
            ("flash_attention", "src/repro_torch/kernels/csrc/"
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:202",
             main_prefill),
            ("paged_decode_attention", "src/repro_torch/kernels/csrc/"
             "paged_decode.cu", "src/repro/kernels/flash_attention.py:90",
             main_decode),
            ("topk_compress", "src/repro_torch/kernels/csrc/"
             "topk_compress.cu", "src/repro/kernels/topk_compress.py:101",
             main_topk),
            ("ssd_scan_fwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:77", main_ssd_fwd),
            ("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:77", main_ssd_bwd),
            ("wire_encode", "src/repro_torch/kernels/csrc/wire_pack.cu",
             "src/repro/kernels/wire_pack.py:343", main_wire["wire_encode"]),
            ("wire_pack", "src/repro_torch/kernels/csrc/wire_pack.cu",
             "src/repro/kernels/wire_pack.py:244", main_wire["wire_pack"]),
            ("wire_unpack", "src/repro_torch/kernels/csrc/wire_pack.cu",
             "src/repro/kernels/wire_pack.py:264",
             main_wire["wire_unpack"]),
            ("wire_decode_mix", "src/repro_torch/kernels/csrc/wire_pack.cu",
             "src/repro/kernels/wire_pack.py:264",
             main_wire["wire_decode_mix"]),
            ("flash_attention_bwd", "src/repro_torch/kernels/csrc/"
             "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:202", main_bwd)):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    kernels[2]["note"] = ("one launch over every leaf of a (delta type, "
                          "EF type) pair: one a ResNet-20 round, ragged "
                          "leaves handled in the kernel")
    kernels[4]["note"] = ("the backward has no TPU counterpart: jax.grad "
                          "through ssd_pallas fails; held to jax.grad of "
                          "ref.ssd_chunked_jnp through the plain version")
    kernels[5]["note"] = ("times and bound with p4 offsets, the gossip's "
                          "form: the encode writes the p4 bytes itself "
                          "(pack_offsets_pallas's work, wire_pack.py:244)")
    kernels[6]["note"] = ("off the gossip path: the encode writes the p4 "
                          "bytes; this kernel (a warp a block up to wb "
                          "1024) serves ops.pack_offsets on int32 offsets, "
                          "which no main path calls")
    kernels[7]["note"] = ("off the gossip path, the wire EF's included "
                          "(phases 11-13 decode in wire_decode_mix); this "
                          "kernel (a warp a block up to wb 1024) serves "
                          "ops.unpack_offsets and wire_decode")
    kernels[0]["note"] = ("launches: the serves' prefills (phases 4, 26, "
                          "34, 36), the static prefills and seamless's "
                          "decode steps' cross-attention (phase 33) and "
                          "the training forwards of phases 16, 20, 23, "
                          "25, 28, 30, 31, 37 and 38 (two a layer and "
                          "step: remat); cross_attention: the encdec decode "
                          "step's shape (Sq 1) and a ragged Sq != Skv, "
                          "non-causal, library_ms SDPA; griffin_layer: "
                          "recurrentgemma-9b's "
                          "training layer (16/1 heads of 256, S 4096, "
                          "window 2048), library_ms SDPA with the window "
                          "as a boolean mask; internvl_layer (B 2, S 2048, "
                          "16/8 heads of 128, causal) and seamless_layer "
                          "(B 2, S 2048, 16/16 heads of 64, non-causal: "
                          "its encoder's and cross-attention's shape), "
                          "with the launches a round of phases 30 and 31 "
                          "(seamless: its non-causal ones apart)")
    kernels[0]["cross_attention"] = [
        {k: row[k] for k in ("B", "S", "Skv", "H", "KH", "Dh", "dtype", "ms",
                             "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "max_abs_err")} for row in cross_rows]
    kernels[0]["cross_attention_launches_per_decode_step"] = \
        static_rows["seamless_m4t_large_v2"]["launches_decode"]
    kernels[0]["smollm_train_layer"] = {k: fwd_train[k] for k in (
        "ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
        "launches")}
    kernels[1]["static_decode_routes"] = decode_routes
    kernels[1]["page_size_8"] = ps8_rows
    kernels[1]["note"] = ("launches: the serves of phases 4, 26 and 36 "
                          "(page size 8 there); none in phase 34's or "
                          "36's int8 pool nor on the static path, "
                          "which the reference routes to its jnp decode "
                          "on every backend (static_decode_routes: no "
                          "kernel but paged_kernel)")
    kernels[0]["griffin_layer"] = {k: griffin_fwd[k] for k in (
        "ms", "bound_ms", "bound_by", "library_ms", "library_backend",
        "max_abs_err")}
    kernels[9]["griffin_layer"] = {k: griffin_bwd[k] for k in (
        "ms", "bound_ms", "bound_by", "library_ms", "library_backend",
        "max_abs_err", "split_us")}
    for name in ("internvl", "seamless"):
        run = layer_runs[name]
        for i, (row, key) in enumerate(((layer_fwd[name], "flash_attention"),
                                        (layer_bwd[name],
                                         "flash_attention_bwd"))):
            kw = "noncausal_" + ("fwd" if i == 0 else "bwd")
            kernels[0 if i == 0 else 9][f"{name}_layer"] = dict(
                {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "max_abs_err")},
                causal=row["causal"],
                launches_per_round=run[key] / MULTIMODAL_ROUNDS,
                noncausal_launches_per_round=run[kw] / MULTIMODAL_ROUNDS)
    kernels[9]["note"] = ("the backward has no TPU counterpart: jax.grad "
                          "through flash_attention_pallas fails; held to "
                          "jax.grad of the reference's jnp route "
                          "(ref.flash_attention_jnp) through the plain "
                          "version; times at smollm-135M's layer (B 2, S "
                          "2048, 9/3 heads of 64, bf16, causal), library_ms "
                          "SDPA's backward alone; griffin_layer, "
                          "internvl_layer and seamless_layer as for "
                          "flash_attention")
    kernels[8]["note"] = ("no TPU counterpart: the reference decodes in "
                          "jnp (dist/collectives.py:642 wire_decode); it "
                          "holds unpack_offsets_pallas's p4 unpack and "
                          "replaces the gossip's decode chain; under a "
                          "backhaul partition the conn mask rides in its "
                          "per-destination coefficients (phases 17, 18)")
    for i, k in ((0, "flash_attention"), (9, "flash_attention_bwd"),
                 (1, "paged_decode_attention"), (2, "topk_compress")):
        kernels[i]["examples_launches"] = m39[k]
    print("generate_full " + json.dumps(static_rows))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
