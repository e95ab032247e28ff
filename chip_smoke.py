#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, so the script exits non-zero):

1. Device and build: the card's name and power limit, torch and CUDA
   versions, and the time to build every CUDA kernel (one ``nvcc`` per
   source, all started together), with each source's own build time and
   ptxas' registers, spills and warnings; the host makes the join phases'
   collections meanwhile.
2. Kernel parity: each of the six packed-word kernels and the two
   tensor-core verdict kernels (``candidate_matrix_mxu``,
   ``count_candidates_mxu``: the bit-plane product on wgmma from the packed
   words, the verdict and count in the epilogue) against its plain PyTorch
   version on the card, over a sweep (odd sizes, W in {1, 4, 8, 12, 128},
   self-join, cosine keys, the cutoff hit and not, empty rows, invalid
   entries; for the tensor-core pair also W = 32, NR and NS on their
   128 x 256 work tiles' edges, NS % 16 != 0, all-pass and all-prune rows,
   count tiles 32 / 64 / 256) and at the main paths' shapes: a 4096 x 4096
   block pair of real data (W = 4) for the dense kernels, the first probe
   chunk of the SKEWED tau = 0.8 indexed join for the postings kernels.
   The indexed driver's stage kernels (``expand_filter``: the CSR
   expansion and entry admission; ``verdict_verify``: the pairwise verdict
   at the candidates' own rows and exact verification of the survivors)
   against their plain versions and the unfused compositions (the PyTorch
   ops around ``entry_filter`` and ``pair_verdict``) over the CPU tests'
   grid (4 similarities x 4 taus x self-join and R x S x W in {1, 4, 32},
   and the edges) and at the first chunk of SKEWED at tau = 0.8 and 0.6.
   Results must be exactly equal; each kernel is then timed with CUDA
   events (median after warm-up) beside its plain version, the two forms of
   each dense verdict in turns (swar, mxu, mxu, swar) and each stage kernel
   in turns with the unfused composition (kernel, composition,
   composition, kernel), with their bounds and the SWAR form's popcount
   floor; and the postings wrappers' host cost a call.
3. Slice parity, on the card against the port's CPU path: the blocked join
   (``compaction="device"``) on the middle 5,120 sets of a 10,000-set ZIPF
   collection with planted duplicates (the SWAR verdict's join on all of
   them against the tensor-core verdict's), ``naive_join`` against the
   blocked join on 3,000 of its sets, and the indexed join on a
   10,000-set SKEWED collection with planted duplicates under
   ``impl="auto"`` (the stage kernels), ``impl="swar"``,
   ``impl="swar_tiled"`` (the unfused composition), a forced small
   capacity (the dense fallback, on the middle 5,120 sets), and at b =
   1024 under ``impl="mxu"``.
   Pairs and ``JoinStats`` must be identical.  The blocked join under
   ``impl="swar"`` drives the SWAR verdict and count.
4. Full size, the blocked path: ZIPF (100,000 sets, Poisson(50) sizes,
   101,584 tokens, 1,000 planted clusters of 3 at Jaccard 0.9; tau = 0.8,
   an explicit blocked plan) and UNIFORM (100,000 sets, Poisson(10) sizes,
   220 tokens; tau = 0.5) through ``JoinEngine``, whose auto plan must be
   blocked; b = 128, block = 4096, device compaction.  Host compaction must
   agree with it on the middle 24,576 rows of each collection's size order.  Under ``auto`` the path launches the tensor-core verdict
   and count, and neither SWAR kernel.
5. Full size, the indexed path: SKEWED (``skewed_collection`` of 100,000
   sets + 1,000 planted clusters of 3 at Jaccard 0.9) through
   ``JoinEngine`` at tau = 0.8 and 0.6, whose auto plans must be indexed:
   a cold and a warm self-join, then four probe batches of 4,096 rows cut
   from the corpus (a third of them perturbed), all through the stage
   kernels and no other postings kernel; then each self-join again under
   the unfused composition (``impl="swar_tiled"``).  Pairs and counters
   must agree, and pairs must equal the blocked join's, self-join and
   R x S; the postings index is built once per engine.

6. Bit-plane kernel parity: ``bitplane_hamming`` and
   ``pair_verdict_bitplane`` against their plain versions and against the
   SWAR kernels on the same operands (W in {1, 4, 16, 32, 128}, odd sizes,
   all-pass / all-prune / empty rows, cosine keys, both sides of the
   cutoff), exactly.
7. Full size, the corpus store on the blocked path at b = 1024: ZIPF as in
   phase 4 in a ``CorpusStore`` with a pinned blocked plan (b = 1024,
   block = 4096), a self-join, two appends of 1,000 sets, a self-join,
   ``compact()`` and a self-join.  At every state the pairs equal a
   from-scratch rebuild under the same plan (and its funnel counters) and
   the b = 128 blocked join; the base is prepared once across the appends.
   The path launches the tensor-core verdict and count, and neither the SWAR
   pair nor ``bitplane_hamming``.  Then both dense verdicts at the store's
   4096 x 4096 block pair (W = 32): exact, timed in turns (swar, mxu, mxu,
   swar), beside the bit-plane composite it replaces (unpack, ``bitplane_hamming``, the
   verdict in PyTorch ops) that the tensor-core kernel replaces.
8. Full size, serving at b = 1024: SKEWED as in phase 5 in a
   ``CorpusStore`` planned by ``JoinPlanner(b=1024)`` (indexed), a
   ``JoinSession(max_batch=512)`` warmed with ``warm_buckets``, then 2,048
   single-set requests (a quarter exact corpus rows) flushed every 512, a
   2,000-set ``append`` after the first 1,024, ``compact()`` after the last
   and 256 more.  Sampled tickets (64 a flush) must equal a solo
   ``JoinEngine.probe`` in pairs and ``JoinStats``; the union of all tickets
   must equal one blocked R x S join at b = 128; no entrypoint is built after
   warm-up, across the append; the flushes run the stage kernels and none
   of the unfused path's pairwise kernels.  Then both bit-plane kernels are timed
   at their shapes (a 4096 x 4096 block pair of the store's words, the
   first coalesced batch's candidates) beside their plain versions, their
   bounds and a PyTorch yardstick (``bitplane_hamming`` also beside the
   ``torch._int_mm`` product alone, in turns, with its TOP/s and share of
   its bound), and ``verdict_verify`` at that batch in turns with the
   unfused composition at b = 1024 (``impl="mxu"``).
9. Flash-attention parity: ``flash_attention`` against its plain version on
   the same card tensors (TF32 off, both flags printed), causal and not,
   Sq != Sk, lengths 1 to 1,000 and the wgmma instances' 128- and 192-row
   tile edges (127, 128, 129, 191, 193, 255, 257, 384, 385), GQA groups 1,
   3, 4 and 8, head dims 16, 32, 64, 112 and 128, float32 (rtol = atol = 2e-5)
   and bf16 (1e-2), every instance with a kernel there (float32: 3xTF32, the
   static rule, and the CUDA cores; its prepass ``split_kv`` bit-identical to
   its plain version on each case's k and v), and one batch of a qwen3-8b
   layer (S = 4,096, 32/8 heads of 128 in bf16 and in float32 by both
   float32 instances, and bf16 with head dim 32).
10. Full size, LM serving: qwen3-8b at its published widths and depth (36
   layers, d_model 4,096, 32/8 heads of 128, d_ff 12,288, vocab 151,936;
   f32 parameters drawn on the card from ``--seed``, bf16 compute), 4
   requests of 4,096 seeded prompt tokens, ``greedy_generate`` of 32
   tokens (prefill and decode timed, tokens/s, peak memory).  The prefill
   must launch ``flash_attention`` once a layer, each time its wgmma
   instance; the prefill's and each decode step's logits must be within 5%
   relative RMS of ``Model.forward`` over the same tokens (teacher-forced),
   and the same check must fail when the cache is read one position off;
   the kernel must equal its plain version at layer 0's captured q, k, v,
   where it is then timed beside its plain version, its bound (with its
   TFLOP/s and share of it) and ``scaled_dot_product_attention``.
11. The flash kernel's other instances.  bf16 at head dims 16 and 32 (the
   wgmma instance; no full-width config has these head dims): the reduced
   qwen3-8b config in bf16 (head_dim 16) serves 2 prompts of 200 tokens and
   8 greedy tokens, once a layer through the wgmma instance, teacher-forced
   against ``Model.forward``; the instance equals the plain version at
   layer 0's operands and at qwen3-8b's layer shape with head dims 32 and
   16, where it is timed in turns with ``scaled_dot_product_attention``
   (wgmma, SDPA, SDPA, wgmma).  float32: the reduced config in float32
   through the same path, once a layer through the static rule's instance
   (3xTF32, after its prepass) and never the other; then at qwen3-8b's
   layer shape in float32 (TF32 off) both float32 instances against the
   plain version and the prepass bit-identical to its own, the two
   instances timed in turns (3xTF32, CUDA cores, CUDA cores, 3xTF32; the
   static rule's must be the faster in both), the prepass alone, the plain
   version and ``scaled_dot_product_attention`` in float32 (as dispatched,
   and under the memory-efficient backend).  Every flash bound is the
   largest of its bytes, its products (the bf16 tensor rate; in float32 the
   TF32 tensor rate for three products, or the CUDA cores' rate for the
   CUDA-core instance) and its exps (ex2 at 16 a clock an SM at the card's
   maximum SM clock), printed with the term that binds; the prepass's is its
   bytes.
12. Full size, LM training: smollm-135m at its published widths and depth
   (30 layers, d_model 576, 9/3 heads of 64, d_ff 1,536, vocab 49,152, tied
   embeddings; f32 parameters drawn on the card from ``--seed``, bf16
   compute, each layer recomputed in the backward), batches of 8 x 2,048
   tokens from ``SyntheticLMLoader``.  (a) The kernel's lse output against
   the plain version's at the layer shape (bf16, D = 64, causal) and at a
   reduced float32 shape (D = 16, the 3xTF32 instance), within 1e-4 (1 +
   |lse|).  The backward kernel (``flash_attention_bwd_cuda``) from the
   forward kernel's out and lse: in float32 at the reduced shape (the
   CUDA-core instance, TF32 off) within 1e-4 relative RMS of the plain
   version, timed in turns with it; at the layer shape (the wgmma instance)
   dq, dk, dv within 5% relative RMS of the plain version's and of
   ``scaled_dot_product_attention``'s (the plain version's against SDPA's
   too), then timed in turns with the plain backward (kernel, plain, plain,
   kernel) and with SDPA's backward alone on a retained graph, beside its
   bound (five products, their bytes, one exp a pair).  (b) The train
   step's loss and gradients through the flash kernels (forward and
   backward) against the same with both plain versions, from the same
   weights and batch: the loss within 1e-3 relative and every gradient leaf
   within 5% relative RMS; the step launches the forward twice a layer and
   the backward once a layer, the plain step neither; the same gate must
   fail when the kernel's lse is shifted by log 2 on one head; then the
   reduced smollm-135m config in float32 within 1e-4 relative RMS.  (c) 20
   AdamW steps (lr 3e-3, 5 warmup steps) through ``FaultTolerantRunner``
   with a checkpoint every 10 steps (async) and no restart allowed: every
   loss finite, the last below the first, no failure; the flash kernel
   launches twice a layer a step (the forward and the layer's
   recomputation), each writing lse, and the backward kernel once a layer a
   step.  (d) The last checkpoint restored into a fresh model's state
   equals the trained state leaf for leaf, and the next step's loss from it
   equals the uninterrupted run's.  Printed: step ms (CUDA events, median
   of steps 3-20), tokens/s, peak memory, the forward and loss share of a
   step, the forward kernel with and without lse in turns at the layer
   shape beside its bound, and ``scaled_dot_product_attention``'s forward
   and backward.
13. The paper's CPU algorithms and dedup (at most about 120 s).  (a)
   ``BitmapFilter.build`` on the card gives the CPU's ``uint32`` words bit
   for bit (Set, Xor, Next at b = 64 and 128).  (b) Tables 5-8 in part, at
   the reference benchmark's collections and sizes (UNIFORM 2,000 at b =
   64, ZIPF 1,200 and DBLP-like 500 at b = 128; ``bench_cpu_algos.py``):
   tau = 0.8 on all three and 0.6 on UNIFORM (0.5 too, on every other of
   UNIFORM's sets, when the budget allows), AllPairs, PPJoin, GroupJoin and AdaptJoin each without and
   with the filter (its words built on the card): ms, ``bitmap_pruned`` and
   the improvement t_orig / t_bf - 1; pairs identical with and without the
   filter, to the card's blocked join and to its ``naive_join``.  (c) For
   each of those cells the card's warm blocked join against the fastest
   CPU algorithm with the filter (the port's Python algorithms, not the
   paper's C++).  (d) ``JoinEngine`` on a card-prepared UNIFORM 2,000 under
   each CPU driver (explicit plans, and ``JoinPlanner.plan(prefer="cpu")``
   at tau = 0.8 and 0.5): the self-join and three 500-row probes equal the
   blocked engine's pairs, the prefix index built once (GroupJoin: none).
   (e) Dedup on the card at full size: ``dedup_collection`` of phase 4's
   ZIPF at tau = 0.8 (its pairs equal phase 4's blocked join; every planted
   cluster in one component that keeps one row; the kept sets hold no
   pair); ``dedup_shards`` of four 5,000-set shards, near-copies planted
   against the corpus (the deduped first 80,000 sets) and across shards,
   through a ``CorpusStore`` (the final store's self-join is empty, its base
   sorted once, some copy dropped against a prior shard's survivor); and
   ``dedup_documents`` of 20,000 synthetic documents, a tenth planted
   near-copies, every one dropped.  Wall times split into shingling, the
   join, and union-find or the store's probes and appends.  (f) The dense
   verdict and count kernels (rows 1-2) launched on the dedup path, read
   as in every other path, go into the kernels line as
   ``launches_by_path["dedup"]``.
14. The flash kernels at head dim 112 (zamba2-7b's shared attention; bf16,
   wgmma on D = 128's tiles, zero-filled past 112): the forward with and
   without lse (bit-identical outputs) and the backward against their
   plain versions over odd Sq / Sk, the 128-row and 128-key tile edges,
   GQA groups 1-8, causal and not; then at zamba2-7b's serving shape (B 4,
   S 1,024, 32 heads) and training shape (B 2, S 2,048), each timed in
   turns with ``scaled_dot_product_attention`` (the backward with SDPA's
   backward alone and with the plain backward), beside the plain versions
   and bounds of the true D = 112 work.
15. Full size, the ssm and hybrid families served: zamba2-7b (81 layers,
   d_model 3,584, the shared attention + MLP block before 13 groups of 6
   Mamba2 layers, 3 tail layers) and mamba2-2.7b (64 layers, d_model
   2,560) at their published configs (f32 parameters drawn on the card
   from ``--seed``), each freed before the next: 4 requests of 1,024 prompt
   tokens (a multiple of ``ssm_chunk``), ``greedy_generate`` of 16 tokens
   in bf16 (prefill and decode timed, tokens/s, peak memory).  The prefill
   launches ``flash_attention`` once a shared-attention application (13
   for zamba2-7b, none for mamba2-2.7b), each its wgmma instance without
   lse, and the kernel must equal its plain version at every application's
   captured operands; its logits must be finite.  bf16 rounding grows
   through the Mamba2 stack (F32_TF_REL_TOL's note), so the end-to-end
   gates run the same generation in float32 (TF32 off): every step's
   logits within 1e-3 relative RMS of ``Model.forward`` over the same
   tokens (padded with seeded filler to a whole number of SSD chunks), the same
   check failing when the prefill's SSM states are zeroed; zamba2-7b's
   whole float32 prefill through the kernel within 1e-3 of the same through
   the plain version (the logits and every cache leaf); each of
   mamba2-2.7b's Mamba2 blocks in bf16 within 5% of the same block in
   float32.
16. Full size, the hybrid family trained: zamba2-7b at its published widths,
   depth cut to 13 layers (two groups of 6 behind the shared block and one
   tail layer, the reduced config's shape; 1.33e9 parameters), batches of
   2 x 2,048 tokens.  In bf16 the step calls the forward (with lse) and the
   backward once a shared-attention application (the shared block is not
   recomputed), each call equal to its plain version at the step's own
   operands (the backward's dq, dk, dv within 5% relative RMS, and the
   same check failing with the forward's lse + log 2 on one head); in
   float32 every gradient leaf through the kernels within 1e-3
   relative RMS of the plain versions' and the shifted-lse control failing
   that gate; then 4 AdamW steps in bf16, every loss finite (step ms,
   tokens/s, peak memory).
17. Full size, the moe family served: phi3.5-moe-42b-a6.6b (16 experts
   top-2, d_model 4,096, 32/8 heads of 128) with its depth cut from 32 to
   8 layers and arctic-480b (128 experts top-2 beside a dense MLP, d_model
   7,168, 56/8 heads of 128: a GQA group of 7) cut from 35 to 1, the most
   one card's 80 GB holds in float32 (10.67e9 and 14.07e9 parameters): 4
   requests of 1,024 prompt tokens, ``greedy_generate`` of 16 tokens in
   bf16 (prefill and decode timed, tokens/s, peak memory), the flash
   kernel once a layer (its wgmma instance, no lse) and equal to its plain
   version at every layer's captured operands, ``moe_dropped`` at the
   published capacity factor (1.25) reported.  The end-to-end gate runs
   the same generation in float32 (TF32 off) at capacity_factor = E / k,
   whose capacity is the whole group, so nothing is dropped (a decode step
   is a group of one token, capacity 4, and never drops; a 1,024-token
   prefill at 1.25 does): every step's logits within 1e-3 relative RMS of
   ``Model.forward`` over the same tokens (padded with seeded filler to
   whole groups of 1,024), ``moe_dropped`` 0, and the same check failing
   when the cache is read one position off.  arctic's layer is also where
   the kernel is timed at a GQA group of 7, in turns with
   ``scaled_dot_product_attention``.
18. Full size, the vlm and audio families served, not cut:
   llama-3.2-vision-11b (32 self layers and 8 gated cross-attention layers
   over 1,600 seeded image embeddings a request, d_model 4,096, 32/8 heads
   of 128; its zero-initialised gates set to seeded values of either sign,
   so cross-attention is live) and musicgen-medium (48 layers, d_model
   1,536, 24 MHA heads of 64, frame-embedding inputs: 1,500 seeded frames
   a request and one a decode step, argmax codes out), as phase 17: the
   flash kernel once a self or cross layer (the cross layers non-causal
   over 1,600 keys, 12.5 key tiles), equal to its plain version at every
   call, timed at the cross-attention (B 4, Sq 1,024, Sk 1,600) and at
   musicgen's layer (B 4, S 1,500, 24 heads of 64) in turns with SDPA; the
   float32 teacher-forced gate and its off-by-one control, and for the
   vision model a second control, zeroed image embeddings, failing the
   gate.
19. Full size, the three trainable families: musicgen-medium not cut (4 x
   1,500 frames; its ``embed``, which frame inputs never read, gets zero
   gradients and decays), llama-3.2-vision-11b cut to one group (4 self
   layers and its cross layer; 2 x 2,048 tokens and 1,600 image
   embeddings) and phi3.5-moe-42b-a6.6b cut to 2 layers (2 x 2,048
   tokens), batches from ``SyntheticLMLoader``.  One bf16 step's every
   forward and backward kernel call against its plain version at its own
   operands (the forward twice a remat layer, the vision model's cross
   layer once), the backward fed the forward's lse + log 2 on one head
   failing its gate; the backward timed at the cross layer (Sq 2,048, Sk
   1,600, non-causal) and at musicgen's layer in turns with SDPA's backward
   and with the plain backward; then 4 AdamW steps (losses finite, the
   moe family's aux metrics, step ms, tokens/s, peak memory, launches).
   arctic trains on the CPU only: one layer's optimizer state (about 225
   GB) exceeds the card.
20. The mesh drivers on ``torch.distributed`` (at most about 90 s), their
   ranks processes of their own (this script with ``--mesh-child``, a
   ``file://`` store, the collections written by this process, the kernels
   built before they start): 4 gloo ranks sharing the card, then one NCCL
   rank.  Through ``JoinEngine`` on a mesh of the ranks, the ring's ZIPF
   self-join (tau = 0.8, b = 128: 25,500-row shards, the single rank's step
   the whole 102,000² mask) must equal phase 4's blocked pairs, with its
   per-device verified counters summing to them; sharded-indexed (phase
   5's plan on 4 token slabs) its SKEWED self-join and four probes phase
   5's pairs and ``JoinStats``; every rank the same, no fallback.  Cold
   and warm walls per driver and run (under gloo they include the host
   staging: not multi-GPU numbers).  Each path launches its kernels on
   every rank (rows 1, 4, 5: ``candidate_matrix_mxu``; ``expand_filter``,
   ``verdict_verify``) and no other verdict or postings kernel; those
   three are held against their plain versions at the ring's shards and
   at each slab's first chunk (sentinel-padded slabs, each rank's slice of
   the gathered candidates) and timed there, and enter the kernels line a
   second time under this phase's paths, their launches summed over the
   runs' ranks.
21. Sharded training on ``torch.distributed`` (about 3 minutes): smollm-135m
   at its published widths on phase 12's global batch (8 x 2,048
   tokens), AdamW without warmup, through ``sharded_train_step`` (FSDP over
   ``data``, tensor parallel over ``model``), each rank a process of its
   own (this script with ``--train-child``): 4 gloo ranks sharing the card
   on a (4,) data mesh (FSDP only), 3 gloo ranks on (1, 3) data x model
   (head-parallel TP), 4 gloo ranks on (1, 4) (9 heads on 3 KV heads divide
   no TP of 4: each rank's attention takes its 512 q rows at their query
   offset against the whole K and V) and one NCCL rank on (1, 1); NCCL with
   more than one rank is not exercised (one card).  First phase 12's single-device step
   here, float32 (TF32 off; its state checkpointed after each step) and
   bf16.  Each rank: its slices of the seeded parameters, its rows of each
   batch from the loader over the mesh; 2 float32 steps (depth cut to 6
   of 30 layers, widths and batch uncut), then its slices
   restored from the single-device checkpoint (each rank reading its
   slices) and held to it (each parameter leaf's RMS difference within 1%
   of its update, each moment within 1e-3, the losses within 1e-4), on the
   (4,) mesh also a step with rank 0's rows shifted by one, on (1, 4) a
   step with every flash call at offset 0, each of which must fail that
   gate; then 2 bf16 steps (depth cut to 4 layers), their losses within 1%
   of the single device's, the first step's every flash forward and
   backward call held to its plain version at its own operands and taking
   the rank's q rows at their offset.  Every rank the same losses; 8
   forward and 4 backward flash launches a bf16 step on every rank (rows 9
   and 9d's ``launches_by_path``); each rank's parameter and AdamW bytes
   the single rank's over the shard count (within 1%); step ms, tokens/s
   and each rank's peak memory printed.  The (4,) and (1, 4) meshes run
   one after the other in one launch of 4 ranks, beside the launch of 3
   ranks; the NCCL rank runs alone after them.
22. Sharded serving and the launch tooling (about 2 minutes).  (a)
   qwen3-8b at its published widths served through ``sharded_prefill`` and
   ``sharded_decode_step``, each rank a process of its own (this script
   with ``--serve-child``): 4 gloo ranks sharing the card on (1, 4) data x
   model (head-parallel: 8 query and 2 KV heads a rank) and on (2, 2), the
   depth cut from 36 to 2 layers and the generation to the prefill and one
   decode step, then one NCCL rank on (1, 1) at full depth with phase 10's
   4 x 4,096 prompt tokens and 31 decode steps; decode tokens are seeded
   (teacher forcing).  Each rank draws the seeded parameters whole, computes
   the single device's logits for its rows (``DecodeEngine``), then serves
   from its slices: float32 (TF32 off) logits gathered over the vocabulary
   within 1e-3 relative RMS of the single device's, the last step re-run
   from the cache read one position off failing that gate; the NCCL rank's
   bf16 logits within phase 10's 5%; every bf16 flash call of a prefill
   equal to its plain version at its operands; the flash kernel launched
   once a layer a prefill on every rank (row 9's ``launches_by_path``).
   Printed per mesh: prefill s, decode ms a step, the flash launches and
   the peak memory a rank.  (b) The dry run (``python -m
   repro_torch.launch.dryrun``, each cell in its own subprocess, the first
   two beside (a)): smollm-135m x train_4k and qwen3-8b x decode_32k at the
   (16, 16) mesh of 256 ranks, and bitmap-join x join_1m, whose one rank's
   256 ring hops run row 1 on the card; each cell's roofline terms printed.
   (c) Phase 12's step (smollm-135m, 8 x 2,048, bf16, AdamW) dry-run on a
   (1, 1) mesh and then run on the card through ``sharded_train_step``: the
   predicted parameter and AdamW bytes must equal the measured (1.614 GB);
   the predicted and measured peaks, the roofline's step-time bound beside
   the measured step, and the step's share of the bf16 peak are printed,
   each beside the card's name and power limit.
23. The query offset and the moe, vlm and audio families over a mesh
   (about 4 minutes).  (a) Both flash kernels with ``q_offset``, bf16 and
   float32: smollm-135m's layer (8 x 2,048, 9 / 3 heads of 64) in 4 q
   slices at offsets 0, 512, 1,024 and 1,536, each against its plain
   versions, its output and dq those rows of one causal call on the whole
   q, the slices' dk and dv summing to the whole call's, each timed in
   turns with the whole call beside its bound, plain versions and SDPA
   with the slice's mask; the last slice at offset 0 must miss; D = 112
   and 128 at offset 333 (200 rows).  (b) is phase 21's (1, 4) run.  (c)
   The single device's float32 references here first (one AdamW step's
   update a leaf, teacher-forced logits), then 4 gloo ranks sharing the
   card on (1, 4) (experts, heads, d_ff and the vocabulary over TP), each
   drawing only its slices: phi3.5-moe (2 layers) and the vision model (4
   self layers and a cross layer) trained one float32 step (the update
   within 1% of the single device's a leaf, the loss within 1e-4,
   ``moe_dropped`` equal) and one bf16 step (every flash call within its
   gate); phi3.5-moe (4 layers), the vision model and musicgen (uncut)
   served, 4 x 256 prompt tokens and a decode step: float32 logits within
   1e-3 relative RMS of the single device's, the cache read one position
   off and (phi3.5-moe) layer 0's experts rotated by one rank each failing
   that gate, every bf16 flash call within its gate; then one NCCL rank on
   (1, 1) serving the three and arctic (1 layer) in bf16 against the
   single device within 5%.  Rows 9 and 9d's ``launches_by_path`` count
   (c)'s launches; (a)'s compare kernels with their plain versions and
   count on no path.
24. The ssm and hybrid families over a mesh (``phase_ssm_mesh``):
   mamba2-2.7b and zamba2-7b trained by 4 gloo ranks on (1, 4), served on
   (1, 4) and (2, 2), then served uncut by one NCCL rank.
25. The bitmap build's kernel (``csrc/bitmap_build.cu``: Bitmap-Set, -Xor
   and -Next into packed words; the lane form, one lane a set, and the
   warp form, one warp a set (the first design), picked by
   ``bitmap_build.form``'s rule), run right after phase 8 while phase 4's
   collections are at hand (at most about 30 s).  (a) Its words equal its
   plain version's bit for bit in every form (the rule's, lane, warp) on
   phase 4's ZIPF and UNIFORM at b = 128 and 1,024, every method, the
   mixer on and off, and on seeded edge rows at b = 32, 96, 160, 1,024
   (the lane form's widest), 1,056, 4,096 and 32 x 12,289 (whose words
   exceed one warp's 48 KB of shared memory), N = 0, 1 and 64: probes that
   wrap past bit b - 1, rows of b tokens and more, PAD inside a length, a
   length past the row, empty rows.  (b) On ZIPF at b = 128 and 1,024,
   each method; UNIFORM's Next at b = 128; and Xor at b = 1,024 on
   serving-shaped batches (16 and 512 ZIPF rows in a seeded order, padded
   to a power-of-two width): the lane form, the warp form and the plain
   version in turns (lane, warp, plain, plain, warp, lane), beside the
   bound: the positions it must read, the lengths and the words over the
   memory rate, its integer operations, and for Next the longest set's
   chain of probes (one dependent instruction a probe at the maximum SM
   clock), with the term that binds.
   (c) UNIFORM's self-join at Jaccard tau = 0.35 through ``JoinEngine``:
   the plan is blocked with Bitmap-Next; the path launches
   ``bitmap_build_next`` in its lane form only (and no other method, and
   no plain generator); cold and warm walls; its pairs equal the same join
   without the bitmap filter (``use_bitmap=False``), and its pairs and
   ``JoinStats`` a run whose words came from the plain version.  Phases
   4, 5, 7 and 8 count the kernel's launches on their paths too (each
   must launch it), and by form in the same window: phase 4's full-size
   Set and Xor builds must run the lane form, phase 8's flushes the warp
   form.  Rows ``bitmap_build_set``, ``_xor`` and ``_next`` report them
   under ``launches_by_path`` and ``path_form_launches``, with the rule's
   form and the warp form's time.

Kernel times are device times: CUDA events around 50 (20 for attention)
back-to-back launches, a spin kernel queued first so that the host's
launch work stays out of them, the median of 3 such runs (this script
once timed each call alone, host launch work included; the two
tensor-core kernels print that time too).

Each path's kernel launch counters are zeroed just before it and read just
after (launches of the comparison runs inside the serving phase are taken
out); every kernel the path runs must have launched, the blocked paths
(phases 4 and 7) neither SWAR verdict kernel, the indexed and serving
paths the stage kernels and none of the unfused path's postings kernels.
``entry_filter`` and ``pair_verdict_tiled`` report their launches from
phase 5's runs under the unfused composition.  The kernels no full-size
path runs are driven through their entry points in phase 3
(``pair_verdict`` by the indexed join under ``impl="swar"``,
``pair_verdict_bitplane`` under ``impl="mxu"`` at b = 1024, the SWAR
``candidate_matrix`` and ``count_candidates`` by the blocked join under
``impl="swar"``, ``hamming_matrix`` and ``bitplane_hamming`` by
``ops.hamming_matrix``), and the flash kernel at head dims 16 and 32 and in
float32 by phase 11's reduced models, each read the same way; the flash
backward reports its launches from phase 12's 20 steps, its D = 112
instances theirs from zamba2-7b's prefill (phase 15) and training steps
(phase 16); rows ``flash_attention`` and ``flash_attention_bwd`` add the
launches of phases 17-19's prefills and training steps under
``launches_by_path`` and their timings at those phases' shapes under
``at_family_shapes``; the ``path`` key of each kernel
names the run its ``launches`` come from (the tensor-core verdicts: phases
4 and 7 together).  The
last three lines of standard output are the card's name and power limit,
the ``{"kernels": [...]}`` record and the ``{"ok": true, ...}`` result.
Exits non-zero without a result when no CUDA device is available.  Data is
made from ``--seed``; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The H100 SXM's published peaks, from the port's roofline (its only copy,
# with their sources): HBM3 bandwidth, and the float32 rate outside the
# tensor cores, which also caps 32-bit integer work (XOR, popcount,
# compare) at best.  The bound is the least time the card could take for
# the work: the larger of bytes/bandwidth and ops/rate.
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.roofline import H100_SXM  # noqa: E402  (after the path)

PEAK_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
PEAK_OPS_PER_S = H100_SXM.fp32_flops
PEAK_INT8_TENSOR_OPS_PER_S = H100_SXM.int8_ops     # dense int8 tensor-core rate
PEAK_BF16_TENSOR_OPS_PER_S = H100_SXM.bf16_flops   # dense bf16 tensor-core rate
PEAK_TF32_TENSOR_OPS_PER_S = H100_SXM.tf32_flops   # dense TF32 tensor-core rate
# ex2 (MUFU.EX2) issues 16 a clock on each SM of compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table).
EX2_PER_CLOCK_PER_SM = 16
# Cycles of torch.cuda._sleep a second, above the H100's 1.98 GHz boost
# clock, so the spin outlasts the host's queueing at any clock.
SPIN_CYCLES_PER_S = 3e9
VERDICT_OPS = 10   # per pair: 2 positivity + 2 cutoff tests, sum, sub, shift, 2 min, compare
WINDOW_OPS = 4     # per pair: two window compares and their conjunction, the triangle
ENTRY_OPS = 16     # per entry: 5 compares, 4 for the positional bound, key, compare, triangle, 4 ands
HAM_OPS = 3        # per pair: the Hamming distance from an inner product and two popcounts
# The SWAR form's floor: __popc issues at a quarter of the int32 rate, 16 a
# clock on each of the H100's 132 SMs at its 1.98 GHz boost clock.
POPC_PER_S = 132 * 16 * 1.98e9

MAIN = dict(sim="jaccard", b=128, block=4096)
# Phase 4 holds host compaction to device compaction on this many rows of
# each collection (6 blocks; host compaction took 25-28 s a full collection).
HOST_COMPACTION_ROWS = 6 * 4096
# Phase 3 holds the CPU's blocked join to the card's on this many of the
# 10,200 ZIPF sets (the CPU took 19 s on all of them).
SLICE_CPU_ROWS = 5120
# Phase 20, the mesh drivers: each run's ranks are processes of their own
# (4 gloo ranks sharing the card, then one NCCL rank), ZIPF for the ring and
# SKEWED for sharded-indexed at this tau; seconds each run may take.
# forced_cap: a ring capacity per step that ZIPF's steps overflow (its 2,852
# candidates over 16 steps put more than 128 in one of them).
MESH = dict(tau=0.8, runs=(("gloo", 4), ("nccl", 1)), timeout=300, forced_cap=128)
SKEWED_TAUS = (0.8, 0.6)
WIDE_B = 1024      # the wide-bitmap paths (phases 7-8)
SERVE = dict(requests=2048, flush_every=512, append_after=1024, after_compact=256,
             delta_rows=2000, sample_per_flush=64)
# The LM serving phase: qwen3-8b at its published widths and depth, 4
# requests of 4,096 prompt tokens, 32 greedy tokens.
LM = dict(arch="qwen3-8b", batch=4, prompt=4096, gen=32)
# Flash attention, kernel against its plain version on the same card
# tensors.  float32: ROADMAP's value for this function.  bf16: both round p
# to bf16 before PV, each against its own running maximum (the kernel's
# 64-key tiles are not the plain version's chunks), and both round the
# output to bf16, so outputs of order 1 may differ by a couple of bf16
# ulps (2^-8 each).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# The LM training phase: smollm-135m at its published widths and depth, 8
# sequences of 2,048 tokens (SmolLM's context), 20 AdamW steps.
TRAIN = dict(arch="smollm-135m", batch=8, seq=2048, steps=20, lr=3e-3, warmup=5,
             ckpt_every=10)
# lse of the kernel against its plain version: |err| <= tol (1 + |lse|).
LSE_TOL = 1e-4
# Each gradient leaf of the train step through the kernel against the plain
# forward's, as relative RMS error: bf16 at full width (the LM serving
# phase's logits gate) and float32 on the reduced config; the loss relative.
GRAD_REL_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}
TRAIN_LOSS_REL_TOL = 1e-3
# Teacher-forced logits against Model.forward, as the relative RMS error of
# each step's (B, V) logits: every bf16 matmul rounds its output (2^-9
# relative), and decode (M = B rows, attention in PyTorch) rounds in other
# places than the forward pass (M = B * S rows, the flash kernel), over 36
# layers.  The same check must fail when the cache is read one position off.
LOGITS_REL_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2, reps: int = 3) -> float:
    """Device milliseconds of one ``fn()``: CUDA events around ``iters``
    back-to-back calls, over the count; the median of ``reps`` such runs.
    A spin kernel queued first holds the card until the host has queued
    every call, so host launch overhead stays out of the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int(enqueue_s * SPIN_CYCLES_PER_S) + 10_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def call_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` timed alone between two events: the
    device time plus whatever host work before its launch leaves the card
    idle (how this script timed kernels before it measured device time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int, ops_rate: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def verdict_bound(nbytes: int, pairs: int, b: int, epilogue_ops: int) -> tuple[float, str, str]:
    """The tensor-core verdict kernels' bound: the largest of the bytes over
    the memory rate, the inner products (2 b a pair) over the int8 tensor
    rate and the epilogue's integer operations over the float32 rate; with
    what bounds it ("bytes" or "operations") and which of the three terms."""
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S,
             "int8 tensor product": 2 * pairs * b / PEAK_INT8_TENSOR_OPS_PER_S,
             "epilogue": epilogue_ops / PEAK_OPS_PER_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def in_turns(kernels: dict, iters: int = 50) -> dict:
    """Device ms of each of two named calls timed in turns (a, b, b, a):
    ``{name: [first, second]}``."""
    (a, fa), (b, fb) = kernels.items()
    ta1, tb1, tb2, ta2 = (cuda_ms(f, iters) for f in (fa, fb, fb, fa))
    return {a: [ta1, ta2], b: [tb1, tb2]}


class LaunchCounts:
    """Launch counters of a set of kernel wrappers, read together; the
    wrappers that also count their launches by form (the bitmap build's,
    ``form_launches``) have those zeroed and read with them."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def zero(self) -> None:
        for f in self.wrappers.values():
            f.launches = 0
            if hasattr(f, "form_launches"):
                f.form_launches = dict.fromkeys(f.form_launches, 0)

    def read(self) -> dict:
        return {name: f.launches for name, f in self.wrappers.items()}

    def read_forms(self) -> dict:
        return {name: dict(f.form_launches) for name, f in self.wrappers.items()
                if hasattr(f, "form_launches")}


def bitmap_build_wrappers() -> dict:
    """The bitmap build's wrappers by kernel row: ``bitmap_build_set``,
    ``bitmap_build_xor``, ``bitmap_build_next``."""
    from repro_torch.kernels import bitmap_build

    return {f"bitmap_build_{m}": f for m, f in bitmap_build.WRAPPERS.items()}


# The bitmap build's launches on the join paths (phases 4-8 and 25 (c)), by
# kernel row and path, and by form: rows ``bitmap_build_*`` report them.
BUILD_LAUNCHES: dict = collections.defaultdict(dict)
BUILD_FORMS: dict = collections.defaultdict(dict)


def record_build_launches(launches: dict, forms: dict, path: str) -> None:
    """Keep a join path's bitmap-build launches (the ``bitmap_build_*`` keys
    of ``launches``) and their forms (``forms``, as
    ``LaunchCounts.read_forms`` gives them, read in the same window); every
    path builds its bitmaps through the kernel, so it must have launched
    it."""
    got = {k: v for k, v in launches.items() if k.startswith("bitmap_build_")}
    if sum(got.values()) <= 0:
        raise AssertionError(f"{path} launched no bitmap_build: {got}")
    for name, n in got.items():
        if sum(forms[name].values()) != n:
            raise AssertionError(f"{path}: {name}'s {n} launches, by form {forms[name]}")
        if n:
            BUILD_LAUNCHES[name][path] = BUILD_LAUNCHES[name].get(path, 0) + n
            BUILD_FORMS[name][path] = forms[name]


def kernel_row(name, source, replaces, *, err, ms, plain_ms, bound, path,
               library_ms=None) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; ``path`` names the run
    whose launches it reports (``launches`` is filled in at the end)."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
            "path": path}


def max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.dtype}{list(got.shape)} != "
                             f"{want.dtype}{list(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def max_err_float(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference of two float tensors of one shape and type."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.dtype}{list(got.shape)} != "
                             f"{want.dtype}{list(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max())


def phase_build() -> float:
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {seconds:.2f} s, one nvcc per source in parallel: " +
        ", ".join(f"{n} {s:.2f} s" for n, s in sorted(_build.BUILD_SECONDS.items())))
    for name in libs:
        for line in (_build.build_dir() / f"lib{name}.log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    return seconds


def set_operands(rng, nr, ns, b, dev, *, universe=150, max_len=60):
    """Bitmaps (Xor, int32[n, b/32]) and sizes of random sets drawn from a
    small universe, so that many pairs overlap and the verdict keeps some;
    every fourth set is empty."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core.constants import PAD_TOKEN

    def side(n):
        lens = rng.integers(1, max_len, n).astype(np.int32)
        lens[::4] = 0
        toks = np.full((n, max_len), PAD_TOKEN, np.int32)
        for i, l in enumerate(lens):
            toks[i, :l] = np.sort(rng.choice(universe, size=l, replace=False))
        t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
        return bm.generate_bitmaps(t, l, b, method="xor"), l

    (wr, lr), (ws, ls) = side(nr), side(ns)
    return wr, ws, lr, ls


def mxu_operands(rng, nr, ns, w, kind, dev):
    """Operands of the tensor-core verdict sweep: random words (lengths
    below 40, every fifth row empty), real bitmaps of random sets, or words
    and lengths bent to all-pass, all-prune or empty rows."""
    if kind == "sets":
        return set_operands(rng, nr, ns, 32 * w, dev)

    def side(n):
        words = rng.integers(0, 2**32, (n, w), dtype=np.uint32).view(np.int32)
        lens = rng.integers(0, 40, n).astype(np.int32)
        lens[::5] = 0
        if kind == "all_pass":      # identical zero bitmaps, equal sizes: ub == |r|
            words[:], lens[:] = 0, 20
        elif kind == "all_prune":   # random words, tiny sets: ub < 0
            lens[:] = 2
        elif kind == "empty_rows":
            lens[::3] = 0
        return torch.from_numpy(words).to(dev), torch.from_numpy(lens).to(dev)

    (wr, lr), (ws, ls) = side(nr), side(ns)
    m = min(nr, ns)
    ws[:m:4] = wr[:m:4]   # identical rows pass
    return wr, ws, lr, ls


def check_mxu(sim, tau, wr, ws, lr, ls, *, self_join, cutoff, tiles=(256,)):
    """candidate_matrix_mxu and count_candidates_mxu (with and without the
    window, at each tile) against their plain versions, exactly.  Returns
    the verdicts kept and the window pairs and candidates counted."""
    from repro_torch.core import bounds
    from repro_torch.core.constants import COSINE
    from repro_torch.kernels import bitmap_filter, compaction, ref

    dev = wr.device
    lo, hi = (torch.from_numpy(a).to(dev)
              for a in bounds.length_window_int(sim, tau, lr.cpu().numpy()))
    table = ref.prune_table_for(sim, tau, lr, ls)
    kw = dict(key_prod=sim == COSINE, self_join=self_join, cutoff=cutoff)
    got = bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw)
    want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau, self_join=self_join,
                                    cutoff=cutoff, table=table)
    err = max_err(got, want)
    for tile in tiles:
        for window in (True, False):
            cw, cc = compaction.count_candidates_mxu_cuda(
                wr, ws, lr, ls, lo if window else None, hi if window else None, table,
                tile_r=tile, tile_s=tile, **kw)
            rw, rc = ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, sim=sim, tau=tau,
                                              self_join=self_join, cutoff=cutoff,
                                              window=window, tile_r=tile, tile_s=tile,
                                              table=table)
            err = max(err, max_err(cw, rw), max_err(cc, rc))
            if window:
                counted = (int(rw.sum()), int(rc.sum()))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"tensor-core verdict kernels != plain versions: {sim} {tau} "
                             f"{list(wr.shape)}x{list(ws.shape)} self_join={self_join} "
                             f"cutoff={cutoff} tiles={tiles}: error {err}")
    return int(want.sum()), *counted


def phase_dense_kernels(seed: int, main_prep) -> list[dict]:
    """candidate_matrix, count_candidates (both forms: SWAR and tensor-core)
    and hamming_matrix: exact parity with their plain versions over a sweep
    and at the blocked path's shape (W = 4), then timing there, the two
    forms of each verdict in turns."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import bounds, expected, verify
    from repro_torch.kernels import bitmap_filter, compaction, ref
    from repro_torch.core.constants import COSINE

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def check(sim, tau, wr, ws, lr, ls, *, self_join, cutoff, tile=256):
        lo, hi = bounds.length_window_int(sim, tau, lr.cpu().numpy())
        lo, hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        table = ref.prune_table_for(sim, tau, lr, ls)
        kp = sim == COSINE
        got = bitmap_filter.candidate_matrix_cuda(
            wr, ws, lr, ls, table, key_prod=kp, self_join=self_join, cutoff=cutoff)
        want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau,
                                        self_join=self_join, cutoff=cutoff, table=table)
        err_c = max_err(got, want)
        cw, cc = compaction.count_candidates_cuda(
            wr, ws, lr, ls, lo, hi, table, key_prod=kp, self_join=self_join,
            cutoff=cutoff, tile_r=tile, tile_s=tile)
        rw, rc = ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, sim=sim, tau=tau,
                                          self_join=self_join, cutoff=cutoff,
                                          tile_r=tile, tile_s=tile, table=table)
        err_n = max(max_err(cw, rw), max_err(cc, rc))
        err_h = max_err(bitmap_filter.hamming_matrix_cuda(wr, ws),
                        ref.hamming_matrix_ref(wr, ws))
        check_mxu(sim, tau, wr, ws, lr, ls, self_join=self_join, cutoff=cutoff, tiles=(tile,))
        torch.cuda.synchronize()
        if err_c or err_n or err_h:
            raise AssertionError(f"kernel != plain version: {sim} {tau} "
                                 f"{list(wr.shape)}x{list(ws.shape)} self_join={self_join} "
                                 f"cutoff={cutoff} errs={err_c},{err_n},{err_h}")
        return err_c, err_n, err_h, int(want.sum()), int(rc.sum()), int(rw.sum())

    # The sweep of the CPU tests: odd sizes, W in {1, 4, 128}, self-join,
    # every key kind, the cutoff hit and not, empty rows, tiles that do not
    # divide the grid.  Every kernel of this phase, both forms.
    for (nr, ns, w, sim, tau, sj, cutoff, tile) in [
            (333, 517, 1, "jaccard", 0.6, False, 1 << 30, 256),
            (517, 517, 4, "cosine", 0.4, True, 1 << 30, 256),
            (300, 200, 128, "dice", 0.3, False, 40, 64),
            (257, 65, 128, "overlap", 3.0, True, 1 << 30, 32),
            (1000, 999, 4, "jaccard", 0.3, False, 20, 256)]:
        wr, ws, lr, ls = set_operands(rng, nr, ns, 32 * w, dev)
        if sj:
            ws, ls = wr, lr
        errs = check(sim, tau, wr, ws, lr, ls, self_join=sj, cutoff=cutoff, tile=tile)
        log(f"parity sweep {nr}x{ns} W={w} {sim} tau={tau} self_join={sj} "
            f"cutoff={cutoff} tile={tile}: exact, {errs[3]} candidates")

    # The tensor-core verdict kernels over their own edges: W in {1, 4, 8,
    # 12, 32, 128}, NR and NS on the 128 x 256 work tiles' edges (NS % 16 !=
    # 0 in four), all-pass / all-prune / empty rows, the four similarities
    # (cosine keys lr*ls), both sides of the cutoff, self-join, count tiles
    # 32 / 64 / 256.
    sims = [("jaccard", 0.6), ("cosine", 0.75), ("dice", 0.5), ("overlap", 3.0)]
    kinds = ("random", "sets", "all_pass", "all_prune", "empty_rows")
    for (nr, ns, w) in [(127, 129, 1), (128, 257, 4), (129, 255, 8), (255, 256, 12),
                        (256, 128, 32), (257, 127, 128)]:
        totals = np.zeros(3, np.int64)
        for k, kind in enumerate(kinds):
            wr, ws, lr, ls = mxu_operands(rng, nr, ns, w, kind, dev)
            for i, (sim, tau) in enumerate(sims):
                sj = (i + k) % 2 == 1
                cutoff = 12 if (i + k) % 3 == 0 else 1 << 30
                r = check_mxu(sim, tau, wr, wr if sj else ws, lr, lr if sj else ls,
                              self_join=sj, cutoff=cutoff, tiles=(32, 64, 256))
                totals += r
        log(f"tensor-core verdict parity {nr}x{ns} W={w}: candidate_matrix_mxu and "
            f"count_candidates_mxu exact over {'/'.join(kinds)} x 4 sims x tiles "
            f"32/64/256 x window on/off; {totals[0]} verdicts kept, {totals[1]} window "
            f"pairs, {totals[2]} candidates counted")

    # The blocked path's shape: the first two 4096-row blocks of real data.
    tau = 0.8
    words = main_prep.bitmap_words(MAIN["b"], "xor")
    _, lengths = main_prep.device_arrays()
    blk = MAIN["block"]
    wr, ws = words[:blk], words[blk:2 * blk]
    lr, ls = lengths[:blk], lengths[blk:2 * blk]
    cutoff = expected.cutoff_point("xor", MAIN["b"], tau)
    errs = check("jaccard", tau, wr, ws, lr, ls, self_join=False, cutoff=cutoff)
    diag = check("jaccard", tau, wr, wr, lr, lr, self_join=True, cutoff=cutoff)
    log(f"parity main shape {blk}x{blk} W={wr.shape[1]}: exact, both forms; off-diagonal "
        f"block {errs[3]} candidates ({errs[4]} in the window of {errs[5]} window pairs), "
        f"diagonal block {diag[3]} ({diag[4]} of {diag[5]})")

    table = verify.prune_table_dev("jaccard", tau, main_prep.max_len, main_prep.max_len, dev)
    lo, hi = (torch.from_numpy(a).to(dev) for a in
              bounds.length_window_int("jaccard", tau, lr.cpu().numpy()))
    kw = dict(key_prod=False, self_join=False, cutoff=cutoff)
    cand_t = in_turns({
        "swar": lambda: bitmap_filter.candidate_matrix_cuda(wr, ws, lr, ls, table, **kw),
        "mxu": lambda: bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw)})
    count_t = in_turns({
        "swar": lambda: compaction.count_candidates_cuda(
            wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw),
        "mxu": lambda: compaction.count_candidates_mxu_cuda(
            wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw)})
    ms_c, ms_n = cand_t["swar"][0], count_t["swar"][0]
    ms_h = cuda_ms(lambda: bitmap_filter.hamming_matrix_cuda(wr, ws), 50)
    # Yardstick: one PyTorch call computing the same Hamming matrix from the
    # unpacked bits (float planes; p = 0 counts the differing coordinates).
    fr, fs = (bm.unpack_bits(w).float() for w in (wr, ws))
    lib_h = cuda_ms(lambda: torch.cdist(fr, fs, p=0), 10)
    if not torch.equal(torch.cdist(fr, fs, p=0).to(torch.int32),
                       bitmap_filter.hamming_matrix_cuda(wr, ws)):
        raise AssertionError("torch.cdist(p=0) disagrees with hamming_matrix")
    del fr, fs
    rkw = dict(sim="jaccard", tau=tau, self_join=False, cutoff=cutoff, table=table)
    plain_c = cuda_ms(lambda: ref.candidate_matrix_ref(wr, ws, lr, ls, **rkw), 10)
    plain_n = cuda_ms(lambda: ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, **rkw), 10)
    plain_h = cuda_ms(lambda: ref.hamming_matrix_ref(wr, ws), 10)

    pairs, w = blk * blk, wr.shape[1]
    words_bytes = 2 * blk * w * 4
    in_bytes = words_bytes + 2 * blk * 4 + table.numel() * 4
    n_bytes = in_bytes + 2 * blk * 4 + 2 * (blk // 256) ** 2 * 4
    b_c = bound_ms(in_bytes + pairs, pairs * (3 * w + VERDICT_OPS))
    b_n = bound_ms(n_bytes, pairs * (3 * w + VERDICT_OPS + WINDOW_OPS))
    b_h = bound_ms(words_bytes + 4 * pairs, pairs * 3 * w)
    # The tensor-core forms: every pair needs its verdict; the count needs
    # the window test of every pair and the product and verdict of the
    # window pairs only (errs[5] of them here).
    n_win = errs[5]
    b_cm = verdict_bound(in_bytes + pairs, pairs, 32 * w, pairs * (VERDICT_OPS + HAM_OPS))
    b_nm = verdict_bound(n_bytes, n_win, 32 * w,
                         pairs * WINDOW_OPS + n_win * (VERDICT_OPS + HAM_OPS))
    popc_ms = pairs * w / POPC_PER_S * 1e3
    log(f"timing at {blk}x{blk} W={w}, device time, in turns (swar, mxu, mxu, swar): "
        f"candidate_matrix swar {cand_t['swar'][0]:.4f} / {cand_t['swar'][1]:.4f} ms, mxu "
        f"{cand_t['mxu'][0]:.4f} / {cand_t['mxu'][1]:.4f} ms (plain {plain_c:.3f} ms; bound "
        f"swar {b_c[0]:.4f} ms by {b_c[1]}, mxu {b_cm[0]:.4f} ms by the {b_cm[2]}); "
        f"count_candidates swar {count_t['swar'][0]:.4f} / {count_t['swar'][1]:.4f} ms, mxu "
        f"{count_t['mxu'][0]:.4f} / {count_t['mxu'][1]:.4f} ms (plain {plain_n:.3f} ms; bound "
        f"swar {b_n[0]:.4f} ms by {b_n[1]}, mxu {b_nm[0]:.4f} ms by the {b_nm[2]}); the "
        f"SWAR form's popcount floor {popc_ms:.4f} ms; hamming_matrix {ms_h:.4f} ms (plain "
        f"{plain_h:.3f} ms, bound {b_h[0]:.4f} ms by {b_h[1]}, torch.cdist(p=0) {lib_h:.4f} ms)")
    src = "src/repro_torch/kernels/csrc/"
    swar_path = "off the main paths: the blocked join under impl='swar' over 10,200 ZIPF sets"
    mxu_path = ("full size, blocked: ZIPF tau=0.8 + UNIFORM tau=0.5 (b=128) and the store "
                f"at b={WIDE_B}")
    return [
        kernel_row("candidate_matrix", src + "bitmap_filter.cu",
                   "src/repro/kernels/bitmap_filter.py:151", err=errs[0], ms=ms_c,
                   plain_ms=plain_c, bound=b_c, path=swar_path),
        kernel_row("count_candidates", src + "compaction.cu",
                   "src/repro/kernels/compaction.py:52", err=errs[1], ms=ms_n,
                   plain_ms=plain_n, bound=b_n, path=swar_path),
        kernel_row("hamming_matrix", src + "bitmap_filter.cu",
                   "src/repro/kernels/bitmap_filter.py:77", err=errs[2], ms=ms_h,
                   plain_ms=plain_h, bound=b_h, library_ms=lib_h,
                   path="off the main paths: ops.hamming_matrix over 10,200 ZIPF sets"),
        kernel_row("candidate_matrix_mxu", src + "bitmap_filter.cu (planes_mma.cuh)",
                   "src/repro/kernels/bitmap_filter.py:151", err=0, ms=cand_t["mxu"][0],
                   plain_ms=plain_c, bound=b_cm[:2], path=mxu_path)
        | {"bound_term": b_cm[2], "ms_turns": cand_t["mxu"], "swar_ms_turns": cand_t["swar"],
           "popcount_floor_ms": popc_ms},
        kernel_row("count_candidates_mxu", src + "compaction.cu (planes_mma.cuh)",
                   "src/repro/kernels/compaction.py:52", err=0, ms=count_t["mxu"][0],
                   plain_ms=plain_n, bound=b_nm[:2], path=mxu_path)
        | {"bound_term": b_nm[2], "ms_turns": count_t["mxu"],
           "swar_ms_turns": count_t["swar"], "popcount_floor_ms": popc_ms},
    ]


@contextlib.contextmanager
def capture_calls(module, name: str, into: list):
    """Record the arguments of every call of ``module.name`` while inside.
    The wrapper carries its own launch counter (the wrapped function counts
    on whatever its module name points at), so captured calls leave the
    real counter untouched."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        into.append((args, kw))
        return orig(*args, **kw)

    for attr, value in vars(orig).items():   # launches, instance_launches, lse_launches
        if attr.endswith("launches"):
            setattr(wrapper, attr, dict.fromkeys(value, 0) if isinstance(value, dict) else 0)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


class StageForms:
    """The two stage kernels, their plain versions and the unfused
    compositions (``impl``: the PyTorch ops around ``entry_filter`` and
    ``pair_verdict``) on one chunk step's operands, the verdict's at
    ``words`` = ``(words_r, probe_words)`` and at the candidates of this
    expansion, or at ``cands`` = ``(cand_r, cand_s, slot_ok)`` when given
    (a sharded chunk's slice of the gathered candidates)."""

    def __init__(self, args, st, words, unfused_impl: str, cands=None):
        from repro_torch.core.constants import COSINE
        from repro_torch.index import candidates
        from repro_torch.kernels import ops, postings, ref

        self.st, self.table = st, st["table"]
        self.eops = candidates.expand_filter_operands(args, st)
        sim, tau, cap = st["sim"], st["tau"], st["cap"]
        kp = sim == COSINE
        ekw = dict(sim=sim, tau=tau, cap=cap, lp=st["lp"], self_join=st["self_join"],
                   table=self.table)
        self.expand = lambda: postings.expand_filter_cuda(  # noqa: E731
            *self.eops, self.table, cap=cap, lp=st["lp"], key_prod=kp,
            self_join=st["self_join"])
        self.expand_plain = lambda: ref.expand_filter_ref(*self.eops, **ekw)  # noqa: E731
        self.expand_unfused = lambda: ops.expand_filter(  # noqa: E731
            *self.eops, **ekw, impl=unfused_impl)
        if cands is None:
            rr, ss = self.expand_plain()
            cr, cs, n_gen = candidates.dedup_pairs(rr, ss, cap)
            cands = cr, cs, torch.arange(cap, device=cr.device) < n_gen
        cr, cs, self.slot_ok = cands
        wr, ws = words
        self.vargs = (args[0], args[1], wr, args[9], args[10], ws, cr, cs, self.slot_ok,
                      args[15])
        vkw = dict(sim=sim, tau=tau, cutoff=st["cutoff"], table=self.table)
        self.verdict = lambda: postings.verdict_verify_cuda(  # noqa: E731
            *self.vargs[:9], self.table, args[15], key_prod=kp, cutoff=st["cutoff"])
        self.verdict_plain = lambda: ref.verdict_verify_ref(*self.vargs, **vkw)  # noqa: E731
        self.verdict_unfused = lambda: ops.verdict_verify(  # noqa: E731
            *self.vargs, **vkw, impl=unfused_impl)

    def check(self, what: str) -> tuple[dict, dict]:
        """Both kernels and the unfused compositions against the plain
        versions, bit for bit or raise: the counts of this chunk's funnel, and
        each kernel's measured largest error (0)."""
        e_want, v_want = self.expand_plain(), self.verdict_plain()
        errs = {"expand_filter": max(max_err(a, b) for got in (self.expand(),
                                                              self.expand_unfused())
                                     for a, b in zip(got, e_want)),
                "verdict_verify": max(max_err(a, b) for got in (self.verdict(),
                                                               self.verdict_unfused())
                                      for a, b in zip(got, v_want))}
        torch.cuda.synchronize()
        if any(errs.values()):
            raise AssertionError(f"stage kernels != plain versions at {what}: {errs}")
        counts = {"expanded": int(self.eops[2][-1]),
                  "kept": int((e_want[0] != 2**31 - 1).sum()),
                  "generated": int(self.slot_ok.sum()), "bitmap": int(v_want[0].sum()),
                  "verified": int(v_want[1].sum())}
        return counts, errs

    def bounds(self) -> tuple:
        """The least time of each kernel's work on these inputs: bytes over
        the memory rate against integer operations over the float32 rate.
        Bytes count each input element read once: the postings the chunk's
        segments cover, the distinct word rows the generated candidates
        name, and the non-PAD tokens of the distinct token rows the bitmap's
        survivors name.  Operations count this chunk's work: ENTRY_OPS an
        expanded entry, the verdict a candidate, and for each survivor one
        binary search of s's len_s tokens for each of r's len_r."""
        cap = self.st["cap"]
        rng, cnt, seg_end, post_set = self.eops[:4]
        c, npost = self.eops[6].shape[0], post_set.shape[0]
        n_exp = min(int(seg_end[-1]), cap)
        live = cnt > 0
        edges = torch.zeros(npost + 1, dtype=torch.int32, device=cnt.device)
        edges.index_add_(0, rng[live], torch.ones_like(rng[live]))
        edges.index_add_(0, (rng + cnt)[live].clamp(max=npost), -torch.ones_like(rng[live]))
        covered = min(int((torch.cumsum(edges, 0)[:npost] > 0).sum()), n_exp)
        tab = self.table.numel() * 4
        b_e = bound_ms(covered * 12 + cap * 8 + rng.shape[0] * 12 + c * 12 + tab,
                       n_exp * ENTRY_OPS)
        _, len_r, wr, _, len_s, ws, cand_r, cand_s, slot_ok, need = self.vargs
        w = wr.shape[1]
        cand_mask = self.verdict_plain()[0]
        n_gen, n_bm = int(slot_ok.sum()), int(cand_mask.sum())
        distinct = lambda idx: torch.unique(idx)  # noqa: E731
        gen_rows = distinct(cand_r[slot_ok]).numel() + distinct(cand_s[slot_ok]).numel()
        lr, ls = len_r[cand_r[cand_mask]].long(), len_s[cand_s[cand_mask]].long()
        tokens = (int(len_r[distinct(cand_r[cand_mask])].sum())
                  + int(len_s[distinct(cand_s[cand_mask])].sum()))
        nbytes = (cap * 3 + n_gen * 8 + gen_rows * (4 * w + 4) + tokens * 4 + tab
                  + need.numel() * 4)
        steps = torch.ceil(torch.log2(ls.double() + 1)).long()
        b_v = bound_ms(nbytes, n_gen * (3 * w + VERDICT_OPS) + int((lr * steps).sum()))
        return b_e, b_v


def stage_sweep(seed: int) -> int:
    """The stage kernels against their plain versions (and the unfused
    compositions) over the CPU tests' grid: 4 similarities x tau in {0.5,
    0.6, 0.8, 0.95} (overlap: tau * 8 tokens) x self-join and R x S, the
    verdict at W in {1, 4, 32}, on small seeded collections in one chunk;
    and a segment of ~1,500 postings (longer than a kernel block), a stream
    that fills its capacity, PAD probe rows, a cutoff below the lengths and
    a later chunk's offset.  Returns the cases checked."""
    from repro_torch.core import engine
    from repro_torch.core.collection import from_lists
    from repro_torch.core.constants import PAD_TOKEN
    from repro_torch.data.collections import near_duplicate_lists, shared_token_lists
    from repro_torch.index import candidates

    sets_r = near_duplicate_lists(64, seed + 3)
    sets_s = near_duplicate_lists(40, seed + 4)
    sets_s[:8] = [s[:-1] or s for s in sets_r[:40:5]]
    prep_r = engine.prepare(from_lists(sets_r, pad_to=16), "cuda")
    prep_s = engine.prepare(from_lists(sets_s, pad_to=16), "cuda")
    long_seg = engine.prepare(from_lists(shared_token_lists(1500, seed + 5),
                                         pad_to=16), "cuda")

    def specs(preps, sim, tau):
        out = [candidates.chunk_step_spec(*preps, sim=sim, tau=tau, b=32 * w,
                                          probe_block=128) for w in (1, 4, 32)]
        return list(out[0][0]), dict(out[0][1]), [(a[2], a[11]) for a, _ in out]

    cases = 0

    def run(args, st, words, what):
        nonlocal cases
        for pair in words:
            unfused = "mxu" if pair[0].shape[1] * 32 >= 512 else "swar_tiled"
            StageForms(args, st, pair, unfused).check(what)
            cases += 1

    for sim in ("jaccard", "cosine", "dice", "overlap"):
        for tau in (0.5, 0.6, 0.8, 0.95):
            th = float(max(1, round(tau * 8))) if sim == "overlap" else tau
            for preps in ((prep_r, None), (prep_r, prep_s)):
                run(*specs(preps, sim, th), f"sweep {sim} {th}")
    run(*specs((long_seg, None), "jaccard", 0.5), "a long segment")
    for edge in ("fills_cap", "pad_probe_rows", "cutoff_below_lengths", "probe_offset"):
        args, st, words = specs((prep_r, None if edge == "probe_offset" else prep_s),
                                "jaccard", 0.5)
        if edge == "fills_cap":
            st["cap"] = int(candidates.expand_filter_operands(args, st)[2][-1])
        elif edge == "pad_probe_rows":
            for i, fill in ((9, PAD_TOKEN), (10, 0), (12, 0), (13, 0), (14, 0)):
                a = args[i]
                args[i] = torch.cat([a, torch.full((5, *a.shape[1:]), fill, dtype=a.dtype,
                                                   device=a.device)])
            words = [(wr, torch.cat([ws, ws.new_zeros(5, ws.shape[1])])) for wr, ws in words]
        elif edge == "cutoff_below_lengths":
            st["cutoff"] = 2
        else:
            args[16] = 7
        run(args, st, words, edge)
    return cases


def time_stage(forms: StageForms, iters: int) -> dict:
    """Each stage kernel in turns with the unfused composition (kernel,
    composition, composition, kernel), the plain versions, and the bounds."""
    t_e = in_turns({"kernel": forms.expand, "unfused": forms.expand_unfused}, iters)
    t_v = in_turns({"kernel": forms.verdict, "unfused": forms.verdict_unfused}, iters)
    plain_e = cuda_ms(forms.expand_plain, max(2, iters // 4), warmup=1, reps=1)
    plain_v = cuda_ms(forms.verdict_plain, max(2, iters // 4), warmup=1, reps=1)
    b_e, b_v = forms.bounds()
    return {"expand_filter": {"ms_turns": t_e["kernel"], "unfused_ms_turns": t_e["unfused"],
                              "plain_ms": plain_e, "bound": b_e},
            "verdict_verify": {"ms_turns": t_v["kernel"], "unfused_ms_turns": t_v["unfused"],
                               "plain_ms": plain_v, "bound": b_v}}


def host_us(fn, n: int = 300) -> float:
    """Host microseconds of one ``fn()`` call: ``n`` calls queued back to
    back (their kernels run behind), over the count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def phase_postings_kernels(seed: int, skewed_prep) -> list[dict]:
    """The stage kernels (expand_filter, verdict_verify) and the unfused path's
    postings kernels (entry_filter, pair_verdict_tiled, pair_verdict):
    exact parity with their plain versions over a sweep and at the indexed
    path's shapes (the first probe chunk of SKEWED tau = 0.8 and 0.6), then
    timing: each stage kernel in turns with the unfused composition, the
    unfused path's kernels alone, and each wrapper's host cost per call.  Returns
    the kernel rows."""
    from repro_torch.core import bounds
    from repro_torch.core.constants import COSINE
    from repro_torch.index import candidates
    from repro_torch.kernels import _build, postings, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def check_entries(ents, valid, table, sim, tau, self_join):
        got = postings.entry_filter_cuda(*ents, valid, table, key_prod=sim == COSINE,
                                         self_join=self_join)
        want = ref.entry_filter_ref(*ents, valid, sim=sim, tau=tau, self_join=self_join,
                                    table=table)
        err = max_err(got, want)
        if err:
            raise AssertionError(f"entry_filter != plain: G={len(valid)} {sim} {self_join}")
        return err, int(want.sum())

    def check_pairs(wr, ws, lr, ls, table, sim, tau, cutoff):
        want = ref.pair_verdict_ref(wr, ws, lr, ls, sim=sim, tau=tau, cutoff=cutoff,
                                    table=table)
        kw = dict(key_prod=sim == COSINE, cutoff=cutoff)
        e_t = max_err(postings.pair_verdict_tiled_cuda(wr, ws, lr, ls, table, **kw), want)
        e_w = max_err(postings.pair_verdict_cuda(wr, ws, lr, ls, table, **kw), want)
        if e_t or e_w:
            raise AssertionError(f"pair verdict != plain: {list(wr.shape)} {sim} {cutoff}")
        return e_t, e_w, int(want.sum())

    # The sweep of tests/test_postings_kernel.py, widened to the staged and
    # the lane-group forms of the tiled kernel (W <= 8 and W > 8).
    for g in (5, 100, 1024, 2500, 3000):
        cols = [rng.integers(1, 30, g), rng.integers(0, 10, g), rng.integers(1, 30, g),
                rng.integers(0, 10, g), rng.integers(0, 15, g), rng.integers(8, 40, g),
                rng.integers(0, 60, g), rng.integers(0, 60, g)]
        cols[0][::5] = 0
        cols[2][1::5] = 0
        ents = [as_t(c.astype(np.int32)) for c in cols]
        valid = as_t(rng.random(g) > 0.2)
        kept = []
        for sim, tau in (("jaccard", 0.8), ("cosine", 0.6), ("overlap", 3.0)):
            table = as_t(bounds.prune_table(sim, tau, 30, 30))
            for sj in (False, True):
                kept.append(check_entries(ents, valid, table, sim, tau, sj)[1])
        for w in (1, 4, 8, 12, 128):
            wr = rng.integers(0, 2**32, (g, w), dtype=np.uint32)
            ws = rng.integers(0, 2**32, (g, w), dtype=np.uint32)
            ws[::3] = wr[::3]
            lr = rng.integers(0, 40, g).astype(np.int32)
            lr[::7] = 0
            ls = rng.integers(0, 40, g).astype(np.int32)
            t = [as_t(wr.view(np.int32)), as_t(ws.view(np.int32)), as_t(lr), as_t(ls)]
            for sim, tau in (("jaccard", 0.7), ("cosine", 0.6), ("dice", 0.75)):
                table = ref.prune_table_for(sim, tau, t[2], t[3])
                for cutoff in (1 << 30, 12):
                    check_pairs(*t, table, sim, tau, cutoff)
        log(f"parity sweep G={g}: entry_filter exact ({kept} kept), pair_verdict_tiled and "
            f"pair_verdict exact at W in (1, 4, 8, 12, 128)")
    cases = stage_sweep(seed)
    log(f"parity sweep, stage kernels: expand_filter and verdict_verify exact against their "
        f"plain versions and the unfused compositions in {cases} cases (4 sims x 4 taus x "
        f"self / R x S x W in (1, 4, 32), and the edges)")

    # The indexed path's shapes: the first chunk of the SKEWED self-join at
    # each tau, through the stage kernels and, for the unfused path's kernels, the
    # operands they take there under the unfused composition.
    chunks = {}
    for tau in SKEWED_TAUS:
        args, st = candidates.chunk_step_spec(
            skewed_prep, sim=MAIN["sim"], tau=tau, b=MAIN["b"], probe_block=MAIN["block"])
        forms = StageForms(args, st, (args[2], args[11]), "swar_tiled")
        counts, errs = forms.check(f"the first SKEWED tau={tau} chunk")
        chunks[tau] = (args, st, forms, errs)
        log(f"parity main shape (first SKEWED tau={tau} chunk, cap {st['cap']}): "
            f"expand_filter and verdict_verify exact against their plain versions and the "
            f"unfused composition; funnel {json.dumps(counts)}")
    args, statics = chunks[SKEWED_TAUS[0]][:2]
    ent_calls, pair_calls = [], []
    with capture_calls(postings, "entry_filter_cuda", ent_calls), \
            capture_calls(postings, "pair_verdict_tiled_cuda", pair_calls):
        candidates._indexed_chunk_step(*args, **dict(statics, impl="swar_tiled"))
    (ent_args, ent_kw), = ent_calls
    (pair_args, pair_kw), = pair_calls
    ents, valid, table = list(ent_args[:8]), ent_args[8], ent_args[9]
    sim, tau, cutoff = MAIN["sim"], SKEWED_TAUS[0], pair_kw["cutoff"]
    err_e, kept = check_entries(ents, valid, table, sim, tau, ent_kw["self_join"])
    wr, ws, lr, ls, _ = pair_args
    err_t, err_w, passed = check_pairs(wr, ws, lr, ls, table, sim, tau, cutoff)
    g_e, g_p, w = valid.shape[0], wr.shape[0], wr.shape[1]
    log(f"parity main shape (first SKEWED tau={tau} chunk, cap {statics['cap']}, the "
        f"unfused composition): entry_filter G={g_e} exact, {kept} kept of "
        f"{int(valid.sum())} valid; pair verdicts G={g_p} W={w} exact, {passed} pass")

    ekw = dict(key_prod=False, self_join=ent_kw["self_join"])
    pkw = dict(key_prod=False, cutoff=cutoff)
    ms_e = cuda_ms(lambda: postings.entry_filter_cuda(*ents, valid, table, **ekw), 50)
    ms_t = cuda_ms(lambda: postings.pair_verdict_tiled_cuda(wr, ws, lr, ls, table, **pkw), 50)
    ms_w = cuda_ms(lambda: postings.pair_verdict_cuda(wr, ws, lr, ls, table, **pkw), 50)
    plain_e = cuda_ms(lambda: ref.entry_filter_ref(*ents, valid, sim=sim, tau=tau,
                                                   self_join=ekw["self_join"], table=table), 10)
    plain_p = cuda_ms(lambda: ref.pair_verdict_ref(wr, ws, lr, ls, sim=sim, tau=tau,
                                                   cutoff=cutoff, table=table), 10)
    tab_bytes = table.numel() * 4
    b_e = bound_ms(g_e * (8 * 4 + 1 + 1) + tab_bytes, g_e * ENTRY_OPS)
    b_p = bound_ms(g_p * (2 * w * 4 + 2 * 4 + 1) + tab_bytes, g_p * (3 * w + VERDICT_OPS))
    log(f"timing at the first chunk: entry_filter {ms_e:.4f} ms (plain {plain_e:.3f} ms, "
        f"bound {b_e[0]:.4f} ms by {b_e[1]}); pair_verdict_tiled {ms_t:.4f} ms, "
        f"pair_verdict {ms_w:.4f} ms (plain {plain_p:.3f} ms, bound {b_p[0]:.4f} ms "
        f"by {b_p[1]})")

    stage = {}
    for tau, (_, st, forms, _) in chunks.items():
        stage[tau] = time_stage(forms, 20 if tau >= 0.8 else 5)
        for name, t in stage[tau].items():
            log(f"timing at the first SKEWED tau={tau} chunk (cap {st['cap']}), device time "
                f"in turns (kernel, unfused composition, composition, kernel): {name} "
                f"{t['ms_turns'][0]:.4f} / {t['ms_turns'][1]:.4f} ms, the unfused "
                f"composition {t['unfused_ms_turns'][0]:.4f} / {t['unfused_ms_turns'][1]:.4f} "
                f"ms; plain {t['plain_ms']:.3f} ms; bound {t['bound'][0]:.5f} ms by "
                f"{t['bound'][1]} ({t['bound'][0] / min(t['ms_turns']):.1%} of it)")

    # The wrappers' host cost per call: the ctypes entry looked up once per
    # library, and looked up afresh on every call (the lookup's own cost).
    forms = chunks[SKEWED_TAUS[0]][2]
    calls = {"entry_filter": lambda: postings.entry_filter_cuda(*ents, valid, table, **ekw),
             "pair_verdict_tiled": lambda: postings.pair_verdict_tiled_cuda(
                 wr, ws, lr, ls, table, **pkw),
             "expand_filter": forms.expand, "verdict_verify": forms.verdict}
    host = {}
    for name, fn in calls.items():
        fresh = lambda fn=fn: (_build._functions.clear(), fn())  # noqa: E731
        host[name] = {"cached": host_us(fn), "fresh_lookup": host_us(fresh),
                      "cached_again": host_us(fn)}
    log(f"wrapper host cost, microseconds a call (entry looked up once per library / "
        f"afresh each call / once again): {json.dumps(host)}")

    src = "src/repro_torch/kernels/csrc/postings.cu"
    old_path = ("full size, indexed, impl='swar_tiled' (the unfused composition): SKEWED "
                "tau=0.8 + 0.6 self-joins")
    new_path = "full size, indexed: SKEWED tau=0.8 + 0.6, self-joins and probes"
    rows = [
        kernel_row("entry_filter", src, "src/repro/kernels/postings.py:89", err=err_e,
                   ms=ms_e, plain_ms=plain_e, bound=b_e, path=old_path)
        | {"host_us": host["entry_filter"]},
        kernel_row("pair_verdict_tiled", src, "src/repro/kernels/postings.py:220",
                   err=err_t, ms=ms_t, plain_ms=plain_p, bound=b_p, path=old_path)
        | {"host_us": host["pair_verdict_tiled"]},
        kernel_row("pair_verdict", src, "src/repro/kernels/postings.py:169", err=err_w,
                   ms=ms_w, plain_ms=plain_p, bound=b_p,
                   path="off the main paths: indexed join, impl='swar', 10,200 SKEWED sets"),
    ]
    for name, replaces in (("expand_filter", "src/repro/kernels/postings.py:89"),
                           ("verdict_verify", "src/repro/kernels/postings.py:220")):
        t = stage[SKEWED_TAUS[0]][name]
        err = max(chunk[3][name] for chunk in chunks.values())
        rows.append(kernel_row(name, src, replaces, err=err, ms=t["ms_turns"][0],
                               plain_ms=t["plain_ms"], bound=t["bound"], path=new_path)
                    | {"ms_turns": t["ms_turns"], "unfused_ms_turns": t["unfused_ms_turns"],
                       "host_us": host[name],
                       "at_tau0.6": {k: v for k, v in stage[SKEWED_TAUS[1]][name].items()
                                     if k != "bound"}
                       | {"bound_ms": stage[SKEWED_TAUS[1]][name]["bound"][0]}})
    return rows


def _join(prep, tau, compaction):
    from repro_torch.core import join

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs, stats = join.blocked_bitmap_join_prepared(
        prep, sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
        compaction=compaction, return_stats=True)
    torch.cuda.synchronize()
    return pairs, stats, time.perf_counter() - t0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(a, b, what):
    (pa, sa), (pb, sb) = a, b
    if not np.array_equal(pa, pb) or sa.to_dict() != sb.to_dict():
        raise AssertionError(f"{what}: {len(pa)} vs {len(pb)} pairs\n{sa}\n{sb}")


def phase_slice(zipf_col, skewed_col) -> dict:
    """Card against CPU on 10,000-set collections.  Also drives the kernels
    that no full-size path runs, each through its entry point with its
    counter zeroed just before and read just after: ``pair_verdict`` (the
    indexed join under ``impl="swar"``), the SWAR ``candidate_matrix`` and
    ``count_candidates`` (the blocked join under ``impl="swar"``),
    ``hamming_matrix`` and ``bitplane_hamming`` (``ops.hamming_matrix``
    over the ZIPF collection's words at b = 128 and, under
    ``impl="mxu"``, at b = 1024), ``pair_verdict_bitplane`` (the indexed
    join at b = 1024 under ``impl="mxu"``).  The indexed join runs under
    ``auto`` (the stage kernels), ``swar``, ``swar_tiled`` (the unfused
    composition at b = 128) and a forced small capacity: pairs and counters
    equal the CPU join's.  Returns the launches."""
    from repro_torch.core import engine, join
    from repro_torch.core.collection import Collection
    from repro_torch.index import indexed_bitmap_join
    from repro_torch.kernels import bitmap_filter, bitplane, compaction, ops, postings, ref

    tau = 0.8
    kw = dict(sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
              compaction="device", return_stats=True)
    # The CPU's blocked join takes about 19 s on all 10,200 sets: it is held
    # to the card's on the middle SLICE_CPU_ROWS of them.
    part = middle_rows(zipf_col, SLICE_CPU_ROWS)
    t0 = time.perf_counter()
    gpu = join.blocked_bitmap_join(part, **kw, device="cuda")
    t1 = time.perf_counter()
    cpu = join.blocked_bitmap_join(part, **kw, device="cpu")
    t2 = time.perf_counter()
    _same(gpu, cpu, "card vs CPU blocked join")
    if len(gpu[0]) == 0:
        raise AssertionError(f"no pairs in the middle {part.num_sets} ZIPF sets")
    log(f"slice parity, blocked, the middle {part.num_sets} of {zipf_col.num_sets} ZIPF sets: "
        f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s, {len(gpu[0])} pairs, identical; stats "
        f"{json.dumps(gpu[1].to_dict())}")
    gpu = join.blocked_bitmap_join(zipf_col, **kw, device="cuda")

    sub = Collection(tokens=zipf_col.tokens[:3000], lengths=zipf_col.lengths[:3000])
    oracle = join.naive_join(sub, MAIN["sim"], tau, device="cuda")
    got = join.blocked_bitmap_join(sub, **kw, device="cuda")[0]
    if not np.array_equal(oracle, got):
        raise AssertionError(f"naive_join {len(oracle)} pairs vs blocked {len(got)}")
    log(f"naive_join parity {sub.num_sets} sets: {len(oracle)} pairs, identical")

    swar = LaunchCounts(candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                        count_candidates=compaction.count_candidates_cuda)
    swar.zero()
    got = join.blocked_bitmap_join(zipf_col, **kw, device="cuda", impl="swar")
    launches = swar.read()
    _same(got, gpu, "card impl='swar' vs impl='auto' blocked join")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the impl='swar' blocked join never launched: {launches}")
    log(f"SWAR verdict path: the blocked join under impl='swar' over {zipf_col.num_sets} "
        f"ZIPF sets, identical to impl='auto' (the tensor-core verdict), {len(gpu[0])} "
        f"pairs; launches {json.dumps(launches)}")

    prep = engine.prepare(zipf_col, "cuda")
    for name, counter, b, impl in (
            ("hamming_matrix", bitmap_filter.hamming_matrix_cuda, MAIN["b"], "auto"),
            ("bitplane_hamming", bitplane.bitplane_hamming_cuda, WIDE_B, "mxu")):
        words = prep.bitmap_words(b, "xor")
        counter.launches = 0
        ham = ops.hamming_matrix(words, words, impl=impl)
        launches[name] = counter.launches
        err = max_err(ham, ref.hamming_matrix_ref(words, words))
        if err or launches[name] != 1:
            raise AssertionError(f"{name} over {words.shape[0]} sets: error {err}, "
                                 f"launches {launches[name]}")
        log(f"{name} path: ops.hamming_matrix(impl={impl!r}) over {words.shape[0]} ZIPF "
            f"sets (W={words.shape[1]}): exact, mean distance {ham.double().mean():.3f}")
        del ham

    ikw = dict(sim=MAIN["sim"], tau=tau, b=MAIN["b"], probe_block=MAIN["block"],
               return_stats=True)
    cpu = indexed_bitmap_join(skewed_col, device="cpu", **ikw)
    blocked = join.blocked_bitmap_join(skewed_col, **kw, device="cuda")[0]
    if not np.array_equal(cpu[0], blocked):
        raise AssertionError(f"indexed {len(cpu[0])} pairs vs blocked {len(blocked)}")
    stage = LaunchCounts(expand_filter=postings.expand_filter_cuda,
                         verdict_verify=postings.verdict_verify_cuda,
                         entry_filter=postings.entry_filter_cuda,
                         pair_verdict_tiled=postings.pair_verdict_tiled_cuda)
    # The forced capacity on the middle SLICE_CPU_ROWS sets: the CPU's run at
    # that capacity took 10-14 s on all of them (2 blocks still overflow).
    skewed_part = middle_rows(skewed_col, SLICE_CPU_ROWS)
    for impl, capacity in (("auto", None), ("swar", None), ("swar_tiled", None),
                           ("auto", 4096)):
        col = skewed_col if capacity is None else skewed_part
        postings.pair_verdict_cuda.launches = 0
        stage.zero()
        t0 = time.perf_counter()
        gpu = indexed_bitmap_join(col, device="cuda", impl=impl, capacity=capacity, **ikw)
        t1 = time.perf_counter()
        ran = stage.read()
        if impl == "swar":
            launches["pair_verdict"] = postings.pair_verdict_cuda.launches
            if launches["pair_verdict"] <= 0:
                raise AssertionError("the impl='swar' indexed join never launched pair_verdict")
        fused = min(ran["expand_filter"], ran["verdict_verify"]) > 0
        if capacity is None and (fused != (impl == "auto")
                                 or (impl == "auto") == (ran["entry_filter"] > 0)):
            raise AssertionError(f"impl={impl}: the stage kernels run under 'auto' only, "
                                 f"the unfused path's kernels otherwise: {ran}")
        want = cpu
        if capacity is not None:
            want = indexed_bitmap_join(col, device="cpu", capacity=capacity, **ikw)
            if want[1].overflow_blocks == 0:
                raise AssertionError(f"capacity {capacity} did not reach the dense fallback")
        _same(gpu, want, f"card vs CPU indexed join, impl={impl} capacity={capacity}")
        same = "= blocked" if capacity is None else "= the CPU's"
        log(f"slice parity, indexed, {col.num_sets} SKEWED sets, impl={impl} "
            f"capacity={capacity}: card {t1 - t0:.2f} s, {len(gpu[0])} pairs ({same}), "
            f"identical; stats {json.dumps(gpu[1].to_dict())}; stage launches "
            f"{json.dumps(ran)}")
    # The bit-plane pairwise verdict, off the serving path since the stage
    # kernels: the indexed join at b = 1024 under impl='mxu'.
    wide = dict(ikw, b=WIDE_B)
    postings.pair_verdict_bitplane_cuda.launches = 0
    gpu = indexed_bitmap_join(skewed_col, device="cuda", impl="mxu", **wide)
    launches["pair_verdict_bitplane"] = postings.pair_verdict_bitplane_cuda.launches
    if launches["pair_verdict_bitplane"] <= 0:
        raise AssertionError("the impl='mxu' indexed join never launched pair_verdict_bitplane")
    _same(gpu, indexed_bitmap_join(skewed_col, device="cpu", **wide),
          f"card (impl='mxu') vs CPU indexed join at b={WIDE_B}")
    _same(gpu, indexed_bitmap_join(skewed_col, device="cuda", **wide),
          f"impl='mxu' vs 'auto' indexed join at b={WIDE_B}")
    log(f"pair_verdict_bitplane path: the indexed join at b={WIDE_B} under impl='mxu' over "
        f"{skewed_col.num_sets} SKEWED sets, identical to the CPU join and to 'auto'; "
        f"launches {launches['pair_verdict_bitplane']}")
    return launches


def middle_rows(col, n: int):
    """The ``n`` rows in the middle of ``col``'s size order (planted
    clusters share a size, so ZIPF's lie in any such window too)."""
    from repro_torch.core.collection import Collection

    lo = max(0, (col.num_sets - n) // 2)
    return Collection(tokens=np.ascontiguousarray(col.tokens[lo:lo + n]),
                      lengths=np.ascontiguousarray(col.lengths[lo:lo + n]))


def phase_full_blocked(zipf, uniform) -> tuple[dict, np.ndarray, int]:
    """The blocked path: ZIPF tau = 0.8 (explicit blocked plan) and UNIFORM
    tau = 0.5 (JoinEngine, auto plan); then device against host compaction
    on HOST_COMPACTION_ROWS rows of each.  Returns the tensor-core kernels'
    launches, ZIPF's pairs (phases 13 and 20 are held to them) and ZIPF's
    bitmap candidates (phase 20's ring is held to them)."""
    from repro_torch.core import engine
    from repro_torch.kernels import bitmap_build, bitmap_filter, compaction

    t0 = time.perf_counter()
    uni_engine = engine.JoinEngine(uniform, MAIN["sim"], 0.5, device="cuda")
    if uni_engine.plan.driver != "blocked" or uni_engine.plan.compaction != "device":
        raise AssertionError(f"UNIFORM tau=0.5 planned {uni_engine.plan.describe()}")
    zipf_prep = engine.prepare(zipf, "cuda")
    log(f"full size, blocked path: prepared {zipf.num_sets} + {uniform.num_sets} sets in "
        f"{time.perf_counter() - t0:.1f} s (set-up, not timed); "
        f"UNIFORM auto plan: {uni_engine.plan.driver}, b={uni_engine.plan.b}, "
        f"block={uni_engine.plan.block}")

    counts = LaunchCounts(candidate_matrix_mxu=bitmap_filter.candidate_matrix_mxu_cuda,
                          count_candidates_mxu=compaction.count_candidates_mxu_cuda,
                          candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                          count_candidates=compaction.count_candidates_cuda,
                          **bitmap_build_wrappers())
    # The path: counters zeroed just before, read just after.
    counts.zero()
    runs = {"ZIPF": _join(zipf_prep, 0.8, "device")}
    (pairs, stats), secs = _timed(lambda: uni_engine.self_join(return_stats=True))
    runs["UNIFORM"] = (pairs, stats, secs)
    launches, forms = counts.read(), counts.read_forms()
    log(f"blocked path launches: {json.dumps(launches)}; the bitmap build's by form "
        f"{json.dumps(forms)}")
    check_dense_launches(launches, MAIN["b"], "the blocked path")
    record_build_launches(launches, forms, "phase 4")
    # Both collections' words in one build each, at full size: the rule's
    # lane form.
    for method, col in (("xor", zipf), ("set", uniform)):
        want = bitmap_build.form(method, MAIN["b"], col.num_sets)
        by_form = forms[f"bitmap_build_{method}"]
        if want != "lane" or by_form["warp"] or not by_form["lane"]:
            raise AssertionError(f"phase 4's {method} builds of {col.num_sets} rows must run "
                                 f"the lane form (the rule gives {want}): {forms}")

    for name, prep, col, tau in (("ZIPF", zipf_prep, zipf, 0.8),
                                 ("UNIFORM", uni_engine.prepared, uniform, 0.5)):
        pairs, stats, cold = runs[name]
        _, _, warm = _join(prep, tau, "device")
        # Host compaction costs about 25 s at full size: it is held to device
        # compaction on a window of the rows.
        window = engine.prepare(middle_rows(col, HOST_COMPACTION_ROWS), "cuda")
        wp, ws, _ = _join(window, tau, "device")
        hp, hs, host_s = _join(window, tau, "host")
        _same((wp, ws), (hp, hs), f"{name} device vs host compaction on {window.num_sets} rows")
        if len(wp) == 0:
            raise AssertionError(f"{name}: no pairs in the {window.num_sets}-row window")
        log(f"{name} tau={tau} n={prep.num_sets}: device compaction cold {cold:.3f} s "
            f"(incl. bitmap build), warm {warm:.3f} s = "
            f"{stats.total_pairs / warm:.4g} window pairs/s; stats "
            f"{json.dumps(stats.to_dict())}; host compaction on the middle {window.num_sets} "
            f"rows {host_s:.3f} s, identical to device compaction there ({len(wp)} pairs)")
        if name == "ZIPF" and stats.verified_true < 2000:
            raise AssertionError(f"ZIPF found {stats.verified_true} < 2000 planted pairs")
        del window
    return ({k: v for k, v in launches.items() if k.endswith("_mxu")}, runs["ZIPF"][0],
            runs["ZIPF"][1].candidates)


def check_dense_launches(launches: dict, b: int, path: str) -> None:
    """A blocked path at b-bit rows launches the dense verdict and count
    that ``auto`` picks there: the tensor-core kernels, and then neither
    SWAR kernel."""
    from repro_torch.kernels import ops

    picked = ops._resolve_dense_impl("auto", torch.device("cuda"), b)
    run = [launches[f"{k}_mxu" if picked == "mxu" else k]
           for k in ("candidate_matrix", "count_candidates")]
    idle = [launches[k if picked == "mxu" else f"{k}_mxu"]
            for k in ("candidate_matrix", "count_candidates")]
    if min(run) <= 0 or max(idle) != 0:
        raise AssertionError(f"{path} at b={b} must launch the {picked} verdict and count "
                             f"kernels and not the others: {launches}")


def _perturbed(row: list, rng, universe: int) -> list:
    """``row`` as is, or with one token dropped, or one replaced by another
    id of the corpus (a third each)."""
    kind = rng.integers(3)
    if kind == 1 and len(row) > 1:
        row.pop(int(rng.integers(len(row))))
    elif kind == 2:
        row[int(rng.integers(len(row)))] = int(rng.integers(universe))
    return row


def probe_batches(col, seed: int, n_batches: int = 4, rows: int = 4096):
    """Batches of rows cut from ``col`` (its token ids), a third perturbed:
    one token dropped, or replaced by another id of the corpus."""
    from repro_torch.core.collection import from_lists

    rng = np.random.default_rng(seed + 7)
    universe = int(col.tokens[col.lengths > 0].max()) + 1
    batches = []
    for _ in range(n_batches):
        sets = [_perturbed(col.row(int(i)).tolist(), rng, universe)
                for i in rng.choice(col.num_sets, size=rows, replace=False)]
        batches.append(from_lists(sets))
    return batches


def mixed_delta(col, fresh, seed: int):
    """An append for ``col``: the sets of ``fresh``, every third replaced by
    a perturbed row of ``col`` (so the delta has pairs with the corpus)."""
    from repro_torch.core.collection import from_lists

    rng = np.random.default_rng(seed)
    universe = int(col.tokens[col.lengths > 0].max()) + 1
    sets = fresh.as_lists()
    for k in range(0, len(sets), 3):
        sets[k] = _perturbed(col.row(int(rng.integers(col.num_sets))).tolist(), rng,
                             universe)
    return from_lists(sets)


def phase_full_indexed(seed: int, skewed, batches) -> tuple[dict, dict]:
    """The indexed path: SKEWED tau = 0.8 and 0.6 through JoinEngine with
    auto plans — cold and warm self-joins, then the probe batches — and the
    same self-joins under the unfused composition (``impl="swar_tiled"``).
    Returns the launches, and tau = 0.8's auto plan, self-join and probes
    (``(pairs, stats)`` each; phase 20 is held to them)."""
    from repro_torch.core import engine, join
    from repro_torch.index import candidates
    from repro_torch.kernels import bitmap_filter, compaction, postings

    engines = {tau: engine.JoinEngine(skewed, MAIN["sim"], tau, device="cuda")
               for tau in SKEWED_TAUS}
    for tau, eng in engines.items():
        if eng.plan.driver != "indexed" or eng.plan.compaction != "device":
            raise AssertionError(f"SKEWED tau={tau} planned {eng.plan.describe()}")
    log(f"full size, indexed path: SKEWED {skewed.num_sets} sets, max_len "
        f"{skewed.max_len}; auto plans {[e.plan.driver for e in engines.values()]}, "
        f"b={MAIN['b']}, probe block {engines[0.8].plan.block}")

    counters = (postings.expand_filter_cuda, postings.verdict_verify_cuda,
                postings.entry_filter_cuda, postings.pair_verdict_tiled_cuda,
                postings.pair_verdict_cuda, postings.pair_verdict_bitplane_cuda,
                bitmap_filter.hamming_matrix_cuda,
                bitmap_filter.candidate_matrix_cuda, compaction.count_candidates_cuda,
                bitmap_filter.candidate_matrix_mxu_cuda, compaction.count_candidates_mxu_cuda)
    builds = LaunchCounts(**bitmap_build_wrappers())
    # The path: counters zeroed just before, read just after.
    builds.zero()
    for f in counters:
        f.launches = 0
    results = {}
    for tau, eng in engines.items():
        cold_out, cold = _timed(lambda: eng.self_join(return_stats=True))
        warm_out, warm = _timed(lambda: eng.self_join(return_stats=True))
        probes = [_timed(lambda: eng.probe(b)) for b in batches]
        results[tau] = (cold_out, warm_out, cold, warm, probes)
    launches = {"expand_filter": postings.expand_filter_cuda.launches,
                "verdict_verify": postings.verdict_verify_cuda.launches}
    idle = {f.__name__.removesuffix("_cuda"): f.launches for f in counters[2:]}
    record_build_launches(builds.read(), builds.read_forms(), "phase 5")
    log(f"indexed path launches: {json.dumps(launches)}; not on it: {json.dumps(idle)}")
    if min(launches.values()) <= 0 or max(idle.values()) != 0:
        raise AssertionError(f"the indexed path must launch the stage kernels and no other "
                             f"postings or dense kernel: {launches} {idle}")

    # The unfused composition (the PyTorch ops around entry_filter and
    # pair_verdict_tiled, impl='swar_tiled'): the same self-joins, the same
    # pairs and counters; the unfused path's kernels' launches come from here.
    old = LaunchCounts(entry_filter=postings.entry_filter_cuda,
                       pair_verdict_tiled=postings.pair_verdict_tiled_cuda,
                       expand_filter=postings.expand_filter_cuda,
                       verdict_verify=postings.verdict_verify_cuda)
    old.zero()
    unfused = {}
    for tau, eng in engines.items():
        p = eng.plan
        unfused[tau] = _timed(lambda: candidates.indexed_join_prepared(
            eng.prepared, sim=MAIN["sim"], tau=tau, b=p.b, method=p.method, mix=p.mix,
            ell=p.ell, probe_block=p.block, impl="swar_tiled", use_cutoff=p.use_cutoff,
            capacity=p.capacity, return_stats=True))
    ran = old.read()
    log(f"the unfused composition (impl='swar_tiled') launches: {json.dumps(ran)}")
    if (min(ran["entry_filter"], ran["pair_verdict_tiled"]) <= 0
            or ran["expand_filter"] or ran["verdict_verify"]):
        raise AssertionError(f"impl='swar_tiled' must run the unfused path's kernels only: {ran}")
    launches.update(entry_filter=ran["entry_filter"],
                    pair_verdict_tiled=ran["pair_verdict_tiled"])

    for tau, eng in engines.items():
        (pairs, stats), warm_out, cold, warm, probes = results[tau]
        _same((pairs, stats), warm_out, f"SKEWED tau={tau} cold vs warm")
        _same((pairs, stats), unfused[tau][0], f"SKEWED tau={tau} stage kernels vs the "
                                              f"unfused composition")
        (bp, bstats), blocked_s = _timed(lambda: join.blocked_bitmap_join_prepared(
            eng.prepared, sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
            compaction="device", return_stats=True))
        if not np.array_equal(pairs, bp):
            raise AssertionError(f"SKEWED tau={tau}: indexed {len(pairs)} pairs, "
                                 f"blocked {len(bp)}")
        if stats.verified_true < 2000:
            raise AssertionError(f"SKEWED tau={tau} found {stats.verified_true} < 2000 "
                                 f"planted pairs")
        log(f"SKEWED tau={tau} self-join: indexed cold {cold:.3f} s (incl. postings and "
            f"bitmap build), warm {warm:.3f} s, the unfused composition (warm) "
            f"{unfused[tau][1]:.3f} s, same pairs and counters; blocked {blocked_s:.3f} s, same "
            f"{len(pairs)} pairs; postings_expanded {stats.postings_expanded}, "
            f"candidates_generated {stats.candidates_generated} (blocked window pairs "
            f"{bstats.total_pairs}); stats {json.dumps(stats.to_dict())}")
        for k, (((pp, ps), secs), batch) in enumerate(zip(probes, batches)):
            want = join.blocked_bitmap_join(eng.prepared, batch, MAIN["sim"], tau,
                                            b=MAIN["b"], block=MAIN["block"],
                                            compaction="device")
            if not np.array_equal(pp, want):
                raise AssertionError(f"SKEWED tau={tau} probe {k}: {len(pp)} pairs, "
                                     f"blocked R x S {len(want)}")
            log(f"SKEWED tau={tau} probe {k} ({batch.num_sets} rows): {secs:.3f} s, "
                f"{len(pp)} pairs (= blocked R x S), postings_expanded "
                f"{ps.postings_expanded}, candidates_generated {ps.candidates_generated}")
        if eng.prepared.builds["postings"] != 1:
            raise AssertionError(f"postings built {eng.prepared.builds['postings']} times")
        log(f"SKEWED tau={tau} engine: builds {json.dumps(eng.prepared.build_counts())}, "
            f"summary {json.dumps(eng.stats_summary())}")
    (self_out, _, _, _, probes) = results[MESH["tau"]]
    return launches, {"plan": engines[MESH["tau"]].plan, "self": self_out,
                      "probes": [out for out, _ in probes]}


def phase_bitplane_parity(seed: int) -> None:
    """bitplane_hamming and pair_verdict_bitplane against their plain
    versions and against the SWAR kernels (hamming_matrix,
    pair_verdict_tiled) on the same operands: W in {1, 4, 16, 32, 128}, odd
    sizes, all-pass / all-prune / empty rows, cosine keys, both sides of the
    cutoff.  Exact."""
    from repro_torch.core import bounds
    from repro_torch.core.constants import COSINE
    from repro_torch.kernels import bitmap_filter, bitplane, ops, postings, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 2)

    def words(n, w):
        return torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def lengths(n, kind):
        lens = rng.integers(0, 40, n).astype(np.int32)
        if kind == "all_pass":
            lens[:] = 20
        elif kind == "all_prune":
            lens[:] = 2
        elif kind == "empty_rows":
            lens[::3] = 0
        return torch.from_numpy(lens).to(dev)

    for (nr, ns, w) in [(33, 70, 1), (96, 64, 4), (257, 65, 16), (300, 200, 32),
                        (1000, 999, 32), (129, 67, 128)]:
        for kind in ("random", "all_pass", "all_prune", "empty_rows"):
            wr, ws = words(nr, w), words(ns, w)
            if kind == "all_pass":
                wr.zero_(), ws.zero_()
            elif kind != "all_prune":
                m = min(nr, ns)
                ws[:m:4] = wr[:m:4]  # identical rows pass
            lr, ls = lengths(nr, kind), lengths(ns, kind)
            (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
            ham = bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)
            err = max(max_err(ham, ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s)),
                      max_err(ham, bitmap_filter.hamming_matrix_cuda(wr, ws)))
            g = min(nr, ns)
            for sim, tau, cutoff in (("jaccard", 0.6, 1 << 30), ("cosine", 0.75, 12),
                                     ("dice", 0.5, 1 << 30), ("overlap", 3.0, 12)):
                table = ref.prune_table_for(sim, tau, lr, ls)
                kw = dict(key_prod=sim == COSINE, cutoff=cutoff)
                got = postings.pair_verdict_bitplane_cuda(
                    pr[:g], ps[:g], pc_r[:g], pc_s[:g], lr[:g], ls[:g], table, **kw)
                want = bounds.verdict_from_hamming(
                    ref.bitplane_pair_hamming_ref(pr[:g], ps[:g], pc_r[:g], pc_s[:g]),
                    lr[:g], ls[:g], table, sim=sim, cutoff=cutoff)
                tiled = postings.pair_verdict_tiled_cuda(
                    wr[:g].contiguous(), ws[:g].contiguous(), lr[:g], ls[:g], table, **kw)
                dense = [ops.candidate_matrix(wr, ws, lr, ls, sim, tau, sj, cutoff,
                                              impl=impl, table=table)
                         for impl in ("mxu", "swar") for sj in (False, True)]
                err = max(err, max_err(got, want), max_err(got, tiled),
                          max_err(dense[0], dense[2]), max_err(dense[1], dense[3]))
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"bit-plane kernels != plain / SWAR: {nr}x{ns} W={w} "
                                     f"{kind}: error {err}")
        log(f"bit-plane parity {nr}x{ns} W={w} (b={32 * w}): bitplane_hamming and "
            f"pair_verdict_bitplane exact against their plain versions and the SWAR "
            f"kernels, random / all-pass / all-prune / empty rows, 4 sims")


def _funnel(stats) -> dict:
    from repro_torch.store import FUNNEL_SUM_FIELDS

    return {f: getattr(stats, f) for f in FUNNEL_SUM_FIELDS}


def phase_store(seed: int, zipf) -> tuple[dict, tuple]:
    """The corpus store on the blocked path at b = 1024: returns the path's
    launches of the tensor-core verdict kernels, and the first two 4096-row
    blocks of its words and lengths with its cutoff and longest set (the
    timing operands at W = 32)."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import engine, expected, join
    from repro_torch.core.plan import JoinPlan
    from repro_torch.data.collections import zipf_collection
    from repro_torch.kernels import bitmap_filter, bitplane, compaction
    from repro_torch.store import CompactionPolicy, CorpusStore

    tau = 0.8
    plan = JoinPlan(driver="blocked", sim=MAIN["sim"], tau=tau, b=WIDE_B,
                    block=MAIN["block"], compaction="device")
    deltas = [mixed_delta(zipf, zipf_collection(n_sets=1000, seed=seed + 20 + k),
                          seed + 30 + k) for k in range(2)]
    store = CorpusStore(zipf, MAIN["sim"], tau, plan=plan,
                        policy=CompactionPolicy.never(), device="cuda")
    counts = LaunchCounts(candidate_matrix_mxu=bitmap_filter.candidate_matrix_mxu_cuda,
                          count_candidates_mxu=compaction.count_candidates_mxu_cuda,
                          candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                          count_candidates=compaction.count_candidates_cuda,
                          bitplane_hamming=bitplane.bitplane_hamming_cuda,
                          **bitmap_build_wrappers())
    log(f"full size, store on the blocked path: ZIPF {zipf.num_sets} sets + 2 appends of "
        f"{[d.num_sets for d in deltas]} sets, plan {plan.driver} b={plan.b} "
        f"block={plan.block} compaction={plan.compaction}")

    # The path: counters zeroed just before, read just after.
    counts.zero()
    runs = {}
    runs["base"], cold = _timed(lambda: store.self_join(return_stats=True))
    _, warm = _timed(lambda: store.self_join(return_stats=True))
    base_builds = store.builds()
    append_s = [_timed(lambda d=d: store.append(d, compact=False))[1] for d in deltas]
    if store.builds() != base_builds or base_builds["sort"] != 1:
        raise AssertionError(f"append rebuilt the base: {base_builds} -> {store.builds()}")
    runs["appended"], appended_s = _timed(lambda: store.self_join(return_stats=True))
    _, compact_s = _timed(store.compact)
    runs["compacted"], compacted_s = _timed(lambda: store.self_join(return_stats=True))
    launches, forms = counts.read(), counts.read_forms()
    log(f"store path launches: {json.dumps(launches)}; the bitmap build's by form "
        f"{json.dumps(forms)}")
    check_dense_launches(launches, WIDE_B, "the blocked store")
    record_build_launches(launches, forms, "phase 7")
    if launches["bitplane_hamming"] != 0:
        raise AssertionError(f"at b={WIDE_B} the blocked store's verdict is one kernel; "
                             f"it must not run bitplane_hamming: {launches}")

    # The comparisons: a from-scratch rebuild under the same plan, and the
    # b = 128 blocked join, at each state.
    full = store.collection()
    for name, col in (("base", zipf), ("appended", full), ("compacted", full)):
        pairs, stats = runs[name]
        prep = engine.prepare(col, "cuda")
        rp, rs = engine.JoinEngine(prep, MAIN["sim"], tau, plan=plan).self_join(
            return_stats=True)
        if not np.array_equal(pairs, rp) or _funnel(stats) != _funnel(rs):
            raise AssertionError(f"store {name}: {len(pairs)} pairs {_funnel(stats)} vs "
                                 f"rebuild {len(rp)} {_funnel(rs)}")
        narrow = lambda: join.blocked_bitmap_join_prepared(  # noqa: E731
            prep, sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
            compaction="device")
        np128, _ = _timed(narrow)
        np128, warm128 = _timed(narrow)
        if not np.array_equal(pairs, np128):
            raise AssertionError(f"store {name}: {len(pairs)} pairs at b={WIDE_B}, "
                                 f"{len(np128)} at b={MAIN['b']}")
        log(f"store {name} ({col.num_sets} sets): {len(pairs)} pairs = rebuild = b=128 "
            f"blocked join; funnel {json.dumps(_funnel(stats))}; rebuild at b=128 warm "
            f"{warm128:.3f} s")
    log(f"store timings at b={WIDE_B}: self-join cold {cold:.3f} s, warm {warm:.3f} s; "
        f"appends {', '.join(f'{t:.3f}' for t in append_s)} s; self-join with 2 deltas "
        f"{appended_s:.3f} s; compaction {compact_s:.3f} s; self-join after it "
        f"{compacted_s:.3f} s; builds {json.dumps(store.stats().lifetime_builds)}")
    prep = store.base.prepared
    method = bm.choose_method(tau, WIDE_B) if plan.method == "combined" else plan.method
    words = prep.bitmap_words(WIDE_B, method)
    _, lengths = prep.device_arrays()
    blocks = slice(0, 2 * MAIN["block"])
    return ({k: v for k, v in launches.items() if k.endswith("_mxu")},
            (words[blocks], lengths[blocks], expected.cutoff_point(method, WIDE_B, tau),
             prep.max_len))


def serve_requests(col, seed: int, n: int):
    """``n`` single-set requests of one padded width: a quarter exact rows
    of ``col``, the rest sets of a fresh SKEWED draw."""
    from repro_torch.core.collection import Collection
    from repro_torch.core.constants import PAD_TOKEN
    from repro_torch.data.collections import skewed_collection

    rng = np.random.default_rng(seed + 50)
    fresh = skewed_collection(n_sets=n, seed=seed + 51)
    width = max(col.max_len, fresh.max_len)
    out = []
    for i in range(n):
        src, j = (col, int(rng.integers(col.num_sets))) if i % 4 == 0 else (fresh, i)
        tokens = np.full((1, width), PAD_TOKEN, dtype=np.int32)
        tokens[0, :src.tokens.shape[1]] = src.tokens[j]
        out.append(Collection(tokens=tokens, lengths=src.lengths[j:j + 1].copy()))
    return out


def phase_serve(seed: int, skewed) -> tuple[dict, tuple]:
    """Serving at b = 1024 over a store: returns the path's launches and the
    operands of the first coalesced batch's ``verdict_verify``."""
    from repro_torch.core import engine, join
    from repro_torch.core.collection import Collection
    from repro_torch.core.plan import JoinPlanner
    from repro_torch.data.collections import skewed_collection
    from repro_torch.kernels import bitmap_build, bitmap_filter, bitplane, postings
    from repro_torch.serve import JoinSession
    from repro_torch.store import CompactionPolicy, CorpusStore

    tau = SKEWED_TAUS[0]
    t0 = time.perf_counter()
    store = CorpusStore(skewed, MAIN["sim"], tau, planner=JoinPlanner(b=WIDE_B),
                        policy=CompactionPolicy.never(), device="cuda")
    if store.plan.driver != "indexed" or store.plan.b != WIDE_B:
        raise AssertionError(f"serving store planned {store.plan.describe()}")
    sess = JoinSession(store, max_batch=SERVE["flush_every"])
    n_req = SERVE["requests"] + SERVE["after_compact"]
    requests = serve_requests(skewed, seed, n_req)
    delta = mixed_delta(skewed, skewed_collection(n_sets=SERVE["delta_rows"], seed=seed + 40),
                        seed + 41)
    fe = SERVE["flush_every"]
    # Warm-up: the bucket ladder calibrated on the traffic's own groups.
    built = sum(sess.warm_buckets(requests[k:k + fe])
                for k in range(0, SERVE["requests"], fe))
    # The operands of the first coalesced batch's verdict and verification
    # (a throwaway flush).
    calls = []
    with capture_calls(postings, "verdict_verify_cuda", calls):
        for r in requests[:fe]:
            sess.submit(r)
        sess.flush()
    warm_s = time.perf_counter() - t0
    builds_warm = sess.entrypoints.stats()["traces"]
    log(f"full size, serving: SKEWED {skewed.num_sets} sets, plan {store.plan.driver} "
        f"b={store.plan.b} block={store.plan.block}; max_batch {sess.coalescer.max_batch}; "
        f"set-up and warm-up {warm_s:.1f} s ({built} entrypoints built)")

    counts = LaunchCounts(expand_filter=postings.expand_filter_cuda,
                          verdict_verify=postings.verdict_verify_cuda,
                          pair_verdict_bitplane=postings.pair_verdict_bitplane_cuda,
                          entry_filter=postings.entry_filter_cuda,
                          pair_verdict_tiled=postings.pair_verdict_tiled_cuda,
                          candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                          bitplane_hamming=bitplane.bitplane_hamming_cuda,
                          **bitmap_build_wrappers())
    solo = engine.JoinEngine(store)
    rng = np.random.default_rng(seed + 60)
    tickets, checked, spans = [], 0, []
    oracle_launches = dict.fromkeys(counts.wrappers, 0)
    # The bitmap build's launches by form: the solo probes' (taken out of
    # the path's) and the flushes' own.
    oracle_forms = {k: dict.fromkeys(v, 0) for k, v in counts.read_forms().items()}
    flush_forms = {k: dict.fromkeys(v, 0) for k, v in counts.read_forms().items()}

    def add_forms(into, before):
        for k, by_form in counts.read_forms().items():
            for f, v in by_form.items():
                into[k][f] += v - before[k][f]

    def check(batch):
        """Sampled tickets of this flush against solo probes of the store's
        current state; their launches are taken out of the path's."""
        nonlocal checked
        before, before_forms = counts.read(), counts.read_forms()
        for i in rng.choice(len(batch), size=min(SERVE["sample_per_flush"], len(batch)),
                            replace=False):
            t = batch[int(i)]
            pairs, stats = t.result()
            want, want_stats = solo.probe(t.request)
            if not np.array_equal(pairs, want) or stats != want_stats:
                raise AssertionError(f"ticket {t.seq} ({t.route}) != solo probe:\n"
                                     f"{stats}\n{want_stats}")
            checked += 1
        for k, v in counts.read().items():
            oracle_launches[k] += v - before[k]
        add_forms(oracle_forms, before_forms)

    def serve(batch_requests, label):
        t1 = time.perf_counter()
        before_forms = counts.read_forms()
        batch = [sess.submit(r) for r in batch_requests]
        sess.flush()
        add_forms(flush_forms, before_forms)
        spans.append((label, len(batch), time.perf_counter() - t1))
        tickets.extend(batch)
        check(batch)

    # The path: counters zeroed just before, read just after.
    counts.zero()
    for k in range(0, SERVE["requests"], fe):
        serve(requests[k:k + fe], "base" if k < SERVE["append_after"] else "base+delta")
        if k + fe == SERVE["append_after"]:
            _, append_s = _timed(lambda: sess.append(delta, compact=False))
    builds_traffic = sess.entrypoints.stats()["traces"] - builds_warm
    _, compact_s = _timed(sess.compact)
    serve(requests[SERVE["requests"]:], "compacted")
    launches = {k: v - oracle_launches[k] for k, v in counts.read().items()}
    forms = {k: {f: v - oracle_forms[k][f] for f, v in by_form.items()}
             for k, by_form in counts.read_forms().items()}
    log(f"serving path launches: {json.dumps(launches)} (solo-probe checks took out: "
        f"{json.dumps(oracle_launches)}); the bitmap build's by form {json.dumps(forms)}, "
        f"in the flushes {json.dumps(flush_forms)}")
    if (min(launches["expand_filter"], launches["verdict_verify"]) <= 0
            or any(launches[k] for k in ("pair_verdict_bitplane", "entry_filter",
                                         "pair_verdict_tiled", "candidate_matrix"))):
        raise AssertionError(f"at b={WIDE_B} serving must run the stage kernels and none of "
                             f"the unfused path's pairwise kernels: {launches}")
    if builds_traffic:
        raise AssertionError(f"{builds_traffic} entrypoints built after warm-up")
    record_build_launches(launches, forms, "phase 8")
    # A flush builds its probe rows' words, at most max_batch rows: the
    # rule's warp form.
    want = bitmap_build.form("xor", WIDE_B, sess.coalescer.max_batch)
    xor = flush_forms["bitmap_build_xor"]
    if want != "warp" or xor["lane"] or xor["warp"] <= 0:
        raise AssertionError(f"the flushes' Xor builds must run the warp form (the rule gives "
                             f"{want} for {sess.coalescer.max_batch} rows): {flush_forms}")

    # The union of all tickets against one blocked R x S join at b = 128 (a
    # request served before the append sees the base only).
    all_req = Collection(tokens=np.concatenate([r.tokens for r in requests]),
                         lengths=np.concatenate([r.lengths for r in requests]))
    want = join.blocked_bitmap_join(store.collection(), all_req, MAIN["sim"], tau,
                                    b=MAIN["b"], block=MAIN["block"], compaction="device",
                                    device="cuda")
    base_rows = skewed.num_sets
    want = want[(want[:, 1] >= SERVE["append_after"]) | (want[:, 0] < base_rows)]
    got = np.concatenate([np.stack([t.pairs[:, 0], np.full(len(t.pairs), i)], axis=1)
                          for i, t in enumerate(tickets) if len(t.pairs)])
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    if not np.array_equal(got, want):
        raise AssertionError(f"union of tickets {len(got)} pairs vs blocked R x S "
                             f"{len(want)}")
    lat = np.array([t.latency_s for t in tickets]) * 1e3
    routes = collections.Counter(t.route for t in tickets)
    summary = sess.stats_summary()
    log(f"serving: {len(tickets)} requests, routes {dict(routes)}, {checked} sampled "
        f"tickets = solo probes (pairs and JoinStats), union of tickets = blocked R x S "
        f"at b={MAIN['b']} ({len(got)} pairs); entrypoint builds after warm-up "
        f"{builds_traffic} (across the append), after compaction "
        f"{sess.entrypoints.stats()['traces'] - builds_warm - builds_traffic}")
    for label in ("base", "base+delta", "compacted"):
        n = sum(k for lb, k, _ in spans if lb == label)
        secs = sum(t for lb, _, t in spans if lb == label)
        log(f"serving {label}: {n} requests in {secs:.3f} s = {n / secs:.1f} requests/s")
    log(f"serving: ticket latency p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms; coalesced batches {summary['coalesced_batches']}; "
        f"append {append_s:.3f} s, compaction {compact_s:.3f} s; pad overhead "
        f"{summary['pad_overhead']:.4f}; transfer {json.dumps(summary['transfer'])}")
    (args, kw), = calls[:1]
    return launches, (args, kw)


def phase_wide_verdict_timing(store_ops) -> dict:
    """The two dense verdicts at the store's block pair (W = 32): both forms
    of each exactly equal to the plain version and timed in turns (swar,
    mxu, mxu, swar), and the bit-plane composite of candidate_matrix
    (unpack, bitplane_hamming, the verdict in PyTorch ops) that the
    tensor-core kernel replaces.  Returns each tensor-core kernel's
    numbers there."""
    from repro_torch.core import bounds, verify
    from repro_torch.kernels import bitmap_filter, bitplane, compaction, ops, ref

    words, lengths, cutoff, max_len = store_ops
    blk, tau = MAIN["block"], 0.8
    wr, ws = words[:blk], words[blk:2 * blk]
    lr, ls = lengths[:blk], lengths[blk:2 * blk]
    dev = wr.device
    counted = check_mxu("jaccard", tau, wr, ws, lr, ls, self_join=False, cutoff=cutoff)
    check_mxu("jaccard", tau, wr, wr, lr, lr, self_join=True, cutoff=cutoff)
    table = verify.prune_table_dev("jaccard", tau, max_len, max_len, dev)
    lo, hi = (torch.from_numpy(a).to(dev) for a in
              bounds.length_window_int("jaccard", tau, lr.cpu().numpy()))
    kw = dict(key_prod=False, self_join=False, cutoff=cutoff)

    def composite():
        (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
        ham = bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)
        return bounds.verdict_from_hamming(ham, lr[:, None], ls[None, :], table,
                                           sim="jaccard", cutoff=cutoff)

    want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim="jaccard", tau=tau, self_join=False,
                                    cutoff=cutoff, table=table)
    err = max(max_err(composite(), want),
              max_err(bitmap_filter.candidate_matrix_cuda(wr, ws, lr, ls, table, **kw), want))
    if err:
        raise AssertionError(f"the W = 32 verdicts disagree with the plain version: {err}")
    cand_t = in_turns({
        "swar": lambda: bitmap_filter.candidate_matrix_cuda(wr, ws, lr, ls, table, **kw),
        "mxu": lambda: bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw)})
    count_t = in_turns({
        "swar": lambda: compaction.count_candidates_cuda(
            wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw),
        "mxu": lambda: compaction.count_candidates_mxu_cuda(
            wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw)})
    comp_ms = cuda_ms(composite, 20)
    rkw = dict(sim="jaccard", tau=tau, self_join=False, cutoff=cutoff, table=table)
    plain_c = cuda_ms(lambda: ref.candidate_matrix_ref(wr, ws, lr, ls, **rkw), 10)
    plain_n = cuda_ms(lambda: ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, **rkw), 10)

    pairs, w = blk * blk, wr.shape[1]
    in_bytes = 2 * blk * w * 4 + 2 * blk * 4 + table.numel() * 4
    n_win = counted[1]
    b_c = verdict_bound(in_bytes + pairs, pairs, 32 * w, pairs * (VERDICT_OPS + HAM_OPS))
    b_n = verdict_bound(in_bytes + 2 * blk * 4 + 2 * (blk // 256) ** 2 * 4, n_win, 32 * w,
                        pairs * WINDOW_OPS + n_win * (VERDICT_OPS + HAM_OPS))
    popc_ms = pairs * w / POPC_PER_S * 1e3
    log(f"timing at {blk}x{blk} W={w} (the store's words), device time, in turns (swar, "
        f"mxu, mxu, swar): candidate_matrix swar {cand_t['swar'][0]:.4f} / "
        f"{cand_t['swar'][1]:.4f} ms, mxu {cand_t['mxu'][0]:.4f} / {cand_t['mxu'][1]:.4f} ms, "
        f"the bit-plane composite (unpack + bitplane_hamming + PyTorch verdict) {comp_ms:.4f} ms "
        f"(plain {plain_c:.3f} ms; mxu bound {b_c[0]:.4f} ms by the {b_c[2]}); "
        f"count_candidates swar {count_t['swar'][0]:.4f} / {count_t['swar'][1]:.4f} ms, mxu "
        f"{count_t['mxu'][0]:.4f} / {count_t['mxu'][1]:.4f} ms (plain {plain_n:.3f} ms; mxu "
        f"bound {b_n[0]:.4f} ms by the {b_n[2]}, {n_win} window pairs, {counted[2]} "
        f"candidates); the SWAR form's popcount floor {popc_ms:.4f} ms; exact")
    row = lambda t, plain, bound: {  # noqa: E731
        "ms": t["mxu"][0], "ms_turns": t["mxu"], "swar_ms_turns": t["swar"],
        "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1], "bound_term": bound[2],
        "popcount_floor_ms": popc_ms}
    return {"candidate_matrix_mxu": row(cand_t, plain_c, b_c) | {"composite_ms": comp_ms},
            "count_candidates_mxu": row(count_t, plain_n, b_n)}


def phase_bitplane_timing(store_words, serve_call) -> tuple[list[dict], dict]:
    """Both bit-plane kernels timed at their shapes beside their plain
    versions, bounds and a PyTorch yardstick; and ``verdict_verify`` at the
    first coalesced serving batch, in turns with the unfused composition
    (returned beside the rows)."""
    from repro_torch.core import bounds
    from repro_torch.core.constants import COSINE
    from repro_torch.kernels import bitmap_filter, bitplane, ops, postings, ref

    blk = MAIN["block"]
    wr, ws = store_words[:blk], store_words[blk:2 * blk]
    (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
    got = bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)
    err_h = max(max_err(got, ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s)),
                max_err(got, bitmap_filter.hamming_matrix_cuda(wr, ws)))
    fr, fs = pr.float(), ps.float()
    err_h = max(err_h, max_err(torch.cdist(fr, fs, p=0).to(torch.int32), got))
    if err_h:
        raise AssertionError(f"bitplane_hamming at {blk}x{blk}: error {err_h}")
    hamming = lambda: bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)  # noqa: E731
    product = lambda: torch._int_mm(pr, ps.T)  # noqa: E731
    ms_h, mm_h = cuda_ms(hamming, 50), cuda_ms(product, 50)
    plain_h = cuda_ms(lambda: ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s), 10)
    lib_h = cuda_ms(lambda: torch.cdist(fr, fs, p=0), 10)
    swar_h = cuda_ms(lambda: bitmap_filter.hamming_matrix_cuda(wr, ws), 50)
    # Kernel and product again, in turns, and each call timed alone (host
    # launch work included, as this script once timed every kernel).
    ms_h2, mm_h2 = cuda_ms(hamming, 50), cuda_ms(product, 50)
    call_h, call_mm = call_ms(hamming, 50), call_ms(product, 50)
    del fr, fs
    b = pr.shape[1]
    nbytes, ops_h = (2 * blk) * (b + 4) + 4 * blk * blk, 2 * blk * blk * b
    b_h = bound_ms(nbytes, ops_h, PEAK_INT8_TENSOR_OPS_PER_S)
    log(f"timing at {blk}x{blk} b={b} (the store's words), device time of back-to-back "
        f"launches: bitplane_hamming {ms_h:.4f} / {ms_h2:.4f} ms ({ops_h / ms_h / 1e9:.1f} "
        f"TOP/s int8, {nbytes / ms_h / 1e6:.1f} GB/s of its {nbytes / 1e6:.1f} MB, "
        f"{b_h[0] / ms_h:.1%} of its bound {b_h[0]:.4f} ms by {b_h[1]}); torch._int_mm "
        f"product alone {mm_h:.4f} / {mm_h2:.4f} ms; plain {plain_h:.3f} ms; "
        f"torch.cdist(p=0) {lib_h:.4f} ms; SWAR hamming_matrix {swar_h:.4f} ms; each call "
        f"timed alone: bitplane_hamming {call_h:.4f} ms, torch._int_mm {call_mm:.4f} ms; exact")
    if min(ms_h, ms_h2) > max(mm_h, mm_h2):
        log(f"note: bitplane_hamming ({ms_h:.4f} / {ms_h2:.4f} ms) is slower than the "
            f"torch._int_mm product alone ({mm_h:.4f} / {mm_h2:.4f} ms) in this run")

    # The first coalesced batch's candidates (the operands its
    # verdict_verify took), gathered as the unfused composition gathers them
    # for the pairwise verdict.
    vargs, kw = serve_call
    tokens_r, lengths_r, store_r, ptok, plen, pwords, cand_r, cand_s, slot_ok, table, need = vargs
    sim, cutoff = ("cosine" if kw["key_prod"] else "jaccard"), kw["cutoff"]
    safe_r, safe_s = torch.where(slot_ok, cand_r, 0), torch.where(slot_ok, cand_s, 0)
    words_r, words_s = store_r[safe_r], pwords[safe_s]
    len_r, len_s = lengths_r[safe_r], plen[safe_s]
    (qr, qc_r), (qs, qc_s) = ops._planes(words_r), ops._planes(words_s)
    vkw = dict(key_prod=sim == COSINE, cutoff=cutoff)
    got_v = postings.pair_verdict_bitplane_cuda(qr, qs, qc_r, qc_s, len_r, len_s, table, **vkw)
    plain_v_fn = lambda: bounds.verdict_from_hamming(  # noqa: E731
        ref.bitplane_pair_hamming_ref(qr, qs, qc_r, qc_s), len_r, len_s, table, sim=sim,
        cutoff=cutoff)
    tiled = lambda: postings.pair_verdict_tiled_cuda(  # noqa: E731
        words_r, words_s, len_r, len_s, table, **vkw)
    err_v = max(max_err(got_v, plain_v_fn()), max_err(got_v, tiled()))
    if err_v:
        raise AssertionError(f"pair_verdict_bitplane at the first batch: error {err_v}")
    ms_v = cuda_ms(lambda: postings.pair_verdict_bitplane_cuda(
        qr, qs, qc_r, qc_s, len_r, len_s, table, **vkw), 50)
    plain_v = cuda_ms(plain_v_fn, 10)
    ms_t = cuda_ms(tiled, 50)
    ms_unpack = cuda_ms(lambda: (ops._planes(words_r), ops._planes(words_s)), 10)
    g = qr.shape[0]
    tab_bytes = table.numel() * 4
    b_v = bound_ms(g * (2 * b + 4 * 4 + 1) + tab_bytes, g * (2 * b + VERDICT_OPS))
    b_t = bound_ms(g * (2 * (b // 32) * 4 + 2 * 4 + 1) + tab_bytes,
                   g * (3 * (b // 32) + VERDICT_OPS))
    log(f"timing at the first coalesced batch (G={g} candidate slots, b={b}): "
        f"pair_verdict_bitplane {ms_v:.4f} ms (plain {plain_v:.3f} ms, bound {b_v[0]:.4f} ms "
        f"by {b_v[1]}; {2 * b + 17} bytes a candidate) against the packed-word "
        f"pair_verdict_tiled {ms_t:.4f} ms (bound {b_t[0]:.4f} ms; {8 * (b // 32) + 9} bytes "
        f"a candidate); unpacking both sides into planes {ms_unpack:.4f} ms; "
        f"{int(got_v.sum())} pass, exact")

    # verdict_verify at the same batch, in turns with the unfused
    # composition at b = 1024 (impl='mxu': gathers, unpack, the bit-plane
    # verdict, the (cap, L) token gathers and the overlap search).
    vv_args = (tokens_r, lengths_r, store_r, ptok, plen, pwords, cand_r, cand_s, slot_ok, need)
    vv_kw = dict(sim=sim, tau=SKEWED_TAUS[0], cutoff=cutoff, table=table)
    fused = lambda: postings.verdict_verify_cuda(*vargs, **kw)  # noqa: E731
    unfused = lambda: ops.verdict_verify(*vv_args, **vv_kw, impl="mxu")  # noqa: E731
    want = ref.verdict_verify_ref(*vv_args, **vv_kw)
    err_f = max(max_err(a, b) for got in (fused(), unfused()) for a, b in zip(got, want))
    if err_f:
        raise AssertionError(f"verdict_verify at the first coalesced batch: error {err_f}")
    turns = in_turns({"kernel": fused, "unfused": unfused}, 20)
    n_gen, n_bm = int(slot_ok.sum()), int(want[0].sum())
    log(f"timing at the first coalesced batch (cap {g}, {n_gen} candidates, {n_bm} bitmap "
        f"survivors, {int(want[1].sum())} verified, b={b}), device time in turns: "
        f"verdict_verify {turns['kernel'][0]:.4f} / {turns['kernel'][1]:.4f} ms, the "
        f"unfused composition (impl='mxu') {turns['unfused'][0]:.4f} / "
        f"{turns['unfused'][1]:.4f} ms; exact")
    serve_turns = {"ms_turns": turns["kernel"], "unfused_ms_turns": turns["unfused"],
                   "cap": g, "generated": n_gen, "bitmap": n_bm}
    src = "src/repro_torch/kernels/csrc/"
    return [
        kernel_row("bitplane_hamming", src + "bitplane.cu",
                   "src/repro/kernels/bitplane.py:41", err=err_h, ms=ms_h, plain_ms=plain_h,
                   bound=b_h, library_ms=lib_h,
                   path=f"off the full-size paths: ops.hamming_matrix(impl='mxu') over "
                        f"10,200 ZIPF sets at b={WIDE_B}")
        | {"library_product_ms": mm_h, "call_ms": call_h},
        kernel_row("pair_verdict_bitplane", src + "postings.cu",
                   "src/repro/kernels/postings.py:271", err=err_v, ms=ms_v, plain_ms=plain_v,
                   bound=b_v, path=f"off the main paths: indexed join, impl='mxu', "
                                   f"b={WIDE_B}, 10,200 SKEWED sets; timed at the first "
                                   f"coalesced serving batch"),
    ], serve_turns


def flash_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The largest absolute error of the kernel's output against its plain
    version's; raises unless |got - want| <= tol * (1 + |want|) everywhere,
    tol by type (``FLASH_TOL``)."""
    err = max_err_float(got, want)
    tol = FLASH_TOL[want.dtype]
    diff = (got.double() - want.double()).abs()
    over = int((diff > tol * (1 + want.double().abs())).sum())
    if over or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention != plain version: {what}: {over} elements "
                             f"beyond rtol = atol = {tol}, max |err| {err:.3g}")
    return err


def split_kv_exact(k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """The 3xTF32 prepass against its plain version: bit-identical or raise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for name, got, want in zip(("k_hi", "k_lo", "vt_hi", "vt_lo"), fa.split_kv_cuda(k, v),
                               ref.split_kv_ref(k, v)):
        if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32)):
            raise AssertionError(f"split_kv != plain version: {name} at {what}")


def phase_flash_parity(seed: int) -> None:
    """flash_attention_cuda against flash_attention_ref on the same card
    tensors: causal and not, Sq != Sk, odd lengths, GQA groups 1, 3, 4 and
    8, every supported head dim, float32 and bf16, every instance; the
    3xTF32 instance's prepass against its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"flash parity: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases = [  # sq, sk, causal, group (H / KV), KV
        (1, 1, True, 1, 2), (63, 63, True, 3, 2), (100, 100, True, 4, 2),
        (1000, 1000, True, 8, 1), (64, 200, True, 4, 2), (200, 64, True, 3, 1),
        (100, 37, False, 8, 2), (1, 1000, False, 1, 3),
        # the wgmma instance's 128-row q and 128-key K/V tile edges, Sq != Sk
        # both ways, groups 1, 3, 4 and 8, causal and not
        (127, 127, True, 1, 2), (128, 128, False, 3, 1), (129, 129, True, 4, 2),
        (255, 257, True, 8, 1), (257, 255, False, 1, 2), (128, 257, True, 3, 1),
        (257, 128, True, 4, 1), (129, 255, False, 8, 1), (255, 129, True, 3, 2),
        (257, 257, False, 4, 1),
        # the 192-row q tiles of the head dims 16 and 32 instance
        (191, 193, True, 3, 1), (193, 191, False, 4, 2), (385, 384, True, 8, 1)]
    split_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            for name in fa.instances(dtype, d):
                worst = 0.0
                for sq, sk, causal, g, kv in cases:
                    q, k, v = (torch.randn((2, n, heads, d), generator=gen, device="cuda")
                               .to(dtype) for n, heads in ((sq, g * kv), (sk, kv), (sk, kv)))
                    got = fa.flash_attention_cuda(q, k, v, causal=causal, instance=name)
                    want = ref.flash_attention_ref(q, k, v, causal=causal, triangle=True)
                    what = (f"{name} {dtype} D={d} Sq={sq} Sk={sk} causal={causal} "
                            f"H={g * kv} KV={kv}")
                    worst = max(worst, flash_close(got, want, what))
                    if name == "wgmma_tf32x3":
                        split_kv_exact(k, v, what)
                        split_cases += 1
                torch.cuda.synchronize()
                log(f"flash parity {str(dtype).split('.')[-1]} D={d} ({name} instance"
                    f"{', the static rule' if name == fa.instance(dtype, d) else ''}): "
                    f"{len(cases)} shapes (Sq, Sk in 1..1000 and on the 128- and 192-row tile "
                    f"edges, groups 1/3/4/8, causal and not) within rtol = atol = "
                    f"{FLASH_TOL[dtype]}, max |err| {worst:.3g}")
    log(f"flash parity: split_kv (the 3xTF32 prepass) bit-identical to its plain version on "
        f"the {split_cases} float32 cases' k and v")
    # One batch of a qwen3-8b layer at full length (bf16 and float32 at head
    # dim 128, every instance), and bf16 with head dim 32.
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128), (torch.bfloat16, 32)):
        q, k, v = (torch.randn((1, 4096, heads, d), generator=gen, device="cuda")
                   .to(dtype) for heads in (32, 8, 8))
        want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
        for name in fa.instances(dtype, d):
            err = flash_close(fa.flash_attention_cuda(q, k, v, causal=True, instance=name), want,
                              f"{name} {dtype} B=1 S=4096 H=32 KV=8 D={d} causal")
            log(f"flash parity {str(dtype).split('.')[-1]} B=1 S=4096 H=32 KV=8 D={d} causal "
                f"({name} instance{', the static rule' if name == fa.instance(dtype, d) else ''})"
                f": within rtol = atol = {FLASH_TOL[dtype]}, max |err| {err:.3g}")
        del q, k, v, want


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def phase_lm(seed: int) -> tuple[dict, tuple, float]:
    """The LM serving path at full width: qwen3-8b on seeded weights,
    ``greedy_generate`` of LM["gen"] tokens after LM["batch"] prompts of
    LM["prompt"] tokens, checked teacher-forced against ``Model.forward``,
    with the off-by-one negative control.  Returns the path's launches,
    layer 0's (q, k, v) as the prefill handed them to the kernel, and the
    kernel's error against its plain version there."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.generate import greedy_generate

    cfg = configs.get(LM["arch"])
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"full size, LM serving: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, qk_norm {cfg.qk_norm}; {model.num_params():,} {cfg.param_dtype} "
        f"parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card from "
        f"seed {seed} in {time.perf_counter() - t0:.2f} s (set-up); compute {cfg.dtype}")
    engine = DecodeEngine(model)
    b, p, n = LM["batch"], LM["prompt"], LM["gen"]
    rng = np.random.default_rng(seed + 70)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    max_len = p + n

    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    out = greedy_generate(engine, prompt, n, max_len=max_len)
    launches = {"flash_attention": fa.flash_attention_cuda.instance_launches["wgmma"]}
    peak = torch.cuda.max_memory_allocated()
    if launches["flash_attention"] != cfg.num_layers or (
            fa.flash_attention_cuda.launches != cfg.num_layers) or (
            fa.flash_attention_cuda.lse_launches):
        raise AssertionError(f"flash_attention launched {fa.flash_attention_cuda.launches} "
                             f"times ({fa.flash_attention_cuda.instance_launches}, "
                             f"{fa.flash_attention_cuda.lse_launches} with lse) in a prefill of "
                             f"{cfg.num_layers} layers; every launch must be the wgmma "
                             f"instance, and serving asks for no lse")
    log(f"LM serving: {b} requests x {p} prompt tokens, max_len {max_len}: prefill "
        f"{out.prefill_s:.3f} s ({b * p / out.prefill_s:.1f} tokens/s); {n - 1} decode steps "
        f"{out.decode_s:.3f} s ({1e3 * out.decode_s / (n - 1):.2f} ms a step, "
        f"{b * (n - 1) / out.decode_s:.1f} tokens/s); flash_attention launches "
        f"{launches['flash_attention']}; peak memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated); first request's tokens "
        f"{out.tokens[0, :8].tolist()}...")

    with torch.inference_mode():
        # Teacher-forced: the forward pass over the prompt and every token
        # that decode was fed.
        full = torch.cat([prompt, out.tokens[:, :-1]], dim=1)
        fa.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        want, _ = model({"tokens": full})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        if fa.flash_attention_cuda.launches != cfg.num_layers:
            raise AssertionError(f"Model.forward launched flash_attention "
                                 f"{fa.flash_attention_cuda.launches} times")
        errs = [rel_rms(lg, want[:, p - 1 + t]) for t, lg in enumerate(out.logits)]
        agree = int((want[:, p - 1:].argmax(-1) == out.tokens).sum())
        if not all(np.isfinite(errs)) or max(errs) > LOGITS_REL_TOL:
            raise AssertionError(f"teacher-forced logits beyond {LOGITS_REL_TOL}: {errs}")
        rms = float(want[:, p - 1:].float().pow(2).mean().sqrt())
        log(f"LM serving: Model.forward over {full.shape[1]} tokens {fwd_s:.3f} s; logits "
            f"{list(want.shape)} {want.dtype}, RMS {rms:.4f} at the compared positions; "
            f"relative RMS error of the prefill's and each decode step's logits against it: "
            f"max {max(errs):.5f}, mean {float(np.mean(errs)):.5f} (tolerance "
            f"{LOGITS_REL_TOL}); greedy picks = forward argmax at {agree} of {out.tokens.numel()}")

        # Layer 0's q, k, v as a prefill hands them to the kernel; the
        # negative control decodes from the same prefill's cache.
        calls = []
        with capture_calls(fa, "flash_attention_cuda", calls):
            _, cache = engine.prefill(model, {"tokens": prompt}, max_len=max_len,
                                      last_only=True)
        (qkv, kw), = calls[:1]
        del calls
        got = fa.flash_attention_cuda(*qkv, **kw)
        err = flash_close(got, ref.flash_attention_ref(*qkv, **kw), "layer 0 of the prefill")
        log(f"flash_attention at layer 0's q {list(qkv[0].shape)}, k/v {list(qkv[1].shape)} "
            f"{qkv[0].dtype}: within rtol = atol = {FLASH_TOL[qkv[0].dtype]} of the plain "
            f"version, max |err| {err:.4g}")

        cache["cur"] -= 1   # the cache read one position off
        bad = []
        for t in range(n - 1):
            lg, cache = engine.decode_step(model, cache, {"tokens": out.tokens[:, t:t + 1]})
            bad.append(rel_rms(lg[:, -1], want[:, p + t]))
        if max(bad) <= LOGITS_REL_TOL:
            raise AssertionError(f"the off-by-one cache passed the logits check: {bad}")
        log(f"LM serving negative control: decoding with the cache read one position off "
            f"(cur - 1) fails the same check, as it must: relative RMS error max "
            f"{max(bad):.5f}, min {min(bad):.5f}, {sum(e > LOGITS_REL_TOL for e in bad)} of "
            f"{len(bad)} steps beyond {LOGITS_REL_TOL}")
    return launches, qkv, err


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi --query-gpu=clocks.max.sm``
    reports it (1,980 MHz on an H100 SXM)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip()) * 1e6


def flash_bound(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                instance: str | None = None, backward: bool = False, q_offset: int = 0):
    """FLOPs (4 D a (q, k) pair the mask leaves), bytes (q, o, k, v once),
    exps (one a pair) and the bound of ``instance`` (None: the static rule's
    for q's type): the largest of the bytes over the memory rate, the
    products over their rate and the exps over the ex2 rate (16 a clock an
    SM at the card's maximum SM clock).  The products: the FLOPs over the
    bf16 tensor rate in bf16; in float32 three TF32 products each over the
    TF32 tensor rate for the 3xTF32 instance, the FLOPs over the CUDA
    cores' rate for ``simt_f32``.  ``backward``: the backward's function,
    five products (S, dP, dV, dQ, dK: 10 D FLOPs a pair), q, k, v, out, do
    and lse read once and dq, dk, dv written once, one exp a pair, on the
    backward's instance for q's type.  ``q_offset``: q's rows sit at
    positions q_offset on (a slice of the q sequence), so causal row i sees
    q_offset + i + 1 keys, and K and V are read only up to the last row's
    key (min(Sk, q_offset + Sq) rows); the backward's dk and dv are written
    whole (zeros where no row of the slice reaches).  Returns (flops,
    bytes, (bound ms, "bytes" or "operations"), the binding term)."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    pairs = sum(min(q_offset + i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = (10 if backward else 4) * b * h * d * pairs
    kv_read = 2 * b * (min(sk, q_offset + sq) if causal else sk) * kv * d
    nbytes = (2 * q.numel() + kv_read) * q.element_size()
    if backward:   # q, out, do read and dq written; k, v read; dk, dv written
        nbytes = (4 * q.numel() + kv_read + 2 * k.numel()) * q.element_size() + 4 * b * h * sq
    ex2_per_s = (EX2_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
                 * max_sm_clock_hz())
    product = {"wgmma": ("bf16 tensor product", flops / PEAK_BF16_TENSOR_OPS_PER_S),
               "wgmma_tf32x3": ("3xTF32 tensor product", 3 * flops / PEAK_TF32_TENSOR_OPS_PER_S),
               "simt_f32": ("float32 FMA", flops / PEAK_OPS_PER_S)}[
                   fa.bwd_instance(q.dtype) if backward else fa.instance(q.dtype, d, instance)]
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S, product[0]: product[1],
             "exp": b * h * pairs / ex2_per_s}
    term = max(terms, key=terms.get)
    return flops, nbytes, (terms[term] * 1e3, "bytes" if term == "bytes" else "operations"), term


def phase_flash_timing(qkv: tuple, err: float) -> dict:
    """flash_attention timed at layer 0's operands of the LM prefill beside
    its plain version, its bound and scaled_dot_product_attention."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v = qkv
    b, sq, h, d = q.shape
    kernel = lambda: fa.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                  enable_gqa=True)
    ms, lib = cuda_ms(kernel, 20), cuda_ms(sdpa, 20)
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
    ms2, lib2 = cuda_ms(kernel, 20), cuda_ms(sdpa, 20)
    call = call_ms(kernel, 20)
    flops, nbytes, bound, term = flash_bound(q, k)
    log(f"timing at B={b} S={sq} H={h} KV={k.shape[2]} D={d} {q.dtype} causal (layer 0 of "
        f"the prefill), device time of back-to-back launches: flash_attention (wgmma) "
        f"{ms:.4f} / {ms2:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound[0] / ms:.1%} of its "
        f"bound {bound[0]:.4f} ms by {bound[1]}, the {term} term: {flops / 1e9:.1f} GFLOP and "
        f"{nbytes / 1e6:.1f} MB); scaled_dot_product_attention {lib:.4f} / {lib2:.4f} ms "
        f"({flops / lib / 1e9:.1f} TFLOP/s); plain {plain:.3f} ms; the kernel timed alone "
        f"{call:.4f} ms")
    row = kernel_row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:93", err=err, ms=ms,
                     plain_ms=plain, bound=bound, library_ms=lib,
                     path=f"full size, LM serving: {LM['arch']} prefill of "
                          f"{LM['batch']} x {LM['prompt']:,} tokens (wgmma instance)")
    row["bound_term"] = term
    return row


def flash_layer_operands(gen, d: int, dtype) -> tuple:
    """Random q, k, v at qwen3-8b's layer shape (LM batch and prompt, 32 / 8
    heads) with head dim d."""
    return tuple(torch.randn((LM["batch"], LM["prompt"], heads, d), generator=gen,
                             device="cuda").to(dtype) for heads in (32, 8, 8))


def sdpa_call(q, k, v, causal: bool = True):
    """One scaled_dot_product_attention call on the kernel's (B, S, H, D)
    operands: the yardstick the port never calls."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)


def sdpa_backend(q, k, v, causal: bool = True) -> str:
    """The backend PyTorch's dispatcher picks for ``sdpa_call(q, k, v, causal)``."""
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        return SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        return f"not known ({exc})"


def serve_reduced(seed: int, dtype: str) -> tuple[dict, tuple, float]:
    """The reduced qwen3-8b config in ``dtype`` through the serving path:
    ``greedy_generate`` of 8 tokens after 2 prompts of 200, checked
    teacher-forced against ``Model.forward``.  The prefill must launch the
    flash kernel once a layer, every time as the static rule's instance, and
    the 3xTF32 instance's prepass once before each of its launches.  Returns
    the launches (``{"flash_attention": n, "split_kv": n}``), layer 0's
    captured (q, k, v) and the kernel's error against its plain version
    there."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.generate import greedy_generate

    cfg = configs.get_reduced(LM["arch"], dtype=dtype)
    instance = fa.instance(getattr(torch, dtype), cfg.head_dim)
    dev = torch.device("cuda")
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    engine = DecodeEngine(model)
    rng = np.random.default_rng(seed + 71)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(dev)
    n = 8
    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    out = greedy_generate(engine, prompt, n, max_len=200 + n)
    counts = dict(fa.flash_attention_cuda.instance_launches)
    splits = fa.split_kv_cuda.launches
    if counts != {name: cfg.num_layers * (name == instance) for name in fa.INSTANCES} or (
            splits != cfg.num_layers * (instance == "wgmma_tf32x3")):
        raise AssertionError(f"the reduced {dtype} prefill launched flash_attention {counts} "
                             f"and split_kv {splits} times; expected {cfg.num_layers} {instance} "
                             f"launches and no other (and a prepass before each 3xTF32 one)")
    with torch.inference_mode():
        full = torch.cat([prompt, out.tokens[:, :-1]], dim=1)
        want, _ = model({"tokens": full})
        errs = [rel_rms(lg, want[:, 199 + t]) for t, lg in enumerate(out.logits)]
        if not all(np.isfinite(errs)) or max(errs) > LOGITS_REL_TOL:
            raise AssertionError(f"reduced {dtype} teacher-forced logits beyond "
                                 f"{LOGITS_REL_TOL}: {errs}")
        calls = []
        with capture_calls(fa, "flash_attention_cuda", calls):
            engine.prefill(model, {"tokens": prompt}, max_len=200 + n, last_only=True)
        (qkv, kw), = calls[:1]
        err = flash_close(fa.flash_attention_cuda(*qkv, **kw),
                          ref.flash_attention_ref(*qkv, **kw), f"reduced {dtype} layer 0")
    log(f"reduced {cfg.name} in {dtype} ({cfg.num_layers} layers, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}): 2 x 200 prompt tokens, {n} greedy "
        f"tokens; flash_attention launches by instance {counts}, split_kv {splits}; "
        f"teacher-forced logits max "
        f"relative RMS error {max(errs):.5f}; kernel at layer 0's q {list(qkv[0].shape)} within "
        f"{FLASH_TOL[qkv[0].dtype]} of its plain version, max |err| {err:.4g}")
    return {"flash_attention": counts[instance], "split_kv": splits}, qkv, err


def phase_flash_small_d(seed: int) -> tuple[dict, list[dict]]:
    """The flash kernel's bf16 instance at head dims 16 and 32 (wgmma; no
    full-width config has these head dims) through the serving path: the
    reduced qwen3-8b config in bf16 (head_dim 16).  Then the instance
    against the plain version at qwen3-8b's layer shape with head dims 32
    and 16, timed in turns with scaled_dot_product_attention (wgmma, SDPA,
    SDPA, wgmma), with its bound and its binding term.  Returns the path's
    launches and the kernel's row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    launches, _, err = serve_reduced(seed, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed + 72)
    at = {}
    for d in (32, 16):
        q, k, v = flash_layer_operands(gen, d, torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
        err = max(err, flash_close(fa.flash_attention_cuda(q, k, v), want,
                                   f"wgmma at B=4 S=4096 H=32 KV=8 D={d}"))
        del want
        turns = in_turns({"wgmma": lambda: fa.flash_attention_cuda(q, k, v),
                          "sdpa": sdpa_call(q, k, v)}, iters=20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
        flops, nbytes, bound, term = flash_bound(q, k)
        ms, lib = turns["wgmma"], turns["sdpa"]
        log(f"timing at B={LM['batch']} S={LM['prompt']} H=32 KV=8 D={d} bf16 causal, device "
            f"ms in turns: flash_attention wgmma {ms[0]:.4f} / {ms[1]:.4f} ({flops / ms[0] / 1e9:.1f}"
            f" TFLOP/s, {bound[0] / ms[0]:.1%} of its bound {bound[0]:.4f} ms by {bound[1]}, the "
            f"{term} term); scaled_dot_product_attention {lib[0]:.4f} / {lib[1]:.4f} ms "
            f"({bound[0] / lib[0]:.1%}, backend {sdpa_backend(q, k, v)}); plain {plain:.3f} ms")
        at[d] = {"ms": ms[0], "ms_turns": ms, "plain_ms": plain, "library_ms": lib[0],
                 "library_ms_turns": lib, "bound_ms": bound[0], "bound_by": bound[1],
                 "bound_term": term}
        del q, k, v
    row = kernel_row("flash_attention_d16_32", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:93", err=err, ms=at[32]["ms"],
                     plain_ms=at[32]["plain_ms"],
                     bound=(at[32]["bound_ms"], at[32]["bound_by"]),
                     library_ms=at[32]["library_ms"],
                     path=f"reduced {LM['arch']} in bf16 (head_dim 16): prefill of 2 x 200 "
                          f"tokens (wgmma instance); timed at B={LM['batch']} S={LM['prompt']} "
                          f"H=32 KV=8 D=32 (at_d16: D=16)")
    row.update(bound_term=at[32]["bound_term"], ms_turns=at[32]["ms_turns"],
               library_ms_turns=at[32]["library_ms_turns"], at_d16=at[16])
    return {"flash_attention_d16_32": launches["flash_attention"]}, [row]


def phase_flash_f32(seed: int) -> tuple[dict, list[dict]]:
    """The flash kernel in float32: the reduced qwen3-8b config in float32
    through the serving path (the static rule's instance once a layer, the
    3xTF32 prepass before each), then at qwen3-8b's layer shape in float32
    (TF32 off) both float32 instances against the plain version and the
    prepass against its own, the instances timed in turns (3xTF32, CUDA
    cores, CUDA cores, 3xTF32; the static rule's must be the faster in both
    turns), the prepass alone, the plain version, and
    scaled_dot_product_attention in float32 (as dispatched, and under the
    memory-efficient backend; the faster is the library time), each with
    its bound.  Returns the path's launches and the rows of the kernel and
    of its prepass."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, _, err = serve_reduced(seed, "float32")
    rule = fa.instance(torch.float32, 128)
    names = fa.instances(torch.float32, 128)
    gen = torch.Generator(device="cuda").manual_seed(seed + 73)
    q, k, v = flash_layer_operands(gen, 128, torch.float32)
    want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
    errs = {name: flash_close(fa.flash_attention_cuda(q, k, v, instance=name), want,
                              f"{name} at B=4 S=4096 H=32 KV=8 D=128") for name in names}
    del want
    split_kv_exact(k, v, "B=4 S=4096 KV=8 D=128")
    turns = in_turns({name: (lambda name=name: fa.flash_attention_cuda(q, k, v, instance=name))
                      for name in names}, iters=5)
    if max(turns[rule]) >= min(min(turns[n]) for n in names if n != rule):
        raise AssertionError(f"the float32 static rule's instance ({rule}) is not the faster "
                             f"in turns: {turns}")
    split_ms = cuda_ms(lambda: fa.split_kv_cuda(k, v), 20)
    split_plain = cuda_ms(lambda: ref.split_kv_ref(k, v), 5)
    # k and v read once; K's two parts and V^T's two (keys padded to 8) written once.
    skp = -(-k.shape[1] // 8) * 8
    split_bytes = 4 * k.numel() * 4 + 2 * (k.numel() // k.shape[1]) * skp * 4
    split_bound = bound_ms(split_bytes, 0)
    sdpa = sdpa_call(q, k, v)
    # The memory-efficient backend takes float32 but not GQA: K and V are
    # expanded to the 32 query heads before the timed region.
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(4, dim=2),
                                              v.repeat_interleave(4, dim=2)))

    def efficient_ms():
        """None, logged, where this PyTorch has no such kernel for the shape:
        it is a yardstick, not part of the port."""
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=True), 5)
        except RuntimeError as exc:
            log(f"scaled_dot_product_attention under EFFICIENT_ATTENTION: {exc}")
            return None

    lib, eff = cuda_ms(sdpa, 5), efficient_ms()
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
    lib2, eff2 = cuda_ms(sdpa, 5), efficient_ms()
    del qt, kt, vt
    bounds = {name: flash_bound(q, k, instance=name) for name in names}
    flops, nbytes = bounds[rule][:2]
    log(f"timing at B={LM['batch']} S={LM['prompt']} H=32 KV=8 D=128 float32 causal (TF32 "
        f"off), device ms in turns: " + "; ".join(
            f"flash_attention {name} {turns[name][0]:.4f} / {turns[name][1]:.4f} "
            f"({flops / turns[name][0] / 1e9:.2f} TFLOP/s, max |err| {errs[name]:.3g}, "
            f"{bounds[name][2][0] / turns[name][0]:.1%} of its bound {bounds[name][2][0]:.4f} ms "
            f"by {bounds[name][2][1]}, the {bounds[name][3]} term)" for name in names) +
        f"; {flops / 1e9:.1f} GFLOP and {nbytes / 1e6:.1f} MB; static rule {rule}, "
        f"{max(turns[n][0] for n in names) / turns[rule][0]:.2f}x the other instance; "
        f"split_kv (the 3xTF32 prepass, inside its time) {split_ms:.4f} ms "
        f"({split_bound[0] / split_ms:.1%} of its bound {split_bound[0]:.4f} ms by "
        f"{split_bound[1]}, {split_bytes / 1e6:.1f} MB; plain {split_plain:.3f} ms); "
        f"scaled_dot_product_attention (float32, enable_gqa, backend {sdpa_backend(q, k, v)}) "
        f"{lib:.4f} / {lib2:.4f} ms, under EFFICIENT_ATTENTION with K and V expanded to 32 "
        f"heads {eff} / {eff2} ms; plain {plain:.3f} ms")
    path = (f"reduced {LM['arch']} in float32: prefill of 2 x 200 tokens ({rule} instance); "
            f"timed at B={LM['batch']} S={LM['prompt']} H=32 KV=8 D=128")
    row = kernel_row("flash_attention_f32", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:93", err=max(err, errs[rule]),
                     ms=turns[rule][0], plain_ms=plain, bound=bounds[rule][2],
                     library_ms=min(lib, eff or lib), path=path)
    row.update(instance=rule, bound_term=bounds[rule][3], ms_turns=turns,
               max_abs_err_by_instance=errs,
               bound_by_instance={n: [bounds[n][2][0], bounds[n][3]] for n in names},
               library_ms_runs=[lib, lib2], library_efficient_ms_runs=[eff, eff2])
    split_row = kernel_row("flash_split_kv", "src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:93", err=0.0, ms=split_ms,
                           plain_ms=split_plain, bound=split_bound, path=path)
    del q, k, v
    return ({"flash_attention_f32": launches["flash_attention"],
             "flash_split_kv": launches["split_kv"]}, [row, split_row])


def shift_lse(lse: torch.Tensor) -> torch.Tensor:
    """A copy of the forward's lse (B, KV, G, Sq) raised by log 2 on query
    head 0: the negative controls' fault."""
    lse = lse.clone()
    lse[:, 0, 0] += math.log(2.0)
    return lse


@contextlib.contextmanager
def flash_forward(mode: str):
    """Route the layers' attention (``ops.flash_attention`` and
    ``ops.flash_attention_bwd``) while inside: ``"plain"`` runs both plain
    versions on the card's tensors (no kernel launches), ``"shifted"`` the
    kernels with the lse the forward hands the backward raised by log 2 on
    query head 0 (the negative control, ``shift_lse``)."""
    from repro_torch.kernels import ops, ref

    orig, orig_bwd = ops.flash_attention, ops.flash_attention_bwd

    def plain(q, k, v, *, causal=True, impl="auto", q_chunk=512, kv_chunk=512,
              triangle=False, return_lse=False, q_offset=0):
        return ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk, triangle=triangle,
                                       return_lse=return_lse, q_offset=q_offset)

    def plain_bwd(q, k, v, out, lse, do, *, causal=True, impl="auto", q_chunk=512,
                  kv_chunk=512, triangle=False, q_offset=0):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                           q_chunk=q_chunk, kv_chunk=kv_chunk,
                                           triangle=triangle, q_offset=q_offset)

    def shifted(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if not kw.get("return_lse"):
            return out
        out, lse = out
        return out, shift_lse(lse)

    ops.flash_attention = shifted if mode == "shifted" else plain
    if mode != "shifted":
        ops.flash_attention_bwd = plain_bwd
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_attention_bwd = orig, orig_bwd


def loss_and_grads(model, batch) -> tuple:
    """The train step's loss and gradients (its work before the optimizer),
    the gradients in the state's leaf order."""
    from repro_torch.train.tree import leaves_with_paths

    named = leaves_with_paths(model.param_tree())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {"/".join(n): g for (n, _), g in zip(named, grads)}


def grad_gate(got: tuple, want: tuple, dtype) -> tuple[float, float, str, bool]:
    """(loss relative error, the largest leaf's relative RMS error, that
    leaf, whether both are within the gate for ``dtype``)."""
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    errs = {name: rel_rms(g, want[1][name]) for name, g in got[1].items()}
    worst = max(errs, key=errs.get)
    ok = (loss_err <= TRAIN_LOSS_REL_TOL and all(np.isfinite(list(errs.values())))
          and errs[worst] <= GRAD_REL_TOL[dtype])
    return loss_err, errs[worst], worst, ok


def lse_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The largest |lse error|; raises beyond LSE_TOL (1 + |want|)."""
    diff = (got.double() - want.double()).abs()
    if got.shape != want.shape or not bool((diff <= LSE_TOL * (1 + want.double().abs())).all()):
        raise AssertionError(f"flash lse != plain version at {what}: max |err| "
                             f"{float(diff.max()):.3g}, tolerance {LSE_TOL} (1 + |lse|)")
    return float(diff.max())


def phase_train(seed: int) -> tuple[dict, dict]:
    """The LM training path at full width (phase 12 of the module's
    docstring).  Returns the measurements that the flash_attention row of
    the kernels line carries under ``training``, and the flash_attention_bwd
    row (its launches under ``bwd_launches``)."""
    import tempfile

    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.distributed import CheckpointManager, FaultTolerantRunner, RunnerConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import Model
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    from repro_torch.train.tree import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(TRAIN["arch"])
    dev = torch.device("cuda")
    b, s = TRAIN["batch"], TRAIN["seq"]
    out: dict = {"path": f"full size, LM training: {cfg.name}, {TRAIN['steps']} AdamW steps of "
                         f"{b} x {s:,} tokens through FaultTolerantRunner"}

    # (a) lse at the layer shape (bf16, D = 64) and at a reduced float32 shape,
    # then the backward kernel at both against its plain version.
    gen = torch.Generator(device=dev).manual_seed(seed + 80)
    shapes = {"bf16 D=64": ((b, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
                            torch.bfloat16),
              "float32 D=16": ((2, 512, 4, 2, 16), torch.float32)}
    out["lse_max_err"] = {}
    for what, ((bb, ss, h, kv, d), dtype) in shapes.items():
        q, k, v = (torch.randn((bb, ss, heads, d), generator=gen, device=dev).to(dtype)
                   for heads in (h, kv, kv))
        got, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        want, want_lse = ref.flash_attention_ref(q, k, v, causal=True, triangle=True,
                                                 return_lse=True)
        flash_close(got, want, f"training lse check, {what}")
        out["lse_max_err"][what] = lse_close(lse, want_lse, f"B={bb} S={ss} H={h} KV={kv} {what}")
        log(f"flash lse {what} ({fa.instance(dtype, d)} instance) at B={bb} S={ss} H={h} "
            f"KV={kv} causal: within {LSE_TOL} (1 + |lse|) of the plain version, max |err| "
            f"{out['lse_max_err'][what]:.3g}; lse range [{float(want_lse.min()):.3f}, "
            f"{float(want_lse.max()):.3f}]")
        if what == "bf16 D=64":
            layer = (q, k, v, got, lse)
        else:
            f32_layer = (q, k, v, got, lse)
    del q, k, v, got, lse, want, want_lse

    # The float32 backward (the CUDA-core instance) at the reduced shape.
    q, k, v, o, lse = f32_layer
    do = torch.randn(q.shape, generator=gen, device=dev)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    f32_err = {f"d{n}": rel_rms(g, w) for n, g, w in zip("qkv", got, want)}
    if not max(f32_err.values()) <= GRAD_REL_TOL[torch.float32]:
        raise AssertionError(f"the float32 backward kernel != its plain version at B=2 S=512 "
                             f"H=4 KV=2 D=16: relative RMS {f32_err} (gate "
                             f"{GRAD_REL_TOL[torch.float32]})")
    f32_turns = in_turns({"kernel": lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do),
                          "plain": lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do)},
                         iters=5)
    f32_bound = flash_bound(q, k, backward=True)
    out["bwd_f32"] = dict(instance=fa.bwd_instance(torch.float32), rel_rms=f32_err,
                          ms=f32_turns["kernel"], plain_ms=f32_turns["plain"],
                          bound_ms=f32_bound[2][0], bound_term=f32_bound[3])
    log(f"flash backward float32 ({fa.bwd_instance(torch.float32)} instance) at B=2 S=512 H=4 "
        f"KV=2 D=16 causal, TF32 off: dq, dk, dv against the plain version, relative RMS "
        f"{', '.join(f'{n} {e:.3g}' for n, e in f32_err.items())} (gate "
        f"{GRAD_REL_TOL[torch.float32]}); device ms in turns: kernel "
        f"{f32_turns['kernel'][0]:.4f} / {f32_turns['kernel'][1]:.4f}, plain "
        f"{f32_turns['plain'][0]:.3f} / {f32_turns['plain'][1]:.3f} (bound "
        f"{f32_bound[2][0]:.5f} ms, the {f32_bound[3]} term)")
    del f32_layer, q, k, v, o, lse, do, got, want

    # At the layer shape: the forward with and without lse in turns; the
    # backward kernel against its plain version and SDPA's gradients, and in
    # turns with each (SDPA's backward alone, on a retained graph).
    q, k, v, o, lse = layer
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    turns = in_turns({"lse": lambda: fa.flash_attention_cuda(q, k, v, return_lse=True),
                      "no_lse": lambda: fa.flash_attention_cuda(q, k, v)}, iters=20)
    flops, nbytes, bound, term = flash_bound(q, k)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True).backward(dot)

    sdpa_ms = cuda_ms(sdpa_fwd_bwd, 5)
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    sdpa_grads = [g.transpose(1, 2) for g in
                  torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True)]
    kernel_bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)  # noqa: E731
    plain_bwd = lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do)  # noqa: E731
    got, plain = kernel_bwd(), plain_bwd()
    errs = {vs: {f"d{n}": rel_rms(g, w) for n, g, w in zip("qkv", got if vs != "plain vs SDPA"
                                                             else plain, want)}
            for vs, want in (("kernel vs plain", plain), ("kernel vs SDPA", sdpa_grads),
                             ("plain vs SDPA", sdpa_grads))}
    bad = {vs: e for vs, e in errs.items() if not max(e.values()) <= GRAD_REL_TOL[torch.bfloat16]}
    if bad:
        raise AssertionError(f"the attention backward at a {cfg.name} layer: relative RMS {bad} "
                             f"(gate {GRAD_REL_TOL[torch.bfloat16]})")
    bwd_err = max(max_err_float(g, w) for g, w in zip(got, plain))
    del got, plain, sdpa_grads
    plain_turns = in_turns({"kernel": kernel_bwd, "plain": plain_bwd}, iters=5)
    sdpa_turns = in_turns({"kernel": kernel_bwd, "sdpa_bwd": lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True)}, iters=20)
    bflops, bbytes, bbound, bterm = flash_bound(q, k, backward=True)
    bwd_ms = plain_turns["kernel"][0]
    out.update(ms_with_lse=turns["lse"], ms_without_lse=turns["no_lse"], bound_ms=bound[0],
               bound_by=bound[1], bound_term=term, sdpa_fwd_bwd_ms=sdpa_ms,
               bwd_rel_rms=errs, plain_bwd_ms=plain_turns["plain"])
    bwd_row = kernel_row(
        "flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "repro/models/layers.py:137 _flash_bwd_impl (jnp, no TPU kernel)", err=bwd_err,
        ms=bwd_ms, plain_ms=plain_turns["plain"][0], bound=bbound,
        library_ms=sdpa_turns["sdpa_bwd"][0], path=out["path"])
    bwd_row.update(bound_term=bterm, ms_turns_with_plain=plain_turns["kernel"],
                   ms_turns_with_sdpa=sdpa_turns["kernel"], plain_ms_turns=plain_turns["plain"],
                   library_ms_turns=sdpa_turns["sdpa_bwd"], rel_rms=errs,
                   instance=fa.bwd_instance(q.dtype), f32=out["bwd_f32"])
    log(f"timing at B={b} S={s} H={cfg.num_heads} KV={cfg.num_kv_heads} D={cfg.head_dim} bf16 "
        f"causal (a {cfg.name} layer), device ms in turns: flash_attention with lse "
        f"{turns['lse'][0]:.4f} / {turns['lse'][1]:.4f}, without {turns['no_lse'][0]:.4f} / "
        f"{turns['no_lse'][1]:.4f} (bound {bound[0]:.4f} ms by {bound[1]}, the {term} term; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); scaled_dot_product_attention forward "
        f"and backward {sdpa_ms:.3f} ms")
    log(f"flash backward (flash_attention_bwd_cuda, {fa.bwd_instance(q.dtype)} instance) at the "
        f"same layer, relative RMS of dq, dk, dv: "
        + "; ".join(f"{vs} {', '.join(f'{n} {e:.4g}' for n, e in err.items())}"
                    for vs, err in errs.items())
        + f" (gate {GRAD_REL_TOL[torch.bfloat16]}); max |kernel - plain| {bwd_err:.3g}. Device "
        f"ms in turns: kernel {plain_turns['kernel'][0]:.4f} / {plain_turns['kernel'][1]:.4f}, "
        f"plain {plain_turns['plain'][0]:.3f} / {plain_turns['plain'][1]:.3f}; kernel "
        f"{sdpa_turns['kernel'][0]:.4f} / {sdpa_turns['kernel'][1]:.4f}, SDPA's backward "
        f"{sdpa_turns['sdpa_bwd'][0]:.4f} / {sdpa_turns['sdpa_bwd'][1]:.4f}; bound "
        f"{bbound[0]:.4f} ms by {bbound[1]}, the {bterm} term ({bflops / 1e9:.1f} GFLOP, "
        f"{bbytes / 1e6:.1f} MB; {bflops / bwd_ms / 1e9:.1f} TFLOP/s, {bbound[0] / bwd_ms:.1%} "
        f"of the bound)")
    del layer, q, k, v, o, lse, do, qt, kt, vt, dot, o_sdpa
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Gradient parity at full width, and the negative control.
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opt_cfg = OptimizerConfig(learning_rate=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              decay_steps=TRAIN["steps"])
    state = init_state(model, opt_cfg)
    loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                 vocab_size=cfg.vocab_size), device=dev)
    batch = next(loader)
    torch.cuda.synchronize()
    log(f"full size, LM training: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, remat {cfg.remat}; {model.num_params():,} "
        f"{cfg.param_dtype} parameters drawn from seed {seed} and their AdamW state in "
        f"{time.perf_counter() - t0:.2f} s (set-up); compute {cfg.dtype}; batches {b} x {s}")
    fa.reset_launches()
    kernel = loss_and_grads(model, batch)
    launches_per_step = fa.flash_attention_cuda.launches
    bwd_per_step = fa.flash_attention_bwd_cuda.launches
    if launches_per_step != 2 * cfg.num_layers or (
            fa.flash_attention_cuda.lse_launches != launches_per_step) or (
            bwd_per_step != cfg.num_layers):
        raise AssertionError(f"a train step launched flash_attention {launches_per_step} times, "
                             f"{fa.flash_attention_cuda.lse_launches} with lse, and its backward "
                             f"{bwd_per_step} times; expected {2 * cfg.num_layers} (forward and "
                             f"recomputation), all with lse, and {cfg.num_layers}")
    with flash_forward("plain"):
        plain = loss_and_grads(model, batch)
    if (fa.flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches) != (
            launches_per_step, bwd_per_step):
        raise AssertionError("the plain step launched a flash kernel")
    loss_err, worst, leaf, ok = grad_gate(kernel, plain, torch.bfloat16)
    if not ok:
        raise AssertionError(f"train step through the kernels != plain versions': loss relative "
                             f"error {loss_err:.3g} (gate {TRAIN_LOSS_REL_TOL}), {leaf} gradient "
                             f"relative RMS {worst:.4g} (gate {GRAD_REL_TOL[torch.bfloat16]})")
    with flash_forward("shifted"):
        bad = loss_and_grads(model, batch)
    bad_loss, bad_worst, bad_leaf, bad_ok = grad_gate(bad, plain, torch.bfloat16)
    if bad_ok:
        raise AssertionError(f"the lse shifted by log 2 on one head passed the gradient gate: "
                             f"{bad_leaf} relative RMS {bad_worst:.4g}")
    out.update(loss=kernel[0], loss_plain=plain[0], loss_rel_err=loss_err,
               grad_rel_rms_max=worst, grad_rel_rms_leaf=leaf,
               negative_control_rel_rms_max=bad_worst, negative_control_leaf=bad_leaf,
               launches_per_step=launches_per_step, bwd_launches_per_step=bwd_per_step)
    log(f"LM training gradients: the step through the flash kernels (forward and backward) "
        f"against the plain versions, loss {kernel[0]:.6f} vs {plain[0]:.6f} (relative "
        f"{loss_err:.3g}, gate {TRAIN_LOSS_REL_TOL}); largest gradient relative RMS error "
        f"{worst:.5f} ({leaf}; gate {GRAD_REL_TOL[torch.bfloat16]}); flash_attention launches a "
        f"step {launches_per_step} (all with lse), flash_attention_bwd {bwd_per_step}. Negative "
        f"control, lse + log 2 on one head: {bad_worst:.4f} ({bad_leaf}), fails the gate as it "
        f"must")
    del kernel, plain, bad
    gc.collect()

    small = Model(configs.get_reduced(TRAIN["arch"]), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    init_state(small, opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(seed + 81).integers(
        0, small.cfg.vocab_size, (4, 513)).astype(np.int32)).to(dev)
    small_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kernel = loss_and_grads(small, small_batch)
    with flash_forward("plain"):
        plain = loss_and_grads(small, small_batch)
    s_loss, s_worst, s_leaf, s_ok = grad_gate(kernel, plain, torch.float32)
    if not s_ok:
        raise AssertionError(f"reduced float32 train step through the kernel != plain forward's: "
                             f"loss {s_loss:.3g}, {s_leaf} relative RMS {s_worst:.3g} (gate "
                             f"{GRAD_REL_TOL[torch.float32]})")
    out.update(reduced_f32_grad_rel_rms_max=s_worst, reduced_f32_loss_rel_err=s_loss)
    log(f"reduced {small.cfg.name} in float32 ({fa.instance(torch.float32, small.cfg.head_dim)} "
        f"instance), 4 x 512 tokens: loss relative error {s_loss:.3g}, largest gradient relative "
        f"RMS error {s_worst:.3g} ({s_leaf}; gate {GRAD_REL_TOL[torch.float32]})")
    del small, kernel, plain

    # Forward and loss alone, as the step runs them (graph built, lse written).
    def forward_loss():
        model.loss(batch)

    fwd_ms = cuda_ms(forward_loss, 3, warmup=1)

    # (c) The trainer: every step's device time by CUDA events.
    step_raw = make_train_step(model, opt_cfg)
    events, losses = [], []

    def step_fn(st, bt):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        st, metrics = step_raw(st, bt)
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
        return st, metrics

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir)
        runner = FaultTolerantRunner(step_fn, lambda _: (state, None), loader, ckpt,
                                     RunnerConfig(checkpoint_every=TRAIN["ckpt_every"],
                                                  async_checkpoint=True, max_restarts=0))
        torch.cuda.reset_peak_memory_stats()
        # The path: the counters zeroed just before, read just after.
        fa.reset_launches()
        t0 = time.perf_counter()
        result = runner.run(TRAIN["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.flash_attention_cuda.instance_launches["wgmma"],
                    "lse": fa.flash_attention_cuda.lse_launches,
                    "flash_attention_bwd": fa.flash_attention_bwd_cuda.instance_launches["wgmma"]}
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        step_ms = [e[0].elapsed_time(e[1]) for e in events]
        kinds = [e.kind for e in result["events"]]
        expected = TRAIN["steps"] * launches_per_step
        if (result["restarts"] or "failure" in kinds or len(losses) != TRAIN["steps"]
                or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
                or launches != {"flash_attention": expected, "lse": expected,
                                "flash_attention_bwd": TRAIN["steps"] * bwd_per_step}):
            raise AssertionError(f"training run: restarts {result['restarts']}, events {kinds}, "
                                 f"losses {losses}, flash launches {launches} (expected "
                                 f"{expected}, all wgmma with lse, and "
                                 f"{TRAIN['steps'] * bwd_per_step} of the backward's wgmma)")
        med = statistics.median(step_ms[2:])
        out.update(losses=losses, step_ms=med, step_ms_all=step_ms, tokens_per_s=b * s / med * 1e3,
                   peak_memory_gb=peak / 1e9, forward_loss_ms=fwd_ms,
                   forward_loss_share=fwd_ms / med, launches=launches["flash_attention"],
                   lse_launches=launches["lse"], bwd_launches=launches["flash_attention_bwd"],
                   run_s=wall)
        log(f"LM training: {TRAIN['steps']} AdamW steps (lr {TRAIN['lr']}, {TRAIN['warmup']} "
            f"warmup) through FaultTolerantRunner in {wall:.2f} s (async checkpoints every "
            f"{TRAIN['ckpt_every']} steps included), restarts {result['restarts']}, events {kinds}; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {med:.2f} ms (CUDA events, median "
            f"of steps 3-{TRAIN['steps']}; range {min(step_ms[2:]):.2f}-{max(step_ms[2:]):.2f}), "
            f"{b * s / med * 1e3:,.0f} tokens/s; forward and loss {fwd_ms:.2f} ms "
            f"({fwd_ms / med:.1%} of a step); peak memory {peak / 1e9:.2f} GB "
            f"(torch.cuda.max_memory_allocated); flash_attention launches {launches['flash_attention']}"
            f" ({launches_per_step} a step), {launches['lse']} with lse; flash_attention_bwd "
            f"launches {launches['flash_attention_bwd']} ({bwd_per_step} a step)")

        # (d) The checkpoint round trip.
        at = ckpt.latest_step()
        fresh = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed + 1))
        fresh_state, at = ckpt.restore(init_state(fresh, opt_cfg))
    trained = leaves_with_paths(result["state"])
    restored = leaves_with_paths(fresh_state)
    same = [a == c and torch.equal(x, y) for (a, x), (c, y) in zip(trained, restored)]
    if at != TRAIN["steps"] or len(trained) != len(restored) or not all(same):
        raise AssertionError(f"checkpoint round trip: step {at}, "
                             f"{len(same) - sum(same)} of {len(same)} leaves differ")
    nxt = next(loader)
    _, m_run = step_raw(result["state"], nxt)
    _, m_restored = make_train_step(fresh, opt_cfg)(fresh_state, nxt)
    if float(m_run["loss"]) != float(m_restored["loss"]):
        raise AssertionError(f"the step after the restore: loss {float(m_restored['loss'])} != "
                             f"the uninterrupted run's {float(m_run['loss'])}")
    out.update(checkpoint_leaves=len(same), next_loss=float(m_run["loss"]))
    log(f"LM training checkpoint: step {at} restored into a fresh model's state, {len(same)} "
        f"leaves identical; the next step's loss {float(m_restored['loss']):.6f} equals the "
        f"uninterrupted run's")
    return out, bwd_row

# ---------------------------------------------------------------------------
# Phase 13: the paper's CPU algorithms and the dedup pipeline
# ---------------------------------------------------------------------------

# The paper's Tables 5-8 at the reference benchmark's sizes (jaccard); the
# extra cell reaches Bitmap-Set and runs only while the phase is inside its
# budget.
CPU_CELLS = (("UNIFORM", 0.8), ("UNIFORM", 0.6), ("ZIPF", 0.8), ("DBLP", 0.8))
CPU_EXTRA_CELL = ("UNIFORM", 0.5)
PHASE13_BUDGET_S = 120.0
# Dedup at full size (phase 4's ZIPF): the corpus is the deduped first
# 80,000 sets, then four shards of 5,000 from the rest, each with 50
# near-copies of corpus rows and (after the first) 50 of the previous
# shard's rows; then 20,000 synthetic documents, a tenth near-copies.
DEDUP = dict(tau=0.8, corpus_rows=80_000, shards=4, shard_rows=5_000, plant=50,
             documents=20_000)
# The clusters planted into ZIPF (phases 4, 7 and 13).
ZIPF_CLUSTERS = dict(n_clusters=1000, cluster_size=3, jaccard=0.9)


@contextlib.contextmanager
def timed_calls(owner, name: str, totals: dict, key: str):
    """Wrap ``owner.name`` so that each call adds its wall seconds (the card
    synchronised on both sides) to ``totals[key]``; restored on exit."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    try:
        yield totals
    finally:
        setattr(owner, name, fn)


def cpu_collections(seed: int) -> dict:
    """The reference benchmark's collections and sizes
    (``benchmarks/bench_cpu_algos.py:22-27`` through ``benchmarks/common.py``):
    UNIFORM 2,000 at b = 64; ZIPF 1,200 and DBLP-like at b = 128 (the
    benchmark asks ``collection("dblp", 700)``, which makes 500 sets)."""
    from repro_torch.data.collections import (dblp_like_collection, uniform_collection,
                                              zipf_collection)

    return {"UNIFORM": (uniform_collection(n_sets=2000, avg_size=10, n_tokens=220,
                                           seed=seed), 64),
            "ZIPF": (zipf_collection(n_sets=1200, avg_size=50, n_tokens=101_584,
                                     seed=seed), 128),
            "DBLP": (dblp_like_collection(n_sets=500, seed=seed), 128)}


def cpu_bitmaps_on_card(cols: dict) -> None:
    """(a) ``BitmapFilter.build`` on the card gives the CPU's words, bit for
    bit, for Set, Xor and Next at b = 64 and 128."""
    from repro_torch.core.filters import BitmapFilter

    words = 0
    for name, (col, _) in cols.items():
        for b in (64, 128):
            for method in ("set", "xor", "next"):
                args = (col.tokens, col.lengths, "jaccard", 0.8)
                card = BitmapFilter.build(*args, b=b, method=method, device="cuda")
                cpu = BitmapFilter.build(*args, b=b, method=method, device="cpu")
                if card.words.dtype != np.uint32 or not np.array_equal(card.words, cpu.words):
                    raise AssertionError(f"{name} b={b} {method}: the card's bitmap words "
                                         f"differ from the CPU's")
                words += card.words.size
    log(f"phase 13 (a) bitmaps on the card: BitmapFilter.build for set, xor, next at b = 64 "
        f"and 128 over {', '.join(f'{n} {c.num_sets}' for n, (c, _) in cols.items())}: "
        f"{words} uint32 words, identical to the CPU's bit for bit")


def cpu_cell(name: str, col, b: int, tau: float) -> dict:
    """(b) and (c) for one collection and threshold: each CPU algorithm
    without and with the Bitmap Filter (its words built on the card), against
    the card's blocked join and ``naive_join``; times on the host's clock."""
    from repro_torch.core import cpu_algos, engine, join
    from repro_torch.core.filters import BitmapFilter

    t0 = time.perf_counter()
    bf = BitmapFilter.build(col.tokens, col.lengths, "jaccard", tau, b=b, device="cuda")
    build_ms = (time.perf_counter() - t0) * 1e3
    prep = engine.prepare(col, "cuda")

    def blocked():
        return join.blocked_bitmap_join_prepared(prep, sim="jaccard", tau=tau, b=b,
                                                 block=MAIN["block"], compaction="device")

    want, cold_s = _timed(blocked)
    warm = [_timed(blocked) for _ in range(3)]
    oracle = join.naive_join(col, "jaccard", tau, device="cuda")
    if not all(np.array_equal(p, oracle) for p in [want] + [p for p, _ in warm]):
        raise AssertionError(f"{name} tau={tau}: blocked {len(want)} pairs vs naive "
                             f"{len(oracle)}")
    card_ms = statistics.median(s for _, s in warm) * 1e3
    runs = {}
    for algo, fn in cpu_algos.ALGORITHMS.items():
        t0 = time.perf_counter()
        orig = fn(col, "jaccard", tau)
        t1 = time.perf_counter()
        stats = cpu_algos.AlgoStats()
        with_bf = fn(col, "jaccard", tau, bitmap=bf, stats=stats)
        t2 = time.perf_counter()
        if not (np.array_equal(orig, with_bf) and np.array_equal(orig, want)):
            raise AssertionError(f"{name} tau={tau} {algo}: {len(orig)} pairs without the "
                                 f"filter, {len(with_bf)} with, {len(want)} by the card")
        runs[algo] = dict(orig_ms=(t1 - t0) * 1e3, bf_ms=(t2 - t1) * 1e3,
                          improvement=(t1 - t0) / (t2 - t1) - 1.0,
                          bitmap_pruned=stats.bitmap_pruned, candidates=stats.candidates,
                          verified=stats.verified, pairs=len(orig))
        r = runs[algo]
        log(f"phase 13 (b) {name} n={col.num_sets} tau={tau} b={b} {bf.method} {algo}: "
            f"{r['orig_ms']:.1f} ms, with the filter {r['bf_ms']:.1f} ms, improvement "
            f"t_orig / t_bf - 1 = {r['improvement']:+.1%}; bitmap_pruned "
            f"{r['bitmap_pruned']} of {r['candidates']} candidates, {r['verified']} "
            f"verified, {r['pairs']} pairs (= the card's blocked and naive joins)")
    fastest = min(runs, key=lambda a: runs[a]["bf_ms"])
    ratio = runs[fastest]["bf_ms"] / card_ms
    log(f"phase 13 (c) {name} tau={tau}: the card's warm blocked join {card_ms:.3f} ms "
        f"(median of 3; cold {cold_s * 1e3:.1f} ms), the fastest CPU algorithm with the filter "
        f"({fastest}) {runs[fastest]['bf_ms']:.1f} ms: the card {ratio:.1f}x faster, against "
        f"the port's Python CPU algorithms (not the paper's C++)")
    return dict(n=col.num_sets, b=b, method=bf.method, cutoff=bf.cutoff,
                filter_build_ms=build_ms, card_warm_ms=card_ms, card_cold_ms=cold_s * 1e3,
                fastest=fastest, card_speedup=ratio, algos=runs)


def engine_cpu_plans(col, b: int, seed: int) -> list:
    """(d) ``JoinEngine`` under each CPU driver, from explicit plans and from
    ``JoinPlanner.plan(prefer="cpu")``, on a card-prepared collection: the
    self-join and three probes of one 500-row batch equal the blocked
    engine's pairs, and the prefix index is built once (GroupJoin indexes its
    groups and builds none, as in the reference)."""
    from repro_torch.core import cpu_algos, engine
    from repro_torch.core.plan import JoinPlan, JoinPlanner

    batch = probe_batches(col, seed, n_batches=1, rows=500)[0]
    plans = [("explicit", JoinPlan(driver=d, sim="jaccard", tau=0.8, b=b))
             for d in cpu_algos.ALGORITHMS]
    plans += [("planner", JoinPlanner(b=b).plan("jaccard", tau, col.num_sets, prefer="cpu",
                                                backend="gpu", n_devices=1))
              for tau in (0.8, 0.5)]
    want, out = {}, []
    for source, plan in plans:
        tau = plan.tau
        if tau not in want:
            blocked = engine.JoinEngine(
                engine.prepare(col, "cuda"), "jaccard", tau,
                plan=JoinPlan(driver="blocked", sim="jaccard", tau=tau, b=b,
                              compaction="device"))
            want[tau] = (blocked.self_join(), blocked.probe(batch, return_stats=False))
        eng = engine.JoinEngine(engine.prepare(col, "cuda"), "jaccard", tau, plan=plan)
        (pairs, stats), self_s = _timed(lambda: eng.self_join(return_stats=True))
        probes = [_timed(lambda: eng.probe(batch)) for _ in range(3)]
        if not np.array_equal(pairs, want[tau][0]):
            raise AssertionError(f"{source} {plan.driver} tau={tau}: self-join {len(pairs)} "
                                 f"pairs vs the blocked engine's {len(want[tau][0])}")
        for (got, _), _s in probes:
            if not np.array_equal(got, want[tau][1]):
                raise AssertionError(f"{source} {plan.driver} tau={tau}: probe {len(got)} "
                                     f"pairs vs the blocked engine's {len(want[tau][1])}")
        builds = eng.prepared.builds["prefix_index"]
        if builds != (plan.driver != "groupjoin") or eng.fallbacks:
            raise AssertionError(f"{source} {plan.driver}: prefix_index built {builds} times, "
                                 f"fallbacks {eng.fallbacks}")
        probe_ms = [s * 1e3 for _, s in probes]
        log(f"phase 13 (d) JoinEngine, {source} plan {plan.driver} (tau={tau}, b={plan.b}, "
            f"{plan.method}) on a card-prepared UNIFORM {col.num_sets}: self-join "
            f"{self_s * 1e3:.1f} ms, {len(pairs)} pairs; 500-row probes "
            f"{', '.join(f'{t:.1f}' for t in probe_ms)} ms, {len(probes[0][0][0])} pairs; "
            f"= the blocked engine's; prefix_index built {builds}; stats "
            f"{json.dumps(stats.to_dict())}")
        out.append(dict(source=source, driver=plan.driver, tau=tau, self_ms=self_s * 1e3,
                        probe_ms=probe_ms, prefix_index=builds))
    return out


def planted_clusters(base, col, n_clusters: int, cluster_size: int, jaccard: float,
                     seed: int) -> list:
    """The clusters ``with_duplicates(base, ...)`` planted, as sets of row
    indices of ``col`` (its result): the draws replayed, each cluster's rows
    relabelled as ``preprocess`` relabels the whole and looked up in ``col``
    (a row that ``col`` holds more than once maps to every copy)."""
    import itertools

    from repro_torch.core.collection import _frequency_lut

    rng = np.random.default_rng(seed)
    rows = base.as_lists()
    universe = max(max(r) for r in rows if r) + 1
    clusters = []
    for _ in range(n_clusters):
        src = rows[int(rng.integers(0, len(rows)))]
        n = len(src)
        keep = min(max(int(round(2 * jaccard * n / (1 + jaccard))), 1), n)
        members = [src]
        for _ in range(cluster_size - 1):
            kept = list(rng.choice(src, size=keep, replace=False))
            extra = [int(rng.integers(universe, universe + 10 * n)) for _ in range(n - keep)]
            rows.append(sorted(set(kept + extra)))
            members.append(rows[-1])
        clusters.append(members)
    lut = _frequency_lut(np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64))
    where = collections.defaultdict(list)
    for i in range(col.num_sets):
        where[tuple(col.row(i).tolist())].append(i)
    return [set(itertools.chain.from_iterable(
        where[tuple(sorted(lut[int(t)] for t in m))] for m in members)) for members in clusters]


def synthetic_documents(n: int, seed: int) -> tuple[list, list]:
    """``n`` documents of 15-35 words from a 5,000-word random vocabulary;
    every tenth after the first 100 is a copy of an earlier document with one
    character changed (its index is returned as planted)."""
    rng = np.random.default_rng(seed + 13)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, size=int(rng.integers(3, 10))))
                      for _ in range(5000)])   # an array: choice would convert a list each call
    docs, planted = [], []
    for i in range(n):
        if i >= 100 and i % 10 == 0:
            src = docs[int(rng.integers(i))]
            k = int(rng.integers(len(src)))
            docs.append(src[:k] + "~" + src[k + 1:])
            planted.append(i)
        else:
            docs.append(" ".join(rng.choice(vocab, size=int(rng.integers(15, 36))).tolist()))
    return docs, planted


def dedup_full(seed: int, zipf_base, zipf, zipf_pairs) -> tuple[dict, dict]:
    """(e) Dedup at full size on the card, through the port's entry points,
    with the dense kernels' launch counters zeroed just before and read just
    after; returns the timings and the launches."""
    from repro_torch.core import join
    from repro_torch.core.collection import Collection, from_lists
    from repro_torch.data import dedup
    from repro_torch.kernels import bitmap_filter, compaction
    from repro_torch.store import CorpusStore

    tau = DEDUP["tau"]
    t0 = time.perf_counter()
    clusters = planted_clusters(zipf_base, zipf, **ZIPF_CLUSTERS, seed=seed)
    docs, planted = synthetic_documents(DEDUP["documents"], seed)
    log(f"phase 13 (e) set-up, not timed: replayed the {len(clusters)} planted clusters of ZIPF and "
        f"generated {len(docs)} documents in {time.perf_counter() - t0:.1f} s")
    counts = LaunchCounts(candidate_matrix_mxu=bitmap_filter.candidate_matrix_mxu_cuda,
                          count_candidates_mxu=compaction.count_candidates_mxu_cuda,
                          candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                          count_candidates=compaction.count_candidates_cuda)
    out = {}
    counts.zero()

    # dedup_collection over the whole collection, then over what it kept.
    t, t2 = {}, {}
    with timed_calls(dedup, "blocked_bitmap_join", t, "join"):
        res, total_s = _timed(lambda: dedup.dedup_collection(zipf, tau, device="cuda"))
    kept = Collection(tokens=zipf.tokens[res.keep], lengths=zipf.lengths[res.keep])
    with timed_calls(dedup, "blocked_bitmap_join", t2, "join"):
        res2, again_s = _timed(lambda: dedup.dedup_collection(kept, tau, device="cuda"))
    if not np.array_equal(res.pairs, zipf_pairs):
        raise AssertionError(f"dedup_collection found {len(res.pairs)} pairs, phase 4's "
                             f"blocked join {len(zipf_pairs)}")
    if len(res2.pairs):
        raise AssertionError(f"the kept sets still hold {len(res2.pairs)} pairs at {tau}")
    kept_mask = np.zeros(zipf.num_sets, dtype=bool)
    kept_mask[res.keep] = True
    uf = dedup._UnionFind(zipf.num_sets)
    for i, j in res.pairs:
        uf.union(int(i), int(j))
    roots = np.array([uf.find(i) for i in range(zipf.num_sets)])
    component = collections.Counter(roots.tolist())
    alone = 0
    for c, rows in enumerate(clusters):
        rows = sorted(rows)
        n_kept = int(kept_mask[rows].sum())
        if len(rows) < 2 or len({int(roots[r]) for r in rows}) != 1 or n_kept > 1:
            raise AssertionError(f"planted cluster {c} (rows {rows}): roots "
                                 f"{[int(roots[r]) for r in rows]}, {n_kept} kept")
        if component[int(roots[rows[0]])] == len(rows):
            alone += 1
            if n_kept != 1:
                raise AssertionError(f"planted cluster {c} keeps {n_kept} members")
    uf_s = total_s - t["join"]
    log(f"phase 13 (e) dedup_collection, ZIPF {zipf.num_sets} sets at tau={tau} on the card: "
        f"{total_s:.3f} s = join {t['join']:.3f} s + union-find and keep / drop "
        f"{uf_s:.3f} s; kept {len(res.keep)}, dropped {len(res.drop)}, {len(res.pairs)} "
        f"pairs = phase 4's blocked join; every planted cluster in one component keeping at "
        f"most one member, exactly one for the {alone} of {len(clusters)} whose component is the "
        f"cluster itself (the rest are joined to other rows); the kept sets deduped again: "
        f"no pair, {again_s:.3f} s = join {t2['join']:.3f} s + union-find "
        f"{again_s - t2['join']:.3f} s")
    out["collection"] = dict(sets=zipf.num_sets, kept=len(res.keep), dropped=len(res.drop),
                             pairs=len(res.pairs), wall_s=total_s, join_s=t["join"],
                             union_find_s=uf_s, again_s=again_s, again_join_s=t2["join"],
                             clusters_alone=alone)

    # dedup_shards: the deduped first 80,000 sets as the corpus, four shards.
    rng = np.random.default_rng(seed + 17)
    raw = Collection(tokens=zipf.tokens[:DEDUP["corpus_rows"]],
                     lengths=zipf.lengths[:DEDUP["corpus_rows"]])
    base = dedup.dedup_collection(raw, tau, device="cuda")
    corpus = Collection(tokens=raw.tokens[base.keep], lengths=raw.lengths[base.keep])
    universe = int(zipf.tokens[zipf.lengths > 0].max()) + 1
    shards, prev = [], None
    for k in range(DEDUP["shards"]):
        a = DEDUP["corpus_rows"] + k * DEDUP["shard_rows"]
        rows = [zipf.row(i).tolist() for i in range(a, a + DEDUP["shard_rows"])]
        step = DEDUP["shard_rows"] // DEDUP["plant"]
        for j in range(0, len(rows), step):
            rows[j] = _perturbed(corpus.row(int(rng.integers(corpus.num_sets))).tolist(),
                                 rng, universe)
            if prev is not None:
                rows[j + step // 2] = _perturbed(list(prev[int(rng.integers(len(prev)))]),
                                                 rng, universe)
        shards.append(from_lists(rows))
        prev = rows
    t = {}
    with timed_calls(CorpusStore, "probe", t, "probe"), \
            timed_calls(CorpusStore, "append", t, "append"), \
            timed_calls(dedup, "dedup_collection", t, "within"):
        (results, store), shards_s = _timed(lambda: dedup.dedup_shards(
            corpus, shards, tau, return_store=True, device="cuda"))
    final, final_s = _timed(store.self_join)
    if len(final) or store.builds()["sort"] != 1:
        raise AssertionError(f"dedup_shards: the final store's self-join holds {len(final)} "
                             f"pairs, its base sorted {store.builds()['sort']} times")
    if not any(len(r.pairs_rs) and r.pairs_rs[:, 0].max() >= corpus.num_sets
               for r in results):
        raise AssertionError("no shard dropped a document against a prior shard's survivor")
    log(f"phase 13 (e) dedup_shards: corpus {corpus.num_sets} sets (the deduped first "
        f"{raw.num_sets}), {len(shards)} shards of {DEDUP['shard_rows']} with "
        f"{DEDUP['plant']} near-copies of corpus rows each and {DEDUP['plant']} of the "
        f"previous shard's: {shards_s:.3f} s = probes of the store {t['probe']:.3f} s + "
        f"within-shard dedup {t['within']:.3f} s + appends {t['append']:.3f} s + the rest "
        f"(preparing the corpus, masks) "
        f"{shards_s - t['probe'] - t['within'] - t['append']:.3f} s; dropped against the "
        f"store {[len(r.drop_vs_corpus) for r in results]}, within "
        f"{[len(r.drop_within) for r in results]}; the final store ({store.num_sets} sets) "
        f"self-joins to no pair in {final_s:.3f} s; its base sorted once")
    out["shards"] = dict(corpus=corpus.num_sets, wall_s=shards_s, probe_s=t["probe"],
                         within_s=t["within"], append_s=t["append"],
                         dropped=[len(r.drop_vs_corpus) for r in results],
                         store_sets=store.num_sets, final_self_join_s=final_s)

    # dedup_documents: shingling, the join, union-find.
    t = {}
    with timed_calls(dedup, "dedup_collection", t, "dedup"), \
            timed_calls(dedup, "blocked_bitmap_join", t, "join"):
        (kept_docs, res), docs_s = _timed(lambda: dedup.dedup_documents(docs, tau,
                                                                         device="cuda"))
    missed = sorted(set(planted) - set(res.drop.tolist()))
    if missed:
        raise AssertionError(f"dedup_documents kept {len(missed)} planted copies: {missed[:10]}")
    log(f"phase 13 (e) dedup_documents: {len(docs)} documents, {len(planted)} planted "
        f"near-copies, all dropped; kept {len(kept_docs)}: {docs_s:.3f} s = shingling "
        f"{docs_s - t['dedup']:.3f} s + join {t['join']:.3f} s + union-find "
        f"{t['dedup'] - t['join']:.3f} s; stats {json.dumps(res.stats.to_dict())}")
    out["documents"] = dict(docs=len(docs), planted=len(planted), kept=len(kept_docs),
                            wall_s=docs_s, shingle_s=docs_s - t["dedup"], join_s=t["join"],
                            union_find_s=t["dedup"] - t["join"])
    launches = counts.read()
    log(f"phase 13 (e) dedup path launches: {json.dumps(launches)}")
    check_dense_launches(launches, MAIN["b"], "the dedup path")
    return out, launches


def phase_cpu_and_dedup(seed: int, zipf_base, zipf, zipf_pairs) -> tuple[dict, dict]:
    """Phase 13: the paper's CPU algorithms with the filter's words built on
    the card, the card against them, the engine's CPU plans, and dedup at
    full size.  Returns a summary and the dedup path's launches."""
    from repro_torch.core.collection import Collection

    t0 = time.perf_counter()
    cols = cpu_collections(seed)
    cpu_bitmaps_on_card(cols)
    cells = {}
    for name, tau in CPU_CELLS:
        col, b = cols[name]
        cells[f"{name} tau={tau}"] = cpu_cell(name, col, b, tau)
    plans = engine_cpu_plans(*cols["UNIFORM"], seed)
    dedup_out, launches = dedup_full(seed, zipf_base, zipf, zipf_pairs)
    # The extra cell on every other of UNIFORM's sets (its run at all 2,000
    # took 25 s), and only when the phase's budget allows it (its run about
    # 1.5 times the tau = 0.6 cell's at a quarter of the pairs).
    spent = time.perf_counter() - t0
    prev = cells["UNIFORM tau=0.6"]["algos"].values()
    need = 1.5 / 4 * sum(r["orig_ms"] + r["bf_ms"] for r in prev) / 1e3
    name, tau = CPU_EXTRA_CELL
    if spent + need < PHASE13_BUDGET_S:
        col = cols[name][0]
        half = Collection(tokens=np.ascontiguousarray(col.tokens[::2]),
                          lengths=np.ascontiguousarray(col.lengths[::2]))
        cells[f"{name} tau={tau}"] = cpu_cell(name, half, cols[name][1], tau)
    else:
        log(f"phase 13 (b) {name} tau={tau} skipped: {spent:.1f} s spent, about {need:.1f} s "
            f"more would pass the {PHASE13_BUDGET_S:.0f} s budget")
    improvements = [r["improvement"] for c in cells.values() for r in c["algos"].values()]
    seconds = time.perf_counter() - t0
    log(f"phase 13: {len(improvements)} algorithm runs, the filter faster in "
        f"{sum(i > 0 for i in improvements)}, mean improvement "
        f"{statistics.mean(improvements):+.1%}; phase {seconds:.1f} s")
    summary = dict(cells=cells, engine_cpu_plans=plans, dedup=dedup_out, seconds=seconds)
    log(json.dumps({"phase13": summary}))
    return summary, launches


# ---------------------------------------------------------------------------
# Phases 14-16: the flash kernels at head dim 112, the ssm and hybrid
# families served at full width, the hybrid family trained at full width
# ---------------------------------------------------------------------------

# zamba2-7b's shared attention: 32 heads of 112 (MHA), at the serving phase's
# shape and the training phase's.
D112 = dict(heads=32, d=112, serve=(4, 1024), train=(2, 2048))
# The lse and backward sweep at D = 112: Sq, Sk, causal, group (H / KV), KV
# (odd lengths, the 128-row and 128-key tile edges, Sq != Sk both ways, GQA).
D112_SWEEP = [(1, 1, True, 1, 2), (63, 63, True, 3, 2), (100, 37, False, 8, 2),
              (127, 129, True, 1, 2), (129, 129, False, 4, 2), (257, 255, True, 3, 1),
              (255, 257, False, 1, 2), (128, 257, True, 4, 1), (385, 384, True, 8, 1)]
# Phase 15: both families at their published configs, 4 requests of 1,024
# prompt tokens (a multiple of ssm_chunk = 256), 16 greedy tokens.
SSM_SERVE = dict(archs=("zamba2-7b", "mamba2-2.7b"), batch=4, prompt=1024, gen=16)
# In bf16 a perturbation of bf16 size grows through the Mamba2 stack: with
# seeded weights, teacher-forced decode drifts from Model.forward by 7% at
# the first step and 42% by the 15th at zamba2-7b's 81 layers, and the JAX
# package's bf16 drifts as much (tests/test_torch_ssm.py).  So phase 15's
# end-to-end gates run the same generation in float32 (TF32 off; the flash
# kernel's 3xTF32 instance, within 2e-5 of float32): the teacher-forced
# logits, and the hybrid family's whole prefill through the kernel against
# the same through the plain versions, as relative RMS (logits and every
# cache leaf).  The bf16 kernel is held to its plain version at each of the
# prefill's captured applications (FLASH_TOL).
F32_TF_REL_TOL = 1e-3
# Each of mamba2-2.7b's Mamba2 blocks in bf16 against the same block in
# float32, on the float32 forward's input at that layer (relative RMS).
SSM_F32_REL_TOL = 0.05
# Phase 16: zamba2-7b at full width, depth cut to 13 layers (two groups of
# 6 Mamba2 layers behind the shared block, one tail layer: the reduced
# config's shape), batches of 2 x 2,048 tokens, 4 AdamW steps.
HYBRID_TRAIN = dict(arch="zamba2-7b", layers=13, batch=2, seq=2048, steps=4, lr=3e-3, warmup=2)


def bwd_errs(got: tuple, want: tuple, one_key: bool = False) -> dict:
    """The relative RMS error of each of dq, dk, dv against ``want``'s.  With
    ``one_key`` (each query row sees one key: Sk = 1, or Sq = 1 causal) dq
    and dk are left out: they are zero but for rounding, and have no
    relative error."""
    return {f"d{n}": rel_rms(g, w) for n, g, w in zip("qkv", got, want)
            if not (one_key and n != "v")}


def bwd_close(got: tuple, want: tuple, what: str, one_key: bool = False) -> float:
    """Raises unless each of dq, dk, dv (``bwd_errs``) is within the bf16
    gradient gate, GRAD_REL_TOL's relative RMS error.  Returns the largest
    error."""
    gate = GRAD_REL_TOL[torch.bfloat16]
    errs = bwd_errs(got, want, one_key)
    if not all(e <= gate for e in errs.values()):
        raise AssertionError(f"flash backward != plain version at {what}: relative RMS "
                             f"{errs} (gate {gate})")
    return max(errs.values())


def plain_chunks(sq: int, sk: int) -> dict:
    """Chunk sizes for the plain flash versions at (Sq, Sk): the largest
    divisors of each length under ``ref.flash_chunks``' caps.  That rule
    halves 512 until it divides, which leaves musicgen's 1,500 positions at
    chunks of 5 and 4 (over 100,000 blocks a call, minutes on the card);
    these chunks compute the same function in a few dozen."""
    cap = min(512, max(sq // 16, 64), sq)
    return {"q_chunk": max(c for c in range(1, cap + 1) if sq % c == 0),
            "kv_chunk": max(c for c in range(1, min(512, sk) + 1) if sk % c == 0)}


def plain_flash(q, k, v, **kw):
    """``ref.flash_attention_ref`` in :func:`plain_chunks`' chunks."""
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q, k, v, **kw, **plain_chunks(q.shape[1], k.shape[1]))


def plain_flash_bwd(q, k, v, out, lse, do, **kw):
    """``ref.flash_attention_bwd_ref`` in :func:`plain_chunks`' chunks."""
    from repro_torch.kernels import ref

    return ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw,
                                       **plain_chunks(q.shape[1], k.shape[1]))


def time_flash_forward(q, k, v, causal: bool, what: str) -> dict:
    """The forward kernel at (q, k, v) against its plain version, timed in
    turns with scaled_dot_product_attention (kernel, SDPA, SDPA, kernel),
    beside the plain version and its bound."""
    from repro_torch.kernels import flash_attention as fa

    err = flash_close(fa.flash_attention_cuda(q, k, v, causal=causal),
                      plain_flash(q, k, v, causal=causal), what)
    turns = in_turns({"kernel": lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                      "sdpa": sdpa_call(q, k, v, causal)}, iters=20)
    plain = cuda_ms(lambda: plain_flash(q, k, v, causal=causal), 3)
    flops, nbytes, bound, term = flash_bound(q, k, causal)
    ms, lib = turns["kernel"], turns["sdpa"]
    log(f"flash_attention at {what}: within rtol = atol = {FLASH_TOL[q.dtype]} of the plain "
        f"version (max |err| {err:.3g}); device ms in turns: kernel {ms[0]:.4f} / {ms[1]:.4f} "
        f"({flops / ms[0] / 1e9:.1f} TFLOP/s, {bound[0] / ms[0]:.1%} of its bound "
        f"{bound[0]:.4f} ms by {bound[1]}, the {term} term: {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); scaled_dot_product_attention {lib[0]:.4f} / {lib[1]:.4f} "
        f"(backend {sdpa_backend(q, k, v, causal)}); plain {plain:.3f} ms")
    return {"shape": what, "ms": ms[0], "ms_turns": ms, "library_ms": lib[0],
            "library_ms_turns": lib, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_term": term, "gflop": flops / 1e9, "max_abs_err": err}


def time_flash_backward(args: tuple, causal: bool, what: str) -> dict:
    """The backward kernel at a train step's captured operands (q, k, v,
    out, lse, do) against its plain version and SDPA's backward (relative
    RMS, the bf16 gate), timed in turns with SDPA's backward alone (on a
    retained graph) and with the plain backward, beside its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, out, lse, do = (t.detach() for t in args)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_grads = [g.transpose(1, 2) for g in
                  torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True)]
    kernel = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)  # noqa: E731
    plain = lambda: plain_flash_bwd(q, k, v, out, lse, do, causal=causal)  # noqa: E731
    got, plain_g = kernel(), plain()
    errs = {"kernel vs plain": bwd_close(got, plain_g, what),
            "kernel vs SDPA": bwd_close(got, sdpa_grads, what + " (SDPA)"),
            "plain vs SDPA": bwd_close(plain_g, sdpa_grads, what + " (plain vs SDPA)")}
    b_err = max(max_err_float(g, w) for g, w in zip(got, plain_g))
    del got, plain_g, sdpa_grads
    plain_turns = in_turns({"kernel": kernel, "plain": plain}, iters=3)
    sdpa_turns = in_turns({"kernel": kernel, "sdpa_bwd": lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True)}, iters=20)
    flops, nbytes, bound, term = flash_bound(q, k, causal, backward=True)
    ms = sdpa_turns["kernel"][0]
    log(f"flash_attention_bwd at {what}: relative RMS of dq, dk, dv (max) "
        + ", ".join(f"{n} {e:.4g}" for n, e in errs.items())
        + f" (gate {GRAD_REL_TOL[torch.bfloat16]}); device ms in turns: kernel "
        f"{sdpa_turns['kernel'][0]:.4f} / {sdpa_turns['kernel'][1]:.4f}, SDPA's backward "
        f"{sdpa_turns['sdpa_bwd'][0]:.4f} / {sdpa_turns['sdpa_bwd'][1]:.4f}; kernel "
        f"{plain_turns['kernel'][0]:.4f} / {plain_turns['kernel'][1]:.4f}, plain "
        f"{plain_turns['plain'][0]:.3f} / {plain_turns['plain'][1]:.3f}; bound {bound[0]:.4f} ms "
        f"by {bound[1]}, the {term} term ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound[0] / ms:.1%} of the bound)")
    return {"shape": what, "ms": ms, "ms_turns_with_sdpa": sdpa_turns["kernel"],
            "ms_turns_with_plain": plain_turns["kernel"], "plain_ms": plain_turns["plain"][0],
            "plain_ms_turns": plain_turns["plain"], "library_ms": sdpa_turns["sdpa_bwd"][0],
            "library_ms_turns": sdpa_turns["sdpa_bwd"], "bound_ms": bound[0],
            "bound_by": bound[1], "bound_term": term, "gflop": flops / 1e9, "rel_rms": errs,
            "max_abs_err": b_err}


def phase_flash_d112(seed: int) -> list[dict]:
    """Phase 14: both flash kernels' D = 112 instances (bf16, wgmma on D =
    128's tiles) against their plain versions on the card: the forward with
    and without lse and the backward over D112_SWEEP; then at zamba2-7b's
    serving shape (the forward) and training shape (the forward and the
    backward), timed in turns with scaled_dot_product_attention (SDPA's
    backward alone, on a retained graph), beside the plain versions and
    bounds of the true D = 112 work.  Returns the two kernels' rows
    (``launches`` from phases 15 and 16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 90)
    d, h = D112["d"], D112["heads"]
    bf16 = torch.bfloat16
    fwd_err = lse_err = bwd_err = 0.0
    for sq, sk, causal, g, kv in D112_SWEEP:
        q, do = (torch.randn((2, sq, g * kv, d), generator=gen, device=dev).to(bf16)
                 for _ in range(2))
        k, v = (torch.randn((2, sk, kv, d), generator=gen, device=dev).to(bf16) for _ in range(2))
        what = f"D=112 Sq={sq} Sk={sk} causal={causal} H={g * kv} KV={kv}"
        want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        plain_out = fa.flash_attention_cuda(q, k, v, causal=causal)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        if not torch.equal(out, plain_out):
            raise AssertionError(f"the forward with lse differs from the one without at {what}")
        fwd_err = max(fwd_err, flash_close(out, want, what))
        lse_err = max(lse_err, lse_close(lse, want_lse, what))
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        bwd_err = max(bwd_err, bwd_close(
            got, ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal), what,
            one_key=sk == 1 or (causal and sq == 1)))
    torch.cuda.synchronize()
    log(f"flash D=112 (wgmma): {len(D112_SWEEP)} shapes (Sq, Sk in 1..385, the 128-row and "
        f"128-key tile edges, groups 1/3/4/8, causal and not): forward within rtol = atol = "
        f"{FLASH_TOL[bf16]} of the plain version (max |err| {fwd_err:.3g}), with lse bit-identical "
        f"to without, lse within {LSE_TOL} (1 + |lse|) (max |err| {lse_err:.3g}); backward dq, "
        f"dk, dv within {GRAD_REL_TOL[bf16]} relative RMS (largest {bwd_err:.4g}; where each row "
        f"sees one key dv alone, dq and dk being zero but for rounding)")

    at = {}
    for shape in ("serve", "train"):
        b, s = D112[shape]
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        what = f"B={b} S={s} H={h} KV={h} D={d} bf16 causal (zamba2-7b's {shape} shape)"
        at[shape] = time_flash_forward(q, k, v, True, what)
        if shape == "train":
            out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            at["bwd"] = time_flash_backward((q, k, v, out, lse, do), True, what)
            del out, lse
        del q, k, v, do
    gc.collect()
    torch.cuda.empty_cache()
    source, replaces = "src/repro_torch/kernels/csrc/flash_attention.cu", \
        "src/repro/kernels/flash_attention.py:93"
    b, s = D112["serve"]
    fwd = at["serve"]
    fwd_row = kernel_row("flash_attention_d112", source, replaces, err=max(fwd_err, fwd["max_abs_err"]),
                         ms=fwd["ms"], plain_ms=fwd["plain_ms"],
                         bound=(fwd["bound_ms"], fwd["bound_by"]), library_ms=fwd["library_ms"],
                         path=f"full size, zamba2-7b serving: prefill of {SSM_SERVE['batch']} x "
                              f"{SSM_SERVE['prompt']:,} tokens (the shared attention block, "
                              f"wgmma at D = 112); timed at B={b} S={s} H=32 D=112")
    fwd_row.update(bound_term=fwd["bound_term"], ms_turns=fwd["ms_turns"],
                   library_ms_turns=fwd["library_ms_turns"], at_train_shape=at["train"],
                   lse_max_err=lse_err)
    bwd = at["bwd"]
    bwd_row = kernel_row("flash_attention_bwd_d112",
                         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                         "repro/models/layers.py:137 _flash_bwd_impl (jnp, no TPU kernel)",
                         err=bwd["max_abs_err"], ms=bwd["ms"], plain_ms=bwd["plain_ms"],
                         bound=(bwd["bound_ms"], bwd["bound_by"]), library_ms=bwd["library_ms"],
                         path=f"full size, zamba2-7b training (depth cut to "
                              f"{HYBRID_TRAIN['layers']} layers): {HYBRID_TRAIN['steps']} AdamW "
                              f"steps of {HYBRID_TRAIN['batch']} x {HYBRID_TRAIN['seq']:,} tokens; "
                              f"timed at {bwd['shape']}")
    bwd_row.update({k: v for k, v in bwd.items() if k not in bwd_row})
    bwd_row["sweep_max_rel_rms"] = bwd_err
    return [fwd_row, bwd_row]


def serve_ssm(arch: str, seed: int) -> dict:
    """One family of phase 15 at its published config: seeded weights,
    ``greedy_generate`` of SSM_SERVE["gen"] tokens after SSM_SERVE["batch"]
    prompts of SSM_SERVE["prompt"] tokens in bf16 (the path: timed, the
    flash kernel once a shared-attention application, each its wgmma
    instance, no lse; the kernel then against its plain version at every
    application's captured operands), its logits finite; then in float32
    (TF32 off) the same
    generation checked teacher-forced against ``Model.forward``, with a
    negative control (the prefill's SSM states zeroed), the hybrid
    family's whole prefill through the kernel against the same through the
    plain versions, and for the ssm family each Mamba2 block in bf16
    against the same block in float32.  Frees the model before it returns
    its measurements."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.generate import greedy_generate
    from repro_torch.models.model import attention_applications

    cfg = configs.get(arch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    attn = attention_applications(cfg)
    log(f"full size, {cfg.family} serving: {cfg.name}, {cfg.num_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.ssm_inner} ({cfg.ssm_heads} heads of {cfg.ssm_head_dim}), "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}"
        + (f", a shared attention + MLP block ({cfg.num_heads} heads of {cfg.head_dim}, d_ff "
           f"{cfg.d_ff}) before each of {attn} groups of {cfg.attn_every}" if attn else "")
        + f", vocab {cfg.vocab_size}; {model.num_params():,} {cfg.param_dtype} parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card from seed {seed} in "
        f"{time.perf_counter() - t0:.2f} s (set-up); compute {cfg.dtype}")
    engine = DecodeEngine(model)
    b, p, n = SSM_SERVE["batch"], SSM_SERVE["prompt"], SSM_SERVE["gen"]
    rng = np.random.default_rng(seed + 91)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    # Teacher-forced forwards run over the prompt, the tokens decode was fed
    # and seeded filler up to a whole number of SSD chunks (the positions
    # compared see none of the filler: every path is causal).
    fed = p + n - 1
    total = -(-fed // cfg.ssm_chunk) * cfg.ssm_chunk
    filler = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, total - fed))
                              .astype(np.int32)).to(dev)

    def teacher_forced(out):
        """The relative RMS error of the prefill's and each decode step's
        logits against ``Model.forward`` over the same tokens, and the
        forward's logits."""
        full = torch.cat([prompt, out.tokens[:, :-1], filler], dim=1)
        want, _ = model({"tokens": full})
        return [rel_rms(lg, want[:, p - 1 + t]) for t, lg in enumerate(out.logits)], want

    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    out = greedy_generate(engine, prompt, n, max_len=p + n)
    launches = fa.flash_attention_cuda.instance_launches["wgmma"]
    peak = torch.cuda.max_memory_allocated()
    if (launches, fa.flash_attention_cuda.launches, fa.flash_attention_cuda.lse_launches) != (
            attn, attn, 0):
        raise AssertionError(f"{cfg.name}'s prefill launched flash_attention "
                             f"{fa.flash_attention_cuda.launches} times "
                             f"({fa.flash_attention_cuda.instance_launches}, "
                             f"{fa.flash_attention_cuda.lse_launches} with lse); expected {attn} "
                             f"wgmma launches without lse")
    res = {"prefill_s": out.prefill_s, "decode_ms_per_step": 1e3 * out.decode_s / (n - 1),
           "prefill_tokens_per_s": b * p / out.prefill_s,
           "decode_tokens_per_s": b * (n - 1) / out.decode_s, "peak_memory_gb": peak / 1e9,
           "flash_launches": launches, "params": model.num_params()}
    log(f"{cfg.name} serving: {b} requests x {p} prompt tokens, max_len {p + n}: prefill "
        f"{out.prefill_s:.3f} s ({res['prefill_tokens_per_s']:.1f} tokens/s); {n - 1} decode "
        f"steps {out.decode_s:.3f} s ({res['decode_ms_per_step']:.2f} ms a step, "
        f"{res['decode_tokens_per_s']:.1f} tokens/s); flash_attention launches {launches}; peak "
        f"memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); first request's tokens "
        f"{out.tokens[0, :8].tolist()}...")

    with torch.inference_mode():
        if not all(bool(torch.isfinite(lg).all()) for lg in out.logits):
            raise AssertionError(f"{cfg.name}: non-finite bf16 logits")
        if attn:
            # The kernel against its plain version at every shared-attention
            # application's operands, as the prefill handed them over.
            calls = []
            with capture_calls(fa, "flash_attention_cuda", calls):
                engine.prefill(model, {"tokens": prompt}, max_len=p + n, last_only=True)
            if len(calls) != attn:
                raise AssertionError(f"the prefill called the kernel {len(calls)} times")
            worst = 0.0
            for i, (qkv, kw) in enumerate(calls):
                worst = max(worst, flash_close(fa.flash_attention_cuda(*qkv, **kw),
                                               ref.flash_attention_ref(*qkv, **kw),
                                               f"{cfg.name} application {i}"))
            res["kernel_at_applications_max_abs_err"] = worst
            log(f"{cfg.name}: flash_attention (wgmma, D={cfg.head_dim}) at each of the prefill's "
                f"{attn} applications' q {list(calls[0][0][0].shape)}: within rtol = atol = "
                f"{FLASH_TOL[torch.bfloat16]} of the plain version, max |err| {worst:.4g}")
            del calls

        # float32 (TF32 off): the same weights and prompt, the model's
        # compute type switched.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model.cfg = cfg32
        try:
            t0 = time.perf_counter()
            out32 = greedy_generate(engine, prompt, n, max_len=p + n)
            gen32_s = time.perf_counter() - t0
            errs32, want32 = teacher_forced(out32)
            if not all(np.isfinite(errs32)) or max(errs32) > F32_TF_REL_TOL:
                raise AssertionError(f"{cfg.name}: float32 teacher-forced logits beyond "
                                     f"{F32_TF_REL_TOL}: {errs32}")
            # The negative control: the prefill's SSM states zeroed.
            _, cache = engine.prefill(model, {"tokens": prompt}, max_len=p + n, last_only=True)
            cache["ssm"].zero_()
            bad = []
            for t in range(n - 1):
                lg, cache = engine.decode_step(model, cache, {"tokens": out32.tokens[:, t:t + 1]})
                bad.append(rel_rms(lg[:, -1], want32[:, p + t]))
            if max(bad) <= F32_TF_REL_TOL:
                raise AssertionError(f"{cfg.name}: decoding without the SSM states passed the "
                                     f"float32 logits check: {bad}")
            del cache, want32
            agree = int((out32.tokens == out.tokens).sum())
            last = rel_rms(out.logits[0], out32.logits[0])
            res.update(f32_teacher_forced_rel_rms_max=max(errs32), f32_generate_s=gen32_s,
                       f32_negative_control_rel_rms_max=max(bad),
                       bf16_vs_f32_prefill_logits_rel_rms=last, bf16_f32_same_tokens=agree)
            log(f"{cfg.name} in float32 (TF32 off; generation {gen32_s:.2f} s): teacher-forced "
                f"logits against Model.forward, relative RMS max {max(errs32):.3g}, mean "
                f"{float(np.mean(errs32)):.3g} (gate {F32_TF_REL_TOL}); negative control, the "
                f"prefill's SSM states zeroed: max {max(bad):.4f} (first step {bad[0]:.4f}), "
                f"fails the gate as it must. bf16 against float32: the prefill's last logits "
                f"{last:.4f} relative RMS, greedy tokens equal at {agree} of {out.tokens.numel()}")

            if attn:
                # The whole prefill through the kernel (the 3xTF32 instance
                # at D = 112) against the same through the plain versions.
                got, got_cache = engine.prefill(model, {"tokens": prompt}, max_len=p + n)
                with flash_forward("plain"):
                    plain, plain_cache = engine.prefill(model, {"tokens": prompt},
                                                        max_len=p + n)
                leaves = {"logits": rel_rms(got, plain)}
                for name in ssm_lib.CACHE_LEAVES:
                    leaves[name] = rel_rms(got_cache[name], plain_cache[name])
                for name in ("k", "v"):
                    leaves[f"shared.{name}"] = rel_rms(got_cache["shared"][name][:, :, :p],
                                                       plain_cache["shared"][name][:, :, :p])
                worst = max(leaves, key=leaves.get)
                if not all(np.isfinite(list(leaves.values()))) or leaves[worst] > F32_TF_REL_TOL:
                    raise AssertionError(f"{cfg.name}: the float32 prefill through the kernel != "
                                         f"through the plain versions: {leaves} (gate "
                                         f"{F32_TF_REL_TOL})")
                res["f32_prefill_vs_plain_rel_rms"] = leaves
                log(f"{cfg.name} float32 prefill through the flash kernel (3xTF32, D="
                    f"{cfg.head_dim}) against the same through the plain version: relative RMS "
                    + ", ".join(f"{k} {v:.3g}" for k, v in leaves.items())
                    + f" (gate {F32_TF_REL_TOL})")
                del got, got_cache, plain, plain_cache
            else:
                # bf16 against float32 on the SSM path, block by block: each
                # Mamba2 block in bf16 and in float32 on the float32
                # forward's own input at that layer.
                x = model.embed_tokens(prompt)
                block_errs = []
                kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                          norm_eps=cfg.norm_eps)
                for blk in model.layers():
                    h = L.rms_norm(x, blk["norm"], cfg.norm_eps)
                    o32, _ = ssm_lib.mamba2_block(h, blk["mamba"], **kw)
                    o16, _ = ssm_lib.mamba2_block(h.to(torch.bfloat16), blk["mamba"], **kw)
                    block_errs.append(rel_rms(o16, o32))
                    x = x + o32
                del x, h, o32, o16
                if not all(np.isfinite(block_errs)) or max(block_errs) > SSM_F32_REL_TOL:
                    raise AssertionError(f"{cfg.name}: a Mamba2 block in bf16 against float32 "
                                         f"beyond {SSM_F32_REL_TOL}: {block_errs}")
                res.update(bf16_vs_f32_block_rel_rms_max=max(block_errs),
                           bf16_vs_f32_block_rel_rms_mean=float(np.mean(block_errs)))
                log(f"{cfg.name}: each of the {len(block_errs)} Mamba2 blocks in bf16 against the "
                    f"same block in float32 on the float32 forward's input (B={b}, S={p}): "
                    f"relative RMS max {max(block_errs):.4f} (layer "
                    f"{int(np.argmax(block_errs))}), mean {float(np.mean(block_errs)):.4f} (gate "
                    f"{SSM_F32_REL_TOL})")
        finally:
            model.cfg = cfg
    del model, engine, out, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_ssm_serving(seed: int) -> tuple[dict, dict]:
    """Phase 15: serve_ssm of each of SSM_SERVE["archs"].  Returns the
    measurements by arch and the path's launches of the D = 112 kernel
    (zamba2-7b's prefill)."""
    out = {arch: serve_ssm(arch, seed) for arch in SSM_SERVE["archs"]}
    return out, {"flash_attention_d112": out["zamba2-7b"]["flash_launches"]}


def phase_hybrid_train(seed: int) -> tuple[dict, dict]:
    """Phase 16: zamba2-7b at full width, depth cut to HYBRID_TRAIN["layers"]
    layers, on batches of 2 x 2,048 tokens.  (a) In bf16: the step calls
    the forward once a shared-attention application with lse (the shared
    block is not recomputed) and the backward as often, each call held to
    its plain version at the step's own operands, and the backward fed the
    forward's lse shifted by log 2 on one head failing that gate at every
    call.  (b) In float32
    (TF32 off): every gradient leaf through the kernels within F32_TF_REL_TOL
    relative RMS of the plain versions', the shifted-lse negative control
    failing that gate.  (c) HYBRID_TRAIN["steps"] AdamW steps in bf16: every
    loss finite, step ms, tokens/s, peak memory.  Returns the measurements
    and the path's launches of the backward kernel."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import Model
    from repro_torch.models.model import attention_applications
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get(HYBRID_TRAIN["arch"]), num_layers=HYBRID_TRAIN["layers"])
    dev = torch.device("cuda")
    b, s, steps = HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], HYBRID_TRAIN["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opt_cfg = OptimizerConfig(learning_rate=HYBRID_TRAIN["lr"], warmup_steps=HYBRID_TRAIN["warmup"],
                              decay_steps=steps)
    state = init_state(model, opt_cfg)
    loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                 vocab_size=cfg.vocab_size), device=dev)
    batch = next(loader)
    torch.cuda.synchronize()
    attn = attention_applications(cfg)
    log(f"full size, hybrid training: {cfg.name} at its published widths (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, d_inner {cfg.ssm_inner}, "
        f"state {cfg.ssm_state}, vocab {cfg.vocab_size}), depth cut from 81 to {cfg.num_layers} "
        f"layers ({attn} groups of {cfg.attn_every} behind the shared block and "
        f"{cfg.num_layers % cfg.attn_every} tail layer); {model.num_params():,} {cfg.param_dtype} "
        f"parameters and their AdamW state ({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s (set-up); compute {cfg.dtype}, remat {cfg.remat}; "
        f"batches {b} x {s}")
    out: dict = {"layers": cfg.num_layers, "params": model.num_params()}

    # (a) bf16, the path's compute type: each kernel call of the step held
    # to its plain version at the step's own operands, and the backward fed
    # the forward's lse shifted on one head (the negative control) failing
    # that gate at each call.
    fwd_calls, bwd_calls = [], []
    with capture_calls(fa, "flash_attention_cuda", fwd_calls), \
            capture_calls(fa, "flash_attention_bwd_cuda", bwd_calls):
        kernel = loss_and_grads(model, batch)
    if len(fwd_calls) != attn or len(bwd_calls) != attn or not all(
            kw.get("return_lse") for _, kw in fwd_calls):
        raise AssertionError(f"a hybrid train step called flash_attention {len(fwd_calls)} "
                             f"times and its backward {len(bwd_calls)}; expected {attn} each, "
                             f"the forward with lse (the shared block is not recomputed)")
    del kernel
    gate = GRAD_REL_TOL[torch.bfloat16]
    with torch.no_grad():
        fwd_err = max(flash_close(fa.flash_attention_cuda(*a, **kw)[0],
                                  ref.flash_attention_ref(*a, **kw)[0], f"step forward call {i}")
                      for i, (a, kw) in enumerate(fwd_calls))
        bwd_err, bad_err = [], []
        for i, (a, kw) in enumerate(bwd_calls):
            plain = ref.flash_attention_bwd_ref(*a, **kw)
            bwd_err.append(bwd_close(fa.flash_attention_bwd_cuda(*a, **kw), plain,
                                     f"step backward call {i}"))
            q, k, v, o, lse, do = a
            bad = bwd_errs(fa.flash_attention_bwd_cuda(q, k, v, o, shift_lse(lse), do, **kw),
                           plain)
            if max(bad.values()) <= gate:
                raise AssertionError(f"the lse shifted by log 2 on one head passed the backward "
                                     f"gate at step backward call {i}: relative RMS {bad}")
            bad_err.append(bad)
            del plain
    rms = [float(a[5].float().pow(2).mean().sqrt()) for a, _ in bwd_calls]
    del fwd_calls, bwd_calls
    gc.collect()
    out.update(step_fwd_calls_max_abs_err=fwd_err, step_bwd_calls_rel_rms=bwd_err,
               step_bwd_calls_negative_control_rel_rms=bad_err)
    log(f"hybrid training in bf16: each of the step's {attn} forward and {attn} backward kernel "
        f"calls against the plain version at its own operands (dO RMS "
        f"{', '.join(f'{r:.3g}' for r in rms)}): forward max |err| {fwd_err:.4g} (rtol = atol = "
        f"{FLASH_TOL[torch.bfloat16]}), backward largest relative RMS of dq, dk, dv "
        f"{', '.join(f'{e:.4g}' for e in bwd_err)} (gate {gate}). Negative control, the "
        f"backward fed the forward's lse + log 2 on one head: "
        + "; ".join(", ".join(f"{n} {e:.4f}" for n, e in bad.items()) for bad in bad_err)
        + ", fails the gate at every call as it must")

    # (b) float32 (TF32 off; the forward's 3xTF32 and the backward's
    # CUDA-core instances at D = 112): the whole step's gradients through
    # the kernels against the plain versions', and the shifted-lse control.
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    try:
        fa.reset_launches()
        kernel = loss_and_grads(model, batch)
        counts = (dict(fa.flash_attention_cuda.instance_launches),
                  dict(fa.flash_attention_bwd_cuda.instance_launches))
        if counts[0]["wgmma_tf32x3"] != attn or counts[1]["simt_f32"] != attn:
            raise AssertionError(f"the float32 step launched {counts}; expected {attn} of the "
                                 f"3xTF32 forward and of the CUDA-core backward")
        with flash_forward("plain"):
            plain = loss_and_grads(model, batch)
        loss_err, worst, leaf, _ = grad_gate(kernel, plain, torch.float32)
        if not (loss_err <= TRAIN_LOSS_REL_TOL and worst <= F32_TF_REL_TOL):
            raise AssertionError(f"hybrid float32 train step through the D=112 kernels != plain "
                                 f"versions': loss relative error {loss_err:.3g}, {leaf} gradient "
                                 f"relative RMS {worst:.4g} (gate {F32_TF_REL_TOL})")
        del kernel
        with flash_forward("shifted"):
            bad = loss_and_grads(model, batch)
        _, bad_worst, bad_leaf, _ = grad_gate(bad, plain, torch.float32)
        if bad_worst <= F32_TF_REL_TOL:
            raise AssertionError(f"the lse shifted by log 2 on one head passed the hybrid "
                                 f"float32 gradient gate: {bad_leaf} relative RMS {bad_worst:.4g}")
        del plain, bad
    finally:
        model.cfg = cfg
    gc.collect()
    out.update(f32_loss_rel_err=loss_err, grad_rel_rms_max=worst, grad_rel_rms_leaf=leaf,
               negative_control_rel_rms_max=bad_worst, negative_control_leaf=bad_leaf,
               launches_per_step=attn, bwd_launches_per_step=attn)
    log(f"hybrid training in float32 (TF32 off): the step through the D=112 kernels (3xTF32 "
        f"forward, CUDA-core backward) against the plain versions, loss relative error "
        f"{loss_err:.3g} (gate {TRAIN_LOSS_REL_TOL}); largest gradient relative RMS {worst:.3g} "
        f"({leaf}; gate {F32_TF_REL_TOL}). Negative control, lse + log 2 on one head: "
        f"{bad_worst:.4f} ({bad_leaf}), fails the gate as it must")

    step = make_train_step(model, opt_cfg)
    events, losses = [], []
    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, metrics = step(state, next(loader))
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fa.flash_attention_cuda.instance_launches["wgmma"],
                fa.flash_attention_cuda.lse_launches,
                fa.flash_attention_bwd_cuda.instance_launches["wgmma"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_ms = [e[0].elapsed_time(e[1]) for e in events]
    if launches != (steps * attn,) * 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"hybrid training: losses {losses}, flash launches (wgmma, with lse, "
                             f"backward) {launches}; expected {steps * attn} each")
    med = statistics.median(step_ms[1:])
    out.update(losses=losses, step_ms=med, step_ms_all=step_ms, tokens_per_s=b * s / med * 1e3,
               peak_memory_gb=peak / 1e9, run_s=wall, launches=launches[0],
               bwd_launches=launches[2])
    log(f"hybrid training: {steps} AdamW steps (lr {HYBRID_TRAIN['lr']}, {HYBRID_TRAIN['warmup']} "
        f"warmup) in {wall:.2f} s; loss {' -> '.join(f'{x:.4f}' for x in losses)}; step "
        f"{med:.2f} ms (CUDA events, median of steps 2-{steps}; all {[round(x, 2) for x in step_ms]})"
        f", {b * s / med * 1e3:,.0f} tokens/s; peak memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated); flash_attention launches {launches[0]} "
        f"({launches[1]} with lse), flash_attention_bwd {launches[2]}")
    del model, state, loader, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, {"flash_attention_bwd_d112": launches[2]}


# Phases 17-19: the moe, vlm and audio families at their published widths,
# each model freed before the next.  arch: the layers kept (None: the
# published depth).  One H100's 80 GB forces the cuts: phi3.5-moe's 32
# layers hold 41.9e9 float32 parameters (167.5 GB), so 8 are kept (10.67e9,
# 42.7 GB); arctic's 35 about 480e9, so 1 is kept (14.07e9, 56.3 GB).
FAMILY_SERVE = {"phi3.5-moe-42b-a6.6b": 8, "arctic-480b": 1,
                "llama-3.2-vision-11b": None, "musicgen-medium": None}
# 4 requests of 1,024 prompt tokens (musicgen: 1,500 frames, 30 s at
# EnCodec's 50 Hz; the vision model: with 1,600 image embeddings each), 16
# greedy tokens (musicgen: codes, one seeded frame fed a step).
FAMILY_SHAPE = dict(batch=4, prompt=1024, frames=1500, gen=16)
# Phase 19: (arch, layers kept, batch, sequence): musicgen not cut; the
# vision model cut to one group (4 self layers and its cross layer, 2.14e9
# parameters); phi3.5-moe to 2 layers (2.86e9).  Their float32 parameters,
# AdamW moments and gradients take 16 bytes a parameter; arctic's one layer
# would take 225 GB, so it trains on the CPU only (tests/test_torch_moe.py).
FAMILY_TRAIN = (("musicgen-medium", None, 4, 1500), ("llama-3.2-vision-11b", 5, 2, 2048),
                ("phi3.5-moe-42b-a6.6b", 2, 2, 2048))
FAMILY_TRAIN_OPT = dict(steps=4, lr=3e-3, warmup=2)


def family_config(arch: str, layers, dtype: str | None = None):
    """``arch``'s published config, its depth cut to ``layers`` (None: not
    cut), in compute type ``dtype`` (None: the config's)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def vision_gates(gate: torch.Tensor, seed: int) -> torch.Tensor:
    """The vision model's cross-attention gates as phases 17-19 and 23 set
    them: they start at zero, which switches its cross-attention off (tanh(0)
    = 0), so seeded values of either sign with magnitudes in [0.5, 1.5)."""
    dev = gate.device
    gen = torch.Generator(device=dev).manual_seed(seed + 101)
    signs = torch.tensor([1.0, -1.0], device=dev).repeat(gate.numel())[:gate.numel()]
    return ((torch.rand(gate.shape, generator=gen, device=dev) + 0.5) * signs).to(gate.dtype)


def family_model(arch: str, layers, seed: int, dtype: str | None = None):
    """``family_config(arch, layers, dtype)`` and its model on the card with
    float32 weights drawn from ``seed`` (the vision model's gates
    :func:`vision_gates`)."""
    from repro_torch.models import Model

    cfg = family_config(arch, layers, dtype)
    dev = torch.device("cuda")
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    if cfg.family == "vlm":
        with torch.no_grad():
            model.cross_blocks.gate.copy_(vision_gates(model.cross_blocks.gate, seed))
    return cfg, model


def family_what(cfg, full_layers: int) -> str:
    """A config's shape in a few words, for the log."""
    what = (f"{cfg.name}, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    if cfg.family == "moe":
        what += (f", {cfg.num_experts} experts top-{cfg.experts_per_token} of d_ff "
                 f"{cfg.moe_d_ff}" + (" beside a dense MLP" if cfg.dense_residual else "")
                 + f", capacity factor {cfg.capacity_factor}")
    if cfg.family == "vlm":
        what += (f", a gated cross-attention layer over {cfg.num_image_tokens} image "
                 f"embeddings after every {cfg.cross_attn_every} self layers")
    if cfg.frame_inputs:
        what += ", frame-embedding inputs"
    cut = "" if cfg.num_layers == full_layers else f" (cut from {full_layers})"
    return what + f"; {cfg.num_layers} layers{cut}"


def serve_family(arch: str, layers, seed: int) -> dict:
    """One model of phases 17-18: ``greedy_generate`` of FAMILY_SHAPE["gen"]
    tokens after FAMILY_SHAPE["batch"] prompts in bf16 (the path: timed, the
    flash kernel once an attention application, each its wgmma instance
    without lse; then the kernel against its plain version at every
    application's captured operands, and timed at the family's new shape:
    arctic's group of 7, the vision model's non-causal cross-attention over
    1,600 keys, musicgen's 24 MHA heads of 64); the moe family's
    ``moe_dropped`` at its published capacity factor.  Then in float32 (TF32
    off; the moe family at capacity_factor = E / k, so no choice is
    dropped) the same generation teacher-forced against ``Model.forward``
    within F32_TF_REL_TOL, and the negative controls: the cache read one
    position off, and for the vision model zeroed image embeddings, each
    failing that gate.  Frees the model before it returns its
    measurements."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import DecodeEngine
    from repro_torch.models.generate import greedy_generate
    from repro_torch.models.model import attention_applications
    from repro_torch.models.moe import moe_block

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = t0 = time.perf_counter()
    cfg, model = family_model(arch, layers, seed)
    torch.cuda.synchronize()
    attn = attention_applications(cfg)
    log(f"full size, {cfg.family} serving: {family_what(cfg, configs.get(arch).num_layers)}; "
        f"{model.num_params():,} {cfg.param_dtype} parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card from seed {seed} in "
        f"{time.perf_counter() - t0:.2f} s (set-up); compute {cfg.dtype}")
    engine = DecodeEngine(model)
    b, n = FAMILY_SHAPE["batch"], FAMILY_SHAPE["gen"]
    p = FAMILY_SHAPE["frames"] if cfg.frame_inputs else FAMILY_SHAPE["prompt"]
    gen = torch.Generator(device=dev).manual_seed(seed + 102)
    rng = np.random.default_rng(seed + 103)
    prompt, extra = None, {}
    if cfg.frame_inputs:
        extra["frame_embeds"] = torch.randn((b, p + n - 1, cfg.d_model), generator=gen, device=dev)
    else:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.randn((b, cfg.num_image_tokens, cfg.d_model),
                                            generator=gen, device=dev)

    def prefill_batch(images=None) -> dict:
        batch = ({"frame_embeds": extra["frame_embeds"][:, :p]} if cfg.frame_inputs
                 else {"tokens": prompt})
        if cfg.family == "vlm":
            batch["image_embeds"] = extra["image_embeds"] if images is None else images
        return batch

    def step_batch(out, t: int) -> dict:
        return ({"frame_embeds": extra["frame_embeds"][:, p + t:p + t + 1]} if cfg.frame_inputs
                else {"tokens": out.tokens[:, t:t + 1]})

    def forward_batch(out) -> dict:
        """What decode was fed, teacher-forced; the moe family's tokens
        padded with seeded filler to whole routing groups (the compared
        positions see none of it: attention is causal and, with nothing
        dropped, a token's experts read that token alone)."""
        if cfg.frame_inputs:
            return {"frame_embeds": extra["frame_embeds"]}
        tokens = torch.cat([prompt, out.tokens[:, :-1]], dim=1)
        if cfg.family == "moe":
            group = moe_block.__kwdefaults__["group_size"]
            pad = -tokens.shape[1] % group
            tokens = torch.cat([tokens, torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, pad)).astype(np.int32)).to(dev)], dim=1)
        batch = {"tokens": tokens}
        if cfg.family == "vlm":
            batch["image_embeds"] = extra["image_embeds"]
        return batch

    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    out = greedy_generate(engine, prompt, n, max_len=p + n, **extra)
    launches = fa.flash_attention_cuda.instance_launches["wgmma"]
    peak = torch.cuda.max_memory_allocated()
    if (launches, fa.flash_attention_cuda.launches, fa.flash_attention_cuda.lse_launches) != (
            attn, attn, 0):
        raise AssertionError(f"{cfg.name}'s prefill launched flash_attention "
                             f"{fa.flash_attention_cuda.launches} times "
                             f"({fa.flash_attention_cuda.instance_launches}, "
                             f"{fa.flash_attention_cuda.lse_launches} with lse); expected {attn} "
                             f"wgmma launches without lse")
    res = {"layers": cfg.num_layers, "params": model.num_params(), "prefill_s": out.prefill_s,
           "decode_ms_per_step": 1e3 * out.decode_s / (n - 1),
           "prefill_tokens_per_s": b * p / out.prefill_s,
           "decode_tokens_per_s": b * (n - 1) / out.decode_s, "peak_memory_gb": peak / 1e9,
           "flash_launches": launches}
    log(f"{cfg.name} serving: {b} requests x {p} prompt "
        f"{'frames' if cfg.frame_inputs else 'tokens'}, max_len {p + n}: prefill "
        f"{out.prefill_s:.3f} s ({res['prefill_tokens_per_s']:.1f} tokens/s); {n - 1} decode "
        f"steps {out.decode_s:.3f} s ({res['decode_ms_per_step']:.2f} ms a step, "
        f"{res['decode_tokens_per_s']:.1f} tokens/s); flash_attention launches {launches}; peak "
        f"memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); first request's "
        f"{'codes' if cfg.frame_inputs else 'tokens'} {out.tokens[0, :8].tolist()}...")

    with torch.inference_mode():
        if not all(bool(torch.isfinite(lg).all()) for lg in out.logits):
            raise AssertionError(f"{cfg.name}: non-finite bf16 logits")
        if cfg.family == "moe":
            _, aux = model(prefill_batch())
            res.update({f"published_cf_{k}": float(v) for k, v in aux.items()})
            log(f"{cfg.name} in bf16 at the published capacity factor {cfg.capacity_factor} "
                f"(groups of {p} tokens): moe_dropped {float(aux['moe_dropped']):.5f}, "
                f"moe_aux_loss {float(aux['moe_aux_loss']):.4f}, moe_z_loss "
                f"{float(aux['moe_z_loss']):.4f} (the layers' mean)")
        # The kernel against its plain version at every application's
        # operands, as the prefill handed them over; timed at the new shape.
        calls = []
        with capture_calls(fa, "flash_attention_cuda", calls):
            engine.prefill(model, prefill_batch(), max_len=p + n, last_only=True)
        if len(calls) != attn:
            raise AssertionError(f"the prefill called the kernel {len(calls)} times")
        worst = max(flash_close(fa.flash_attention_cuda(*a, **kw), plain_flash(*a, **kw),
                                f"{cfg.name} application {i}") for i, (a, kw) in enumerate(calls))
        res["kernel_at_applications_max_abs_err"] = worst
        log(f"{cfg.name}: flash_attention (wgmma) at each of the prefill's {attn} applications: "
            f"within rtol = atol = {FLASH_TOL[torch.bfloat16]} of the plain version, max |err| "
            f"{worst:.4g}")
        if arch != "phi3.5-moe-42b-a6.6b":   # phi3.5-moe's layer is qwen3-8b's shape
            i = next(i for i, (_, kw) in enumerate(calls) if kw.get("causal", True)
                     == (cfg.family != "vlm"))
            (q, k, v), kw = calls[i]
            causal = kw.get("causal", True)
            res["kernel_timing"] = time_flash_forward(
                q, k, v, causal, f"{cfg.name}'s application {i}: B={q.shape[0]} Sq={q.shape[1]} "
                f"Sk={k.shape[1]} H={q.shape[2]} KV={k.shape[2]} D={q.shape[3]} bf16 "
                f"{'causal' if causal else 'non-causal'}")
        del calls
        t_f32 = time.perf_counter()

        # float32 (TF32 off): the same weights and inputs, the model's
        # compute type switched (the moe family's capacity raised to the group).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        if cfg.family == "moe":
            cfg32 = dataclasses.replace(cfg32, capacity_factor=cfg.num_experts
                                        / cfg.experts_per_token)
        model.cfg = cfg32
        try:
            t0 = time.perf_counter()
            out32 = greedy_generate(engine, prompt, n, max_len=p + n, **extra)
            gen32_s = time.perf_counter() - t0
            want, aux = model(forward_batch(out32))
            errs = [rel_rms(lg, want[:, p - 1 + t]) for t, lg in enumerate(out32.logits)]
            if not all(np.isfinite(errs)) or max(errs) > F32_TF_REL_TOL:
                raise AssertionError(f"{cfg.name}: float32 teacher-forced logits beyond "
                                     f"{F32_TF_REL_TOL}: {errs}")
            if cfg.family == "moe" and float(aux["moe_dropped"]):
                raise AssertionError(f"{cfg.name}: the float32 forward at capacity_factor "
                                     f"{cfg32.capacity_factor} dropped {float(aux['moe_dropped'])}")
            # The negative controls: the cache read one position off; the
            # vision model's image embeddings zeroed.
            _, cache = engine.prefill(model, prefill_batch(), max_len=p + n, last_only=True)
            cache["cur"] -= 1
            bad = []
            for t in range(n - 1):
                lg, cache = engine.decode_step(model, cache, step_batch(out32, t))
                bad.append(rel_rms(lg[:, -1], want[:, p + t]))
            del cache
            if max(bad) <= F32_TF_REL_TOL:
                raise AssertionError(f"{cfg.name}: the off-by-one cache passed the float32 "
                                     f"logits check: {bad}")
            res.update(f32_teacher_forced_rel_rms_max=max(errs), f32_generate_s=gen32_s,
                       f32_off_by_one_rel_rms_max=max(bad),
                       bf16_vs_f32_prefill_logits_rel_rms=rel_rms(out.logits[0], out32.logits[0]),
                       bf16_f32_same_tokens=int((out32.tokens == out.tokens).sum()))
            dark = ""
            if cfg.family == "vlm":
                lg, _ = engine.prefill(model, prefill_batch(torch.zeros_like(extra["image_embeds"])),
                                       max_len=p + n, last_only=True)
                res["f32_zeroed_images_rel_rms"] = rel_rms(lg[:, -1], want[:, p - 1])
                if res["f32_zeroed_images_rel_rms"] <= F32_TF_REL_TOL:
                    raise AssertionError(f"{cfg.name}: zeroed image embeddings passed the "
                                         f"float32 logits check")
                dark = (f"; zeroed image embeddings move the prefill's logits by "
                        f"{res['f32_zeroed_images_rel_rms']:.4f}")
            log(f"{cfg.name} in float32 (TF32 off{', capacity factor %g' % cfg32.capacity_factor if cfg.family == 'moe' else ''}; generation "
                f"{gen32_s:.2f} s): teacher-forced logits against Model.forward over "
                f"{want.shape[1]} positions, relative RMS max {max(errs):.3g}, mean "
                f"{float(np.mean(errs)):.3g} (gate {F32_TF_REL_TOL})"
                + (f", moe_dropped {float(aux['moe_dropped'])}" if cfg.family == "moe" else "")
                + f"; negative control, the cache read one position off: max {max(bad):.4f}"
                + dark + ", failing the gate as they must. bf16 against float32: the prefill's "
                f"last logits {res['bf16_vs_f32_prefill_logits_rel_rms']:.4f} relative RMS, "
                f"greedy picks equal at {res['bf16_f32_same_tokens']} of {out.tokens.numel()}")
            del want, out32
        finally:
            model.cfg = cfg
    del model, engine, out, prompt, extra
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = {"bf16_and_kernel_checks": t_f32 - t_start,
                     "float32_checks": time.perf_counter() - t_f32}
    log(f"{arch} (phase wall): bf16 serving and the kernel checks {res['wall_s']['bf16_and_kernel_checks']:.1f} s, "
        f"the float32 checks {res['wall_s']['float32_checks']:.1f} s")
    return res


def phase_family_serving(seed: int, archs) -> tuple[dict, dict]:
    """Phases 17 (phi3.5-moe, arctic) and 18 (llama-3.2-vision, musicgen):
    serve_family of each of ``archs``.  Returns the measurements by arch and
    each prefill's flash launches, by path."""
    out = {arch: serve_family(arch, FAMILY_SERVE[arch], seed) for arch in archs}
    return out, {f"{arch} prefill ({FAMILY_SHAPE['batch']} requests)": res["flash_launches"]
                 for arch, res in out.items()}


def train_family(arch: str, layers, b: int, s: int, seed: int) -> dict:
    """One model of phase 19.  (a) One bf16 step's loss and gradients with
    every kernel call captured: the forward (with lse) once a layer and again
    in each remat layer's recomputation (the vision model's cross layers are
    not recomputed), the backward once a layer; each call held to its plain
    version at its own operands, and the backward fed the forward's lse
    shifted by log 2 on one head failing that gate (first call, and the
    first non-causal one); the backward timed at the new shapes (the vision
    model's cross layer, musicgen's layer).  (b) FAMILY_TRAIN_OPT["steps"]
    AdamW steps: every loss finite, the launches counted, step ms, tokens/s,
    peak memory.  Frees the model before it returns its measurements."""
    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import num_cross_layers
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    dev = torch.device("cuda")
    steps = FAMILY_TRAIN_OPT["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = t0 = time.perf_counter()
    cfg, model = family_model(arch, layers, seed)
    opt_cfg = OptimizerConfig(learning_rate=FAMILY_TRAIN_OPT["lr"],
                              warmup_steps=FAMILY_TRAIN_OPT["warmup"], decay_steps=steps)
    state = init_state(model, opt_cfg)
    loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                 vocab_size=cfg.vocab_size), device=dev)
    batch = next(loader)
    torch.cuda.synchronize()
    n_cross = num_cross_layers(cfg)
    fwd_per_step = (2 if cfg.remat else 1) * (cfg.num_layers - n_cross) + n_cross
    bwd_per_step = cfg.num_layers
    log(f"full size, {cfg.family} training: {family_what(cfg, configs.get(arch).num_layers)}; "
        f"{model.num_params():,} {cfg.param_dtype} parameters and their AdamW state "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in {time.perf_counter() - t0:.2f} s "
        f"(set-up); compute {cfg.dtype}, remat {cfg.remat}; batches {b} x {s}")
    res: dict = {"layers": cfg.num_layers, "params": model.num_params(), "batch": [b, s]}

    fwd_calls, bwd_calls = [], []
    with capture_calls(fa, "flash_attention_cuda", fwd_calls), \
            capture_calls(fa, "flash_attention_bwd_cuda", bwd_calls):
        loss_and_grads(model, batch)
    if (len(fwd_calls), len(bwd_calls)) != (fwd_per_step, bwd_per_step) or not all(
            kw.get("return_lse") for _, kw in fwd_calls):
        raise AssertionError(f"{cfg.name}: a train step called flash_attention "
                             f"{len(fwd_calls)} times and its backward {len(bwd_calls)}; "
                             f"expected {fwd_per_step} (with lse) and {bwd_per_step}")
    gate = GRAD_REL_TOL[torch.bfloat16]
    with torch.no_grad():
        fwd_err = max(flash_close(fa.flash_attention_cuda(*a, **kw)[0],
                                  plain_flash(*a, **kw)[0], f"step forward call {i}")
                      for i, (a, kw) in enumerate(fwd_calls))
        bwd_err = max(bwd_close(fa.flash_attention_bwd_cuda(*a, **kw), plain_flash_bwd(*a, **kw),
                                f"step backward call {i}")
                      for i, (a, kw) in enumerate(bwd_calls))
        controls = {}
        for i, (a, kw) in enumerate(bwd_calls):
            if i and (kw.get("causal", True) or any(not k.get("causal", True)
                                                    for _, k in bwd_calls[:i])):
                continue
            q, k, v, o, lse, do = a
            bad = bwd_errs(fa.flash_attention_bwd_cuda(q, k, v, o, shift_lse(lse), do, **kw),
                           plain_flash_bwd(*a, **kw))
            if max(bad.values()) <= gate:
                raise AssertionError(f"the lse shifted by log 2 on one head passed the backward "
                                     f"gate at step backward call {i}: {bad}")
            controls[i] = bad
    res.update(step_fwd_calls_max_abs_err=fwd_err, step_bwd_calls_rel_rms_max=bwd_err,
               step_bwd_negative_control_rel_rms=controls)
    log(f"{cfg.name} training in bf16: each of the step's {len(fwd_calls)} forward and "
        f"{len(bwd_calls)} backward kernel calls against the plain version at its own "
        f"operands: forward max |err| {fwd_err:.4g} (rtol = atol = "
        f"{FLASH_TOL[torch.bfloat16]}), backward largest relative RMS of dq, dk, dv "
        f"{bwd_err:.4g} (gate {gate}). Negative control, the backward fed the forward's lse + "
        f"log 2 on one head: "
        + "; ".join(f"call {i}: " + ", ".join(f"{n} {e:.4f}" for n, e in bad.items())
                    for i, bad in controls.items()) + ", failing the gate as it must")
    if cfg.family != "moe":   # phi3.5-moe's attention is the smollm / qwen3 shape
        i = next(i for i, (_, kw) in enumerate(bwd_calls) if kw.get("causal", True)
                 == (cfg.family != "vlm"))
        a, kw = bwd_calls[i]
        causal = kw.get("causal", True)
        q, k = a[0], a[1]
        res["bwd_timing"] = time_flash_backward(
            a, causal, f"{cfg.name}'s backward call {i}: B={q.shape[0]} Sq={q.shape[1]} "
            f"Sk={k.shape[1]} H={q.shape[2]} KV={k.shape[2]} D={q.shape[3]} bf16 "
            f"{'causal' if causal else 'non-causal'}")
    del fwd_calls, bwd_calls
    gc.collect()

    step = make_train_step(model, opt_cfg)
    events, losses, metrics = [], [], {}
    # The path: the counters zeroed just before, read just after.
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, metrics = step(state, next(loader))
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fa.flash_attention_cuda.instance_launches["wgmma"],
                fa.flash_attention_cuda.lse_launches,
                fa.flash_attention_bwd_cuda.instance_launches["wgmma"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_ms = [e[0].elapsed_time(e[1]) for e in events]
    want = (steps * fwd_per_step, steps * fwd_per_step, steps * bwd_per_step)
    if launches != want or not all(np.isfinite(losses)):
        raise AssertionError(f"{cfg.name} training: losses {losses}, flash launches (wgmma, with "
                             f"lse, backward) {launches}; expected {want}")
    med = statistics.median(step_ms[1:])
    aux = {k: float(metrics[k]) for k in ("moe_aux_loss", "moe_z_loss", "moe_dropped")
           if k in metrics}
    res.update(losses=losses, step_ms=med, step_ms_all=step_ms, tokens_per_s=b * s / med * 1e3,
               peak_memory_gb=peak / 1e9, run_s=wall, launches=launches[0],
               bwd_launches=launches[2], last_step_aux=aux)
    log(f"{cfg.name} training: {steps} AdamW steps (lr {FAMILY_TRAIN_OPT['lr']}, "
        f"{FAMILY_TRAIN_OPT['warmup']} warmup) in {wall:.2f} s; loss "
        f"{' -> '.join(f'{x:.4f}' for x in losses)}"
        + (f" (last step's {', '.join(f'{k} {v:.4f}' for k, v in aux.items())})" if aux else "")
        + f"; step {med:.2f} ms (CUDA events, median of steps 2-{steps}; all "
        f"{[round(x, 2) for x in step_ms]}), {b * s / med * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); flash_attention launches "
        f"{launches[0]} ({launches[1]} with lse), flash_attention_bwd {launches[2]}")
    del model, state, loader, batch, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_start
    log(f"{arch} training (phase wall): {res['wall_s']:.1f} s")
    return res


def phase_family_train(seed: int) -> tuple[dict, dict, dict]:
    """Phase 19: train_family of each of FAMILY_TRAIN.  Returns the
    measurements by arch and the forward's and the backward's launches by
    path."""
    out = {arch: train_family(arch, layers, b, s, seed) for arch, layers, b, s in FAMILY_TRAIN}
    steps = FAMILY_TRAIN_OPT["steps"]
    path = {arch: f"{arch} training ({steps} steps)" for arch in out}
    return (out, {path[a]: r["launches"] for a, r in out.items()},
            {path[a]: r["bwd_launches"] for a, r in out.items()})

def mesh_child(run_dir: Path, backend: str, rank: int, world: int) -> None:
    """One rank of phase 20 (``chip_smoke.py --mesh-child DIR BACKEND RANK
    WORLD``): joins the group over a file store in ``run_dir``, drives the
    ring (the ZIPF self-join) and sharded-indexed (the SKEWED self-join and
    probes) through ``JoinEngine`` on a mesh of the group, cold and warm,
    with the launch counters zeroed just before each path and read just
    after, and writes its walls, launches and results' digests to
    ``<backend><world>_rank<rank>.json``; rank 0 also writes the pairs."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.core import join
    from repro_torch.core.collection import Collection
    from repro_torch.core.engine import JoinEngine
    from repro_torch.core.plan import JoinPlan
    from repro_torch.kernels import bitmap_filter, compaction, postings
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store_{backend}{world}",
                            rank=rank, world_size=world)
    mesh = make_mesh((world,), ("data",))
    data = np.load(run_dir / "data.npz")
    cols = {name: Collection(tokens=data[name + "_tokens"], lengths=data[name + "_lengths"])
            for name in ["zipf", "skewed"] + [f"probe{k}" for k in range(int(data["probes"]))]}
    plan = json.loads((run_dir / "plan.json").read_text())
    si_plan = JoinPlan(**{**plan, "driver": "sharded-indexed",
                          "reasons": tuple(plan["reasons"])})
    ring_plan = JoinPlan(driver="ring", sim=MAIN["sim"], tau=MESH["tau"], b=MAIN["b"])
    counts = LaunchCounts(candidate_matrix_mxu=bitmap_filter.candidate_matrix_mxu_cuda,
                          candidate_matrix=bitmap_filter.candidate_matrix_cuda,
                          count_candidates_mxu=compaction.count_candidates_mxu_cuda,
                          count_candidates=compaction.count_candidates_cuda,
                          expand_filter=postings.expand_filter_cuda,
                          verdict_verify=postings.verdict_verify_cuda,
                          entry_filter=postings.entry_filter_cuda,
                          pair_verdict_tiled=postings.pair_verdict_tiled_cuda,
                          pair_verdict=postings.pair_verdict_cuda,
                          pair_verdict_bitplane=postings.pair_verdict_bitplane_cuda)
    digest = lambda p: hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()[:16]  # noqa: E731

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, arrays = {"rank": rank, "backend": backend, "world": world}, {}
    ring = JoinEngine(cols["zipf"], MAIN["sim"], MESH["tau"], plan=ring_plan, mesh=mesh,
                      axis="data", device="cuda")
    counts.zero()
    (pairs, stats), cold = timed(lambda: ring.self_join(return_stats=True))
    (warm_pairs, warm_stats), warm = timed(lambda: ring.self_join(return_stats=True))
    launches = counts.read()
    (drv_pairs, counters, overflow), drv = timed(lambda: join.ring_join_prepared(
        ring.prepared, mesh=mesh, axis="data", sim=MAIN["sim"], tau=MESH["tau"],
        b=MAIN["b"], return_stats=True))
    if not (np.array_equal(pairs, warm_pairs) and np.array_equal(pairs, drv_pairs)
            and stats.to_dict() == warm_stats.to_dict()):
        raise AssertionError(f"rank {rank}: the ring's cold, warm and driver runs differ")
    if int(counters[:, 1].sum()) != len(pairs) or ring.fallbacks:
        raise AssertionError(f"rank {rank}: ring counters {counters.tolist()} for "
                             f"{len(pairs)} pairs; fallbacks {ring.fallbacks}")
    # A capacity the steps overflow: the flagged tiles are re-run densely.
    (f_pairs, f_counters, f_overflow), forced = timed(lambda: join.ring_join_prepared(
        ring.prepared, mesh=mesh, axis="data", sim=MAIN["sim"], tau=MESH["tau"],
        b=MAIN["b"], capacity_per_step=MESH["forced_cap"], return_stats=True))
    if (not f_overflow.any() or not np.array_equal(f_pairs, pairs)
            or not np.array_equal(f_counters[:, :2], counters[:, :2])):
        raise AssertionError(f"rank {rank}: the ring at capacity {MESH['forced_cap']} "
                             f"(overflow {f_overflow.tolist()}) found {len(f_pairs)} pairs, "
                             f"counters {f_counters.tolist()}; at the default {len(pairs)}, "
                             f"{counters.tolist()}")
    out["ring"] = {"cold_s": cold, "warm_s": warm, "driver_s": drv, "forced_s": forced,
                   "forced_overflow_steps": int(f_overflow.sum()), "launches": launches,
                   "pairs": len(pairs), "digest": digest(pairs), "stats": stats.to_dict(),
                   "counters": counters.tolist(), "overflow_steps": int(overflow.sum())}
    arrays["ring"] = pairs
    del ring

    si = JoinEngine(cols["skewed"], MAIN["sim"], MESH["tau"], plan=si_plan, mesh=mesh,
                    axis="data", device="cuda")
    counts.zero()
    (pairs, stats), cold = timed(lambda: si.self_join(return_stats=True))
    (warm_pairs, warm_stats), warm = timed(lambda: si.self_join(return_stats=True))
    probes = [timed(lambda k=k: si.probe(cols[f"probe{k}"])) for k in range(int(data["probes"]))]
    launches = counts.read()
    if not np.array_equal(pairs, warm_pairs) or stats.to_dict() != warm_stats.to_dict():
        raise AssertionError(f"rank {rank}: sharded-indexed cold and warm runs differ")
    if si.fallbacks:
        raise AssertionError(f"rank {rank}: sharded-indexed fell back: {si.fallbacks}")
    out["sharded"] = {"cold_s": cold, "warm_s": warm, "probe_s": [s for _, s in probes],
                      "launches": launches, "builds": si.prepared.build_counts(),
                      "digests": [digest(pairs)] + [digest(p) for (p, _), _ in probes],
                      "stats": [stats.to_dict()] + [st.to_dict() for (_, st), _ in probes]}
    arrays["sharded"] = pairs
    for k, ((p, _), _) in enumerate(probes):
        arrays[f"probe{k}"] = p
    name = f"{backend}{world}"
    if rank == 0:
        np.savez(run_dir / f"{name}_pairs.npz", **arrays)
    (run_dir / f"{name}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


class MeshRanks:
    """``world`` ranks of this script started with ``flag``
    (:func:`mesh_child`, or :func:`train_child` with ``--train-child`` and
    its ``extra`` argument, ...).  ``wait()`` waits for all of them and
    returns each rank's record, its seconds in ``wall``; a rank that fails
    or outlasts ``timeout`` fails the phase (every rank is killed first).
    ``kill()`` stops any rank still running: a phase that starts launches
    side by side calls it for each in a ``finally``."""

    def __init__(self, run_dir: Path, backend: str, world: int, flag: str = "--mesh-child",
                 extra: tuple = (), timeout: float = MESH["timeout"]):
        import os

        env = dict(os.environ)
        # Loopback only: the ranks share this host, and the machine may have no
        # other interface.
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        self.run_dir, self.backend, self.world = run_dir, backend, world
        self.logs = [run_dir / f"{backend}{world}_rank{r}.log" for r in range(world)]
        self.t0 = time.perf_counter()
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r, log_path in enumerate(self.logs):
            with open(log_path, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), flag, str(run_dir),
                     backend, str(r), str(world), *extra], env=env, stdout=f,
                    stderr=subprocess.STDOUT))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> list[dict]:
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        finally:
            self.kill()
        self.wall = time.perf_counter() - self.t0
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:   # every failed rank's tail: the first to fail need not be rank bad[0]
            raise AssertionError("\n".join(
                f"{self.backend} rank {r} of {self.world} exited {self.procs[r].returncode}:\n"
                f"{self.logs[r].read_text()[-3000:]}" for r in bad))
        return [json.loads((self.run_dir / f"{self.backend}{self.world}_rank{r}.json")
                           .read_text()) for r in range(self.world)]


def run_mesh_ranks(run_dir: Path, backend: str, world: int, flag: str = "--mesh-child",
                   extra: tuple = (), timeout: float = MESH["timeout"]) -> list[dict]:
    """Start ``world`` ranks (:class:`MeshRanks`) and wait for them."""
    return MeshRanks(run_dir, backend, world, flag, extra, timeout).wait()


def one_rank_verdict_check(words, lengths, table, cutoff: int) -> dict:
    """Row 1 at the one NCCL rank's operands: the whole collection against
    itself in one launch, a bool grid past 2^31 elements.  Every row that
    holds an element at offset 2^31 or beyond is held, a band at a time,
    against the plain version computed on those rows alone; the kernel is
    timed at that shape.  Returns the shape, the rows checked, the time
    and the bound."""
    from repro_torch.kernels import bitmap_filter, ref

    sim, tau = MAIN["sim"], MESH["tau"]
    n, w = words.shape
    kw = dict(key_prod=False, self_join=False, cutoff=cutoff)
    got = bitmap_filter.candidate_matrix_mxu_cuda(words, words, lengths, lengths, table, **kw)
    if got.numel() <= 1 << 31:
        raise AssertionError(f"the one-rank grid {n} x {n} does not pass 2^31 elements")
    r_first = (1 << 31) // n
    bad, kept = 0, 0
    for r0 in range(r_first, n, 2048):
        r1 = min(r0 + 2048, n)
        want = ref.candidate_matrix_ref(words[r0:r1], words, lengths[r0:r1], lengths, sim=sim,
                                        tau=tau, self_join=False, cutoff=cutoff, table=table)
        bad += int((got[r0:r1] != want).sum())
        kept += int(want.sum())
        del want
    del got
    if bad:
        raise AssertionError(f"candidate_matrix_mxu at {n} x {n}: {bad} verdicts of rows "
                             f"{r_first}..{n - 1} (past offset 2^31) differ from the plain "
                             f"version's")
    ms = cuda_ms(lambda: bitmap_filter.candidate_matrix_mxu_cuda(words, words, lengths, lengths,
                                                                 table, **kw), 3)
    pairs = n * n
    in_bytes = 2 * n * (w * 4 + 4) + table.numel() * 4
    bound = verdict_bound(in_bytes + pairs, pairs, 32 * w, pairs * (VERDICT_OPS + HAM_OPS))
    log(f"phase 20 kernel parity: candidate_matrix_mxu at the one rank's {n} x {n} grid "
        f"({pairs} elements): rows {r_first}..{n - 1} (every element from offset 2^31 on, "
        f"{kept} verdicts kept) exact against the plain version on those rows alone; "
        f"device {ms:.4f} ms, bound {bound[0]:.4f} ms by the {bound[2]} "
        f"({bound[0] / ms:.1%} of it)")
    return {"shape": [n, n, w], "rows": [r_first, n], "ms": ms, "bound_ms": bound[0]}


def mesh_kernel_rows(zipf, skewed, plan, runs: dict) -> list[dict]:
    """Rows 1, 4 and 5 on phase 20's paths, each against its plain version
    at the operands the paths give it: ``candidate_matrix_mxu`` at the
    4-rank ring's shards (rank 0's diagonal step and its step 1, R shard 0
    against S shard 3) and at the one rank's whole grid
    (:func:`one_rank_verdict_check`); ``expand_filter`` and ``verdict_verify`` at the
    first SKEWED chunk on each of the 4 token slabs (sentinel-padded tails)
    and each rank's slice of the gathered candidates.  ``expand_filter`` is
    timed at the slab with the most expansion, ``verdict_verify`` at the
    slice with the most candidates."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import engine, expected, verify
    from repro_torch.core.join import _bucket_capacity
    from repro_torch.index import candidates
    from repro_torch.index.postings import shard_expansion_counts
    from repro_torch.kernels import bitmap_filter, ref

    dev = torch.device("cuda")
    sim, tau, b = MAIN["sim"], MESH["tau"], MAIN["b"]
    world = max(w for _, w in MESH["runs"])
    src = "src/repro_torch/kernels/csrc/"

    def by_run(path: str, name: str) -> dict:
        """This kernel's launches on ``path`` (the ring or sharded-indexed),
        per run and rank, and their sum."""
        each = {run: [r[path]["launches"][name] for r in ranks] for run, ranks in runs.items()}
        return {"launches": sum(map(sum, each.values())), "launches_by_run": each}

    # Row 1 at the ring's shards.
    prep = engine.prepare(zipf, dev)
    chosen = bm.choose_method(tau, b)
    cutoff = expected.cutoff_point(chosen, b, tau)
    _, lengths = prep.device_arrays()
    words = prep.bitmap_words(b, chosen)
    shard = -(-prep.num_sets // world)
    table = verify.prune_table_dev(sim, tau, prep.max_len, prep.max_len, dev)
    wr, lr = words[:shard], lengths[:shard]
    errs = []
    for s0 in (0, (world - 1) * shard):
        ws, ls = words[s0:s0 + shard], lengths[s0:s0 + shard]
        got = bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, key_prod=False,
                                                      self_join=False, cutoff=cutoff)
        want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau, self_join=False,
                                        cutoff=cutoff, table=table)
        errs.append(max_err(got, want))
        kept = int(want.sum())
        del got, want
    if any(errs):
        raise AssertionError(f"candidate_matrix_mxu != plain at the ring's shards: {errs}")
    kw = dict(key_prod=False, self_join=False, cutoff=cutoff)
    ms = cuda_ms(lambda: bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw),
                 20)
    plain = cuda_ms(lambda: ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau,
                                                     self_join=False, cutoff=cutoff,
                                                     table=table), 2, warmup=1, reps=1)
    w = wr.shape[1]
    pairs = shard * ws.shape[0]
    in_bytes = (shard + ws.shape[0]) * (w * 4 + 4) + table.numel() * 4
    b_c = verdict_bound(in_bytes + pairs, pairs, 32 * w, pairs * (VERDICT_OPS + HAM_OPS))
    log(f"phase 20 kernel parity: candidate_matrix_mxu at the ring's {shard} x {ws.shape[0]} "
        f"shards (W = {w}; the diagonal step and step 1 of rank 0) exact, {kept} verdicts "
        f"kept at step 1; device {ms:.4f} ms, plain {plain:.3f} ms, bound {b_c[0]:.4f} ms "
        f"by the {b_c[2]} ({b_c[0] / ms:.1%} of it)")
    one = one_rank_verdict_check(words, lengths, table, cutoff)
    rows = [kernel_row("candidate_matrix_mxu", src + "bitmap_filter.cu (planes_mma.cuh)",
                       "src/repro/kernels/bitmap_filter.py:151", err=0, ms=ms, plain_ms=plain,
                       bound=b_c[:2],
                       path=f"phase 20, the ring: ZIPF tau={tau} self-join over {world} gloo "
                            f"ranks sharing the card, then one NCCL rank")
            | {"bound_term": b_c[2], "shape": [shard, ws.shape[0], w],
               "shape_one_rank": one["shape"], "rows_checked_past_2_31": one["rows"],
               "ms_one_rank": one["ms"], "bound_ms_one_rank": one["bound_ms"]}
            | by_run("ring", "candidate_matrix_mxu")]
    del prep, words, lengths
    gc.collect()
    torch.cuda.empty_cache()

    # Rows 4 and 5 at the slabs: the first chunk, as each rank runs it.
    sk = engine.prepare(skewed, dev)
    sharded = sk.sharded_postings(sim, tau, plan.ell, world)
    post = sharded.base
    d = candidates._chunk_inputs(sk, None, sim, tau, plan.b, plan.method, plan.mix)
    ps_np, lp = candidates.probe_prefix_lengths(sk, sim, tau)
    lo_np, hi_np, lo_d, hi_d = sk.length_window_int(sim, tau)
    cb = plan.block
    per = shard_expansion_counts(sharded, sk.tokens[:cb], ps_np[:cb], lo_np[:cb], hi_np[:cb], lp)
    cap = min(_bucket_capacity(int(per.max())), sk.num_sets * cb * lp)
    vocab, tid = post.device_arrays(dev)[:2]
    ps_d = torch.from_numpy(ps_np).to(dev)
    st = dict(sim=sim, tau=tau, cap=cap, lp=lp, scale=post.max_len + 1, self_join=True,
              cutoff=int(plan.cutoff) if plan.use_cutoff else 1 << 30, impl="auto",
              table=d["table"])
    args = [(d["tokens_r"], d["lengths_r"], d["words_r"], vocab, tid,
             *sharded.device_arrays(dev, k), d["tokens_s"][:cb], d["lengths_s"][:cb],
             d["words_s"][:cb], ps_d[:cb], lo_d[:cb], hi_d[:cb], d["need_tab"], 0)
            for k in range(world)]
    local = []
    for a in args:
        rr, ss = ref.expand_filter_ref(*candidates.expand_filter_operands(a, st), sim=sim,
                                       tau=tau, cap=cap, lp=lp, self_join=True,
                                       table=d["table"])
        local.append(candidates.dedup_pairs(rr, ss, cap)[:2])
    u_r, u_s, n_gen = candidates.dedup_pairs(torch.cat([r for r, _ in local]),
                                             torch.cat([s for _, s in local]), world * cap)
    forms, funnel = [], []
    for k, a in enumerate(args):
        sl = slice(k * cap, (k + 1) * cap)
        ok = (k * cap + torch.arange(cap, device=dev)) < n_gen
        forms.append(StageForms(a, st, (d["words_r"], d["words_s"][:cb]), "swar_tiled",
                                cands=(u_r[sl], u_s[sl], ok)))
        funnel.append(forms[-1].check(f"slab {k} of {world}, the first SKEWED chunk")[0])
    hot = int(np.argmax(per))
    busy = int(np.argmax([f["generated"] for f in funnel]))
    timed_at = {"expand_filter": hot, "verdict_verify": busy}
    t = {name: time_stage(forms[k], 20)[name] for name, k in timed_at.items()}
    log(f"phase 20 kernel parity: expand_filter and verdict_verify exact against their plain "
        f"versions and the unfused compositions on each of {world} slabs (width "
        f"{sharded.slab_width}, postings {sharded.counts.tolist()}), first chunk (cap {cap}, "
        f"per-slab expansion {per.tolist()}); funnels {json.dumps(funnel)}")
    path = (f"phase 20, sharded-indexed: SKEWED tau={tau} self-join and probes over {world} "
            f"gloo ranks sharing the card, then one NCCL rank")
    for name, replaces in (("expand_filter", "src/repro/kernels/postings.py:89"),
                           ("verdict_verify", "src/repro/kernels/postings.py:220")):
        tt = t[name]
        log(f"phase 20 timing, slab {timed_at[name]}: {name} {tt['ms_turns'][0]:.4f} / "
            f"{tt['ms_turns'][1]:.4f} ms in turns with the unfused composition "
            f"{tt['unfused_ms_turns'][0]:.4f} / {tt['unfused_ms_turns'][1]:.4f} ms; plain "
            f"{tt['plain_ms']:.3f} ms; bound {tt['bound'][0]:.5f} ms by {tt['bound'][1]}")
        rows.append(kernel_row(name, src + "postings.cu", replaces, err=0,
                               ms=tt["ms_turns"][0], plain_ms=tt["plain_ms"], bound=tt["bound"],
                               path=path)
                    | {"ms_turns": tt["ms_turns"], "unfused_ms_turns": tt["unfused_ms_turns"],
                       "slab": timed_at[name], "cap": cap} | by_run("sharded", name))
    return rows


def phase_mesh_drivers(zipf, zipf_pairs, zipf_candidates, skewed, skewed_results,
                       batches) -> list[dict]:
    """Phase 20: the ring and sharded-indexed drivers on ``torch.distributed``,
    each run's ranks processes of their own: 4 gloo ranks sharing the card,
    then one NCCL rank.  The ring's ZIPF pairs must equal phase 4's blocked
    pairs, and its candidate counters sum to phase 4's bitmap candidates
    (the verdicts it kept, before exact verification hides any extra one);
    sharded-indexed's SKEWED self-join and probes phase 5's pairs and
    ``JoinStats``; every rank the same; each path's kernels launched on
    every rank, and no other verdict or postings kernel.  Returns rows 1, 4
    and 5 on these paths."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    log(smi_line())
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        data = {"probes": np.array(len(batches))}
        for name, col in [("zipf", zipf), ("skewed", skewed)] + [
                (f"probe{k}", b) for k, b in enumerate(batches)]:
            data[name + "_tokens"], data[name + "_lengths"] = col.tokens, col.lengths
        np.savez(run_dir / "data.npz", **data)
        (run_dir / "plan.json").write_text(json.dumps(skewed_results["plan"].to_dict()))
        want_self, want_probes = skewed_results["self"], skewed_results["probes"]
        runs = {}
        for backend, world in MESH["runs"]:
            t0 = time.perf_counter()
            ranks = run_mesh_ranks(run_dir, backend, world)
            wall = time.perf_counter() - t0
            run = f"{backend} x{world}"
            got = np.load(run_dir / f"{backend}{world}_pairs.npz")
            if not np.array_equal(got["ring"], zipf_pairs):
                raise AssertionError(f"{run}: the ring's {len(got['ring'])} ZIPF pairs != "
                                     f"phase 4's blocked {len(zipf_pairs)}")
            ring_cands = sum(c[0] for c in ranks[0]["ring"]["counters"])
            if (ring_cands != zipf_candidates
                    or ranks[0]["ring"]["stats"]["candidates"] != zipf_candidates):
                raise AssertionError(f"{run}: the ring kept {ring_cands} candidates (stats "
                                     f"{ranks[0]['ring']['stats']['candidates']}), phase 4's "
                                     f"blocked join {zipf_candidates}")
            wants = [want_self] + list(want_probes)
            for k, (key, (pairs, stats)) in enumerate(zip(
                    ["sharded"] + [f"probe{i}" for i in range(len(batches))], wants)):
                if (not np.array_equal(got[key], pairs)
                        or ranks[0]["sharded"]["stats"][k] != stats.to_dict()):
                    raise AssertionError(f"{run}: sharded-indexed {key} differs from phase 5's "
                                         f"indexed: {len(got[key])} vs {len(pairs)} pairs\n"
                                         f"{ranks[0]['sharded']['stats'][k]}\n{stats}")
            for r in ranks:
                same = (r["ring"]["digest"] == ranks[0]["ring"]["digest"]
                        and r["sharded"]["digests"] == ranks[0]["sharded"]["digests"]
                        and r["sharded"]["stats"] == ranks[0]["sharded"]["stats"])
                ring_l, si_l = r["ring"]["launches"], r["sharded"]["launches"]
                idle = [n for n, v in ring_l.items() if v and n != "candidate_matrix_mxu"]
                idle += [n for n, v in si_l.items()
                         if v and n not in ("expand_filter", "verdict_verify")]
                if (not same or idle or not ring_l["candidate_matrix_mxu"]
                        or not si_l["expand_filter"] or not si_l["verdict_verify"]):
                    raise AssertionError(f"{run} rank {r['rank']}: results differ from rank "
                                         f"0's ({not same}) or launches {ring_l} {si_l}")
            log(f"phase 20, {run} ({wall:.1f} s with start-up): the ring on ZIPF "
                f"{zipf.num_sets} = phase 4's {len(zipf_pairs)} pairs and {zipf_candidates} "
                f"candidates, at capacity {MESH['forced_cap']} too, counters "
                f"{ranks[0]['ring']['counters']}, stats {json.dumps(ranks[0]['ring']['stats'])}; "
                f"sharded-indexed on SKEWED {skewed.num_sets} = phase 5's pairs and JoinStats "
                f"(self-join {len(want_self[0])} pairs, {len(batches)} probes); every rank "
                f"the same; builds {json.dumps(ranks[0]['sharded']['builds'])}")
            for r in ranks:
                ring, si = r["ring"], r["sharded"]
                log(f"  rank {r['rank']}: ring cold {ring['cold_s']:.3f} s, warm "
                    f"{ring['warm_s']:.3f} s (driver alone {ring['driver_s']:.3f} s; at "
                    f"capacity {MESH['forced_cap']} {ring['forced_s']:.3f} s, "
                    f"{ring['forced_overflow_steps']} of {r['world'] ** 2} steps re-run), launches "
                    f"{json.dumps({k: v for k, v in ring['launches'].items() if v})}; "
                    f"sharded-indexed cold {si['cold_s']:.3f} s, warm {si['warm_s']:.3f} s, "
                    f"probes {', '.join(f'{x:.3f}' for x in si['probe_s'])} s, launches "
                    f"{json.dumps({k: v for k, v in si['launches'].items() if v})}")
            runs[run] = ranks
        rows = mesh_kernel_rows(zipf, skewed, skewed_results["plan"], runs)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 21: sharded training on torch.distributed
# ---------------------------------------------------------------------------

# smollm-135m at its published widths on phase 12's global batch (8 x 2,048
# tokens), over four meshes: 4 gloo ranks sharing the card on (4,) data
# (FSDP only), 3 gloo ranks on (1, 3) data x model (TP: its 3 KV heads make
# it head-parallel), 4 gloo ranks on (1, 4) (9 heads on 3 KV heads divide no
# TP of 4, so attention splits the q sequence: each TP rank its 512 rows at
# their offset, against the whole K and V) and one NCCL rank on (1, 1).
# float32 first (held to the single-device float32 step), its depth cut from
# 30 to ``f32_layers`` (the float32 attention backward runs on the CUDA
# cores, and the gloo ranks stage every collective through the host), then
# bf16 (timed, the bytes a rank held): the NCCL rank all 30 layers, 3 steps;
# the gloo ranks 2 steps of 4 layers, the cut that pays for phase 23 within
# the script's time limit (each gloo step stages every collective through
# the host: 3 steps of 30 layers on three meshes took most of PR 26's 183 s
# phase).  AdamW without warmup, so every step moves the parameters.
SHARDED = dict(arch="smollm-135m", batch=8, seq=2048, f32_steps=2, f32_layers=6,
               bf16_steps={"gloo": 2, "nccl": 3}, bf16_layers={"gloo": 4, "nccl": 30},
               lr=3e-3, decay_steps=10,
               runs=(("gloo", "4,1x4"), ("gloo", "1x3"), ("nccl", "1x1")), timeout=480)
# A rank's float32 slices after the steps against the single-device step's:
# each parameter leaf's RMS difference over its RMS update (AdamW divides by
# sqrt(nu) + 1e-8: where a gradient is near 1e-8, summing it in another order
# moves that element's step), each moment's relative RMS, the losses relative.
SHARDED_PARAM_REL_RMS = 1e-2
SHARDED_MOMENT_REL_RMS = 1e-3
SHARDED_LOSS_RTOL = 1e-4
# The bf16 steps' losses against the single-device bf16 steps', relative.
SHARDED_BF16_LOSS_RTOL = 1e-2


def _leaf_gate(mine: list, want: list, initial: list | None) -> tuple[float, int]:
    """The largest per-leaf ratio of the RMS difference ``mine - want`` over
    the RMS of ``want - initial`` (the update), or over the RMS of ``want``
    without ``initial``; and that leaf's index."""
    ratios = []
    for i, (a, b) in enumerate(zip(mine, want)):
        scale = (b - initial[i]) if initial is not None else b
        den = float(scale.double().pow(2).mean().sqrt())
        num = float((a.double() - b.double()).pow(2).mean().sqrt())
        ratios.append(num / den if den else (0.0 if num == 0 else math.inf))
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    return ratios[worst], worst


def train_child(run_dir: Path, backend: str, rank: int, world: int, shapes: str) -> None:
    """One rank of phase 21 (``chip_smoke.py --train-child DIR BACKEND RANK
    WORLD MESH``): joins the group over a file store in ``run_dir`` (the
    run's own directory; the seed and the single-device checkpoints in its
    parent), builds the mesh (``4`` is (4,) data, ``AxB`` (A, B) data x
    model), and trains smollm-135m sharded: this rank's slices of the seeded
    parameters (``sharded_state``), its rows of each global batch (the
    loader over the mesh), ``sharded_train_step``.  float32
    (``SHARDED["f32_layers"]`` layers): ``SHARDED["f32_steps"]`` steps, then
    its slices held to the single-device float32 step's checkpoint
    (restored onto this mesh, each rank reading its slices); a control step
    from the same slices that must fail that gate: on the (4,) mesh rank
    0's rows shifted by one, on (1, 4) (the ``q_sequence`` split) every
    flash call given query offset 0.  bf16: ``SHARDED["bf16_steps"]`` steps
    timed, the first step's every flash kernel call held to its plain
    version at its operands (and its q rows and offset recorded).  The
    flash launch counters are zeroed just before each run's steps and read
    just after.  Writes ``<backend><world>_rank<rank>.json``."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.distributed import CheckpointManager
    from repro_torch.distributed.sharding import layout_of, named
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.optimizer import opt_init
    from repro_torch.train.step import sharded_state, sharded_train_step
    from repro_torch.train.tree import leaves, tree_map, unflatten

    @contextlib.contextmanager
    def zero_offsets():   # the control: every flash call at query offset 0
        saved = ops.flash_attention, ops.flash_attention_bwd
        ops.flash_attention = lambda *a, **kw: saved[0](*a, **{**kw, "q_offset": 0})
        ops.flash_attention_bwd = lambda *a, **kw: saved[1](*a, **{**kw, "q_offset": 0})
        try:
            yield
        finally:
            ops.flash_attention, ops.flash_attention_bwd = saved

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store_{backend}{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARDED["timeout"]))
    seed = int((run_dir.parent / "seed").read_text())
    b, s = SHARDED["batch"], SHARDED["seq"]
    base = configs.get(SHARDED["arch"])
    meshes = {}
    for shape in shapes.split(","):   # the meshes over these ranks, one after another
        dims = tuple(int(x) for x in shape.split("x"))
        mesh = make_mesh(dims, ("data",) if len(dims) == 1 else ("data", "model"))
        layout = layout_of(mesh)
        out = meshes[shape] = {"rank": rank, "backend": backend, "world": world, "mesh": shape,
                               "coord": layout.coord}
        for dtype in ("float32", "bfloat16"):
            f32 = dtype == "float32"
            cfg = dataclasses.replace(base, dtype=dtype, num_layers=SHARDED["f32_layers"] if f32
                                      else SHARDED["bf16_layers"][backend])
            opt = OptimizerConfig(learning_rate=SHARDED["lr"], warmup_steps=0,
                                  decay_steps=SHARDED["decay_steps"])
            t0 = time.perf_counter()
            model = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
            step, sspecs, _ = sharded_train_step(model, opt, mesh)
            state = sharded_state(model, opt, mesh)
            del model
            gc.collect()
            torch.cuda.empty_cache()
            initial = [p.detach().clone() for p in leaves(state["params"])] if f32 else None
            nbytes = {part: sum(t.numel() * t.element_size() for t in leaves(state[part]))
                      for part in ("params", "opt")}
            loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                         vocab_size=cfg.vocab_size),
                                       device="cuda", mesh=mesh, batch_axes=("data",))
            setup_s = time.perf_counter() - t0
            n = SHARDED["f32_steps"] if f32 else SHARDED["bf16_steps"][backend]
            torch.cuda.reset_peak_memory_stats()
            fwd_calls, bwd_calls, captured = [], [], (0, 0)
            losses, ms = [], []
            fa.reset_launches()
            for i in range(n):
                batch = next(loader)
                dist.barrier()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if i == 0 and not f32:   # every kernel call of the first bf16 step, captured
                    with capture_calls(fa, "flash_attention_cuda", fwd_calls), \
                            capture_calls(fa, "flash_attention_bwd_cuda", bwd_calls):
                        state, metrics = step(state, batch)
                        captured = (fa.flash_attention_cuda.launches,
                                    fa.flash_attention_bwd_cuda.launches)
                else:
                    state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(metrics["loss"]))
            launches = {"flash_attention": fa.flash_attention_cuda.launches + captured[0],
                        "flash_attention_bwd": fa.flash_attention_bwd_cuda.launches + captured[1],
                        "instances": {k: v for k, v in fa.flash_attention_cuda.instance_launches.items()
                                      if v},
                        "bwd_instances": {k: v for k, v in
                                          fa.flash_attention_bwd_cuda.instance_launches.items() if v}}
            rec = {"losses": losses, "step_ms": ms, "bytes": nbytes, "setup_s": setup_s,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
                   "grad_norm": float(metrics["grad_norm"])}
            if f32:
                # The single-device step's state, restored onto this mesh.
                like = tree_map(torch.empty_like, state)
                want, _ = CheckpointManager(str(run_dir.parent / "ref")).restore(
                    like, named(mesh, sspecs), step=n)
                rec["param_gate"] = _leaf_gate(leaves(state["params"]), leaves(want["params"]),
                                               initial)
                rec["moment_gate"] = _leaf_gate(leaves(state["opt"]), leaves(want["opt"]), None)
                del like, want
                if shape in ("4", "1x4"):
                    # The control: one step from the same slices, rank 0's rows
                    # shifted (4), or every flash call at offset 0 (1x4).
                    params = unflatten(state["params"],
                                       [p0.clone().requires_grad_(True) for p0 in initial])
                    ctrl = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
                            "params": params, "opt": opt_init(opt, params)}
                    host = loader.host_batch(0)
                    rows = b // dims[0]
                    lo = loader.rows.start + (1 if rank == 0 and shape == "4" else 0)
                    with zero_offsets() if shape == "1x4" else contextlib.nullcontext():
                        ctrl, _ = step(ctrl, {k: v[lo:lo + rows].contiguous().cuda()
                                              for k, v in host.items()})
                    want, _ = CheckpointManager(str(run_dir.parent / "ref")).restore(
                        tree_map(torch.empty_like, ctrl), named(mesh, sspecs), step=1)
                    rec["control_gate"] = _leaf_gate(leaves(ctrl["params"]), leaves(want["params"]),
                                                     initial)
                    del ctrl, want, params
            else:
                with torch.no_grad():
                    rec["fwd_calls_max_abs_err"] = max(
                        flash_close(fa.flash_attention_cuda(*a, **kw)[0],
                                    ref.flash_attention_ref(*a, **kw)[0],
                                    f"rank {rank} step forward call {j}")
                        for j, (a, kw) in enumerate(fwd_calls))
                    rec["bwd_calls_rel_rms"] = max(
                        bwd_close(fa.flash_attention_bwd_cuda(*a, **kw),
                                  ref.flash_attention_bwd_ref(*a, **kw),
                                  f"rank {rank} step backward call {j}")
                        for j, (a, kw) in enumerate(bwd_calls))
                rec["calls"] = [len(fwd_calls), len(bwd_calls)]
                rec["local_heads"] = int(fwd_calls[0][0][0].shape[2])
                rec["local_rows"] = int(fwd_calls[0][0][0].shape[0])
                # Each call's (q rows, query offset): the q_sequence split's slice.
                rec["q_rows"] = sorted({(int(a[0].shape[1]), int(kw.get("q_offset", 0)))
                                        for a, kw in fwd_calls + bwd_calls})
            out[dtype] = rec
            del state, fwd_calls, bwd_calls, initial
            gc.collect()
            torch.cuda.empty_cache()
    (run_dir / f"{backend}{world}_rank{rank}.json").write_text(json.dumps({"meshes": meshes}))
    dist.barrier()
    dist.destroy_process_group()


def phase_sharded_train(seed: int) -> tuple[dict, dict]:
    """Phase 21: smollm-135m trained sharded on ``torch.distributed``, each
    run's ranks processes of their own (:func:`train_child`), against
    phase 12's single-device step (``make_train_step``) on the same seed
    and global batch, run here first in float32 (its state after each step
    checkpointed for the ranks to restore their slices of) and in bf16.
    Returns the phase's record and rows 9 and 9d's launches by run and
    rank."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.distributed import CheckpointManager
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    from repro_torch.train.tree import leaves

    t_phase = time.perf_counter()
    log(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    b, s = SHARDED["batch"], SHARDED["seq"]
    record: dict = {"arch": SHARDED["arch"], "batch": [b, s]}
    launches_by_path: dict = {"flash_attention": {}, "flash_attention_bwd": {}}
    started: dict = {}
    try:
        (run_dir / "seed").write_text(str(seed))
        single = {}
        # float32, then bf16 at each backend's depth and steps.
        depths = [("float32", SHARDED["f32_layers"], SHARDED["f32_steps"])] + sorted(
            {("bfloat16", SHARDED["bf16_layers"][be], SHARDED["bf16_steps"][be])
             for be, _ in SHARDED["runs"]})
        for dtype, n_layers, n_steps in depths:
            f32 = dtype == "float32"
            base = configs.get(SHARDED["arch"])
            cfg = dataclasses.replace(base, dtype=dtype, num_layers=n_layers)
            model = Model(cfg, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(seed))
            opt = OptimizerConfig(learning_rate=SHARDED["lr"], warmup_steps=0,
                                  decay_steps=SHARDED["decay_steps"])
            state = init_state(model, opt)
            nbytes = {part: sum(t.numel() * t.element_size() for t in leaves(state[part]))
                      for part in ("params", "opt")}
            loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                         vocab_size=cfg.vocab_size),
                                       device="cuda")
            step = make_train_step(model, opt)
            ckpt = CheckpointManager(str(run_dir / "ref"))
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            losses, ms = [], []
            for i in range(n_steps):
                batch = next(loader)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(metrics["loss"]))
                if f32:
                    ckpt.save(i + 1, state)
            single[dtype if f32 else f"{dtype}/{n_layers}"] = {
                             "losses": losses, "step_ms": ms, "bytes": nbytes,
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "launches": [fa.flash_attention_cuda.launches,
                                          fa.flash_attention_bwd_cuda.launches]}
            del model, state, step, loader
            gc.collect()
            torch.cuda.empty_cache()
        record["single"] = single
        sf = single["float32"]
        log(f"phase 21 single-device reference (phase 12's make_train_step), {SHARDED['arch']} "
            f"at {b} x {s:,}, AdamW lr {SHARDED['lr']} without warmup: float32 (TF32 off; "
            f"{SHARDED['f32_layers']} of 30 layers) losses "
            f"{', '.join(f'{x:.6f}' for x in sf['losses'])}, step ms "
            f"{', '.join(f'{x:.1f}' for x in sf['step_ms'])}, peak {sf['peak_gb']:.2f} GB; "
            + "; ".join(
                f"bf16 ({key.split('/')[1]} layers) losses "
                f"{', '.join(f'{x:.4f}' for x in sb['losses'])}, step ms "
                f"{', '.join(f'{x:.1f}' for x in sb['step_ms'])}, parameters "
                f"{sb['bytes']['params'] / 1e9:.3f} GB and AdamW state "
                f"{sb['bytes']['opt'] / 1e9:.3f} GB (float32), peak {sb['peak_gb']:.2f} GB"
                for key, sb in single.items() if key != "float32"))
        runs = {}

        def start(backend: str, shapes: str) -> MeshRanks:
            # One launch of ranks runs its meshes in turn (each rank process
            # pays its start and its first float32 step once).
            world = math.prod(int(x) for x in shapes.split(",")[0].split("x"))
            sub = run_dir / f"{backend}_{shapes.replace(',', '_')}"
            sub.mkdir()
            started[backend, shapes] = MeshRanks(sub, backend, world, flag="--train-child",
                                                 extra=(shapes,), timeout=SHARDED["timeout"])
            return started[backend, shapes]

        # The gloo launches run side by side (their steps stage every
        # collective through the host, and their walls are not the card's);
        # the NCCL rank runs alone after them, so that its steps' times are.
        for backend, shapes in SHARDED["runs"]:
            if backend == "gloo":
                start(backend, shapes)
        for backend, shapes in SHARDED["runs"]:
            world = math.prod(int(x) for x in shapes.split(",")[0].split("x"))
            ranks_of = started.get((backend, shapes)) or start(backend, shapes)
            launched = ranks_of.wait()
            wall = ranks_of.wall
            sb = single[f"bfloat16/{SHARDED['bf16_layers'][backend]}"]
            layers = {"float32": SHARDED["f32_layers"], "bfloat16": SHARDED["bf16_layers"][backend]}
            for shape in shapes.split(","):
                dims = tuple(int(x) for x in shape.split("x"))
                run = (f"{backend} x{world} on ({dims[0]},) data" if len(dims) == 1 else
                       f"{backend} x{world} on {dims} data x model")
                ranks = [r["meshes"][shape] for r in launched]
                tp = dims[1] if len(dims) > 1 else 1
                heads = configs.get(SHARDED["arch"]).num_heads
                for r in ranks:
                    rf, rb = r["float32"], r["bfloat16"]
                    where = f"phase 21, {run}, rank {r['rank']}"
                    # Where the heads do not divide TP each rank's calls take its
                    # S / TP q rows at their offset (q_sequence), else all S at 0.
                    split = tp > 1 and heads % tp != 0
                    rows = s // tp if split else s
                    want_rows = [[rows, r["coord"].get("model", 0) * rows if split else 0]]
                    loss_err = max(abs(a - w) / abs(w) for a, w in zip(rf["losses"], sf["losses"]))
                    bf16_err = max(abs(a - w) / abs(w) for a, w in zip(rb["losses"], sb["losses"]))
                    shards = world
                    share = {part: rb["bytes"][part] * shards / sb["bytes"][part]
                             for part in ("params", "opt")}
                    want = {dt: {"flash_attention": n * 2 * layers[dt],
                                 "flash_attention_bwd": n * layers[dt]}
                            for dt, n in (("float32", SHARDED["f32_steps"]),
                                          ("bfloat16", SHARDED["bf16_steps"][backend]))}
                    got = {dt: {k: r[dt]["launches"][k] for k in want[dt]} for dt in want}
                    bad = []
                    if loss_err > SHARDED_LOSS_RTOL:
                        bad.append(f"float32 losses {rf['losses']} vs {sf['losses']}")
                    if rf["param_gate"][0] > SHARDED_PARAM_REL_RMS:
                        bad.append(f"float32 parameter leaf {rf['param_gate'][1]}: "
                                   f"{rf['param_gate'][0]:.3g} of its update")
                    if rf["moment_gate"][0] > SHARDED_MOMENT_REL_RMS:
                        bad.append(f"float32 moment leaf {rf['moment_gate'][1]}: "
                                   f"{rf['moment_gate'][0]:.3g}")
                    if bf16_err > SHARDED_BF16_LOSS_RTOL or not all(map(math.isfinite, rb["losses"])):
                        bad.append(f"bf16 losses {rb['losses']} vs {sb['losses']}")
                    if "control_gate" in rf and rf["control_gate"][0] <= SHARDED_PARAM_REL_RMS:
                        bad.append(f"the control passed: {rf['control_gate'][0]:.3g}")
                    if rb["q_rows"] != want_rows:
                        bad.append(f"flash calls' (q rows, offset) {rb['q_rows']}, expected "
                                   f"{want_rows}")
                    if got != want:
                        bad.append(f"flash launches {got}, expected {want}")
                    if not all(1.0 <= v <= 1.01 for v in share.values()):
                        bad.append(f"bytes x {shards} shards over the single rank's: {share}")
                    if r["float32"]["losses"] != ranks[0]["float32"]["losses"] or \
                            r["bfloat16"]["losses"] != ranks[0]["bfloat16"]["losses"]:
                        bad.append("losses differ from rank 0's")
                    if bad:
                        raise AssertionError(f"{where}: " + "; ".join(bad))
                    for dt, k in (("bfloat16", "flash_attention"), ("bfloat16", "flash_attention_bwd")):
                        launches_by_path[k][f"{where} ({dt} steps)"] = r[dt]["launches"][k]
                    for k in ("flash_attention", "flash_attention_bwd"):
                        launches_by_path[k][f"{where} (float32 steps)"] = rf["launches"][k]
                med = statistics.median(ranks[0]["bfloat16"]["step_ms"][1:])
                f32_med = ranks[0]["float32"]["step_ms"][-1]
                runs[run] = {"wall_s": wall, "bf16_step_ms": med, "bf16_layers": layers["bfloat16"],
                             "bf16_tokens_per_s": b * s / med * 1e3, "f32_step_ms": f32_med,
                             "ranks": ranks}
                r0 = ranks[0]
                log(f"phase 21, {run} ({wall:.1f} s with start-up for the launch's "
                    f"{shapes.count(',') + 1} mesh(es)"
                    f"{', beside the other gloo launch' if backend == 'gloo' else ''}): "
                    f"float32 losses "
                    f"{', '.join(f'{x:.6f}' for x in r0['float32']['losses'])} = the single "
                    f"device's within {SHARDED_LOSS_RTOL} on every rank; bf16 losses "
                    f"{', '.join(f'{x:.4f}' for x in r0['bfloat16']['losses'])} ({layers['bfloat16']} "
                    f"layers; single device within {SHARDED_BF16_LOSS_RTOL}); bf16 step {med:.1f} ms "
                    f"(median of the steps "
                    f"after the first, wall with the barrier's sync), "
                    f"{b * s / med * 1e3:,.0f} tokens/s; float32 step {f32_med:.1f} ms (the last, "
                    f"{SHARDED['f32_layers']} layers); every rank the same losses")
                for r in ranks:
                    rf, rb = r["float32"], r["bfloat16"]
                    what = "every flash call at offset 0" if shape == "1x4" else "rank 0's rows shifted"
                    ctrl = (f", control ({what}) {rf['control_gate'][0]:.3g} fails the gate as it "
                            f"must" if "control_gate" in rf else "")
                    log(f"  rank {r['rank']} {json.dumps(r['coord'])}: parameters "
                        f"{rb['bytes']['params'] / 1e9:.3f} GB, AdamW state "
                        f"{rb['bytes']['opt'] / 1e9:.3f} GB (float32, uncut; the single rank's "
                        f"{sb['bytes']['params'] / 1e9:.3f} / {sb['bytes']['opt'] / 1e9:.3f}); peak "
                        f"{rf['peak_gb']:.2f} GB float32, {rb['peak_gb']:.2f} GB bf16; float32 slices "
                        f"against the single device's: worst parameter leaf "
                        f"{rf['param_gate'][0]:.3g} of its update (gate {SHARDED_PARAM_REL_RMS}), "
                        f"worst moment {rf['moment_gate'][0]:.3g} (gate {SHARDED_MOMENT_REL_RMS})"
                        f"{ctrl}; float32 step ms {', '.join(f'{x:.1f}' for x in rf['step_ms'])}, bf16 "
                        f"{', '.join(f'{x:.1f}' for x in rb['step_ms'])}; "
                        f"the first bf16 step's {rb['calls'][0]} forward and {rb['calls'][1]} "
                        f"backward kernel calls ({rb['local_rows']} rows of {rb['q_rows'][0][0]} "
                        f"positions from {rb['q_rows'][0][1]}, {rb['local_heads']} heads a call) at "
                        f"their operands: forward max |err| "
                        f"{rb['fwd_calls_max_abs_err']:.3g}, backward relative RMS "
                        f"{rb['bwd_calls_rel_rms']:.3g}; launches float32 "
                        f"{json.dumps(rf['launches'])}, bf16 {json.dumps(rb['launches'])}")
        record["runs"] = runs
    finally:
        for ranks_of in started.values():
            ranks_of.kill()
        shutil.rmtree(run_dir, ignore_errors=True)
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21: {record['phase_s']:.1f} s; NCCL with more than one rank is not exercised "
        f"(one card): the gloo ranks share it through host copies")
    return record, launches_by_path


# Phase 22 (a): qwen3-8b served sharded.  Its gloo ranks share the card and
# stage every collective through the host, so they run the depth cut from 36
# to gloo_layers and a shorter generation (gloo_gen tokens: the prefill and
# gloo_gen - 1 decode steps); the NCCL rank runs the published depth and
# phase 10's prompt and generation.  Decode tokens are seeded (teacher
# forcing), so no argmax tie can fork a run from its reference.
SHARDED_SERVE = dict(arch="qwen3-8b", batch=4, prompt=4096, gen=32, gloo_layers=2, gloo_gen=2,
                     runs=(("gloo", "1x4"), ("gloo", "2x2"), ("nccl", "1x1")), timeout=400)
SERVE_F32_REL_TOL = 1e-3
# Phase 22 (c): phase 12's step, dry-run and then measured on the card.
DRYRUN_STEP = dict(arch="smollm-135m", batch=8, seq=2048, steps=5)


def serve_child(run_dir: Path, backend: str, rank: int, world: int, shape: str) -> None:
    """One rank of phase 22 (a) (``chip_smoke.py --serve-child DIR BACKEND
    RANK WORLD MESH``): joins the group over a file store in ``run_dir``,
    builds the (data, model) mesh ``AxB``, draws qwen3-8b's seeded
    parameters (whole, on the card), computes the single device's logits for
    its rows (``DecodeEngine``: the prefill's last position, then each
    teacher-forced decode step), takes its slices (the (1, 1) mesh's are the
    whole tensors) and serves its rows with ``sharded_prefill`` and
    ``sharded_decode_step``; the logits gathered over the vocabulary's TP
    slices are held to the single device's: float32 (TF32 off) within
    ``SERVE_F32_REL_TOL`` relative RMS, the last step re-run from the cache
    read one position off failing that gate; bf16 within ``LOGITS_REL_TOL``
    (the NCCL rank), every flash call of its prefill equal to the plain
    version at its operands.  The flash counters are zeroed just before the
    sharded prefill and read after the last step.  Writes
    ``<backend><world>_rank<rank>.json``."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed.sharding import activation_sharding, layout_of, shard_tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill
    from repro_torch.models.model import param_specs

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARDED_SERVE["timeout"]))
    dims = tuple(int(x) for x in shape.split("x"))
    mesh = make_mesh(dims, ("data", "model"))
    layout = layout_of(mesh)
    seed = int((run_dir.parent / "seed").read_text())
    base = configs.get(SHARDED_SERVE["arch"])
    full = backend == "nccl"
    layers = base.num_layers if full else SHARDED_SERVE["gloo_layers"]
    gen = SHARDED_SERVE["gen"] if full else SHARDED_SERVE["gloo_gen"]
    b, p = SHARDED_SERVE["batch"], SHARDED_SERVE["prompt"]
    tokens = np.random.default_rng(seed + 70).integers(0, base.vocab_size, (b, p + gen - 1))
    n = b // dims[0]
    lo = layout.index(("data",)) * n
    prompt = torch.from_numpy(tokens[lo:lo + n, :p].astype(np.int32)).cuda()
    steps = torch.from_numpy(tokens[lo:lo + n, p:].astype(np.int32)).cuda()
    out = {"rank": rank, "backend": backend, "world": world, "mesh": shape,
           "coord": layout.coord, "layers": layers, "gen": gen, "rows": n}

    def whole(logits):   # this rank's rows, the whole vocabulary
        if logits.shape[-1] < base.vocab_size:
            logits = layout.all_gather(logits, -1, "model")
        return logits[:, -1].float()

    for dtype in (("bfloat16",) if full else ("float32", "bfloat16")):
        f32 = dtype == "float32"
        cfg = dataclasses.replace(base, dtype=dtype, num_layers=layers)
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(seed))
        with torch.inference_mode():
            eng = DecodeEngine(model)
            lg, cache = eng.prefill(model, {"tokens": prompt}, max_len=p + gen, last_only=True)
            want = [lg[:, -1].float()]
            for t in range(gen - 1):
                lg, cache = eng.decode_step(model, cache, {"tokens": steps[:, t:t + 1]})
                want.append(lg[:, -1].float())
            del cache, lg, eng
        specs = param_specs(cfg, mesh)
        if full:
            params = model.param_tree()   # a (1, 1) mesh's slices are the whole tensors
        else:
            params = shard_tree(model.param_tree(), specs, mesh)
            del model
        gc.collect()
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        calls: list = []
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        with torch.inference_mode(), activation_sharding(mesh), \
                capture_calls(fa, "flash_attention_cuda", calls):
            t1 = time.perf_counter()
            logits, cache = sharded_prefill(cfg, params, specs, {"tokens": prompt},
                                            max_len=p + gen, last_only=True)
            got = [whole(logits)]
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            step_ms = []
            for t in range(gen - 1):
                t1 = time.perf_counter()
                logits, cache = sharded_decode_step(cfg, params, specs, cache,
                                                    {"tokens": steps[:, t:t + 1]})
                got.append(whole(logits))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            launches = {"flash_attention": fa.flash_attention_cuda.launches,
                        "instances": {k: v for k, v in
                                      fa.flash_attention_cuda.instance_launches.items() if v}}
            peak = torch.cuda.max_memory_allocated()
            errs = [rel_rms(g, w) for g, w in zip(got, want)]
            rec = {"setup_s": setup_s, "prefill_s": prefill_s, "step_ms": step_ms,
                   "peak_gb": peak / 1e9, "launches": launches, "rel_rms": errs,
                   "local_heads": int(calls[0][0][0].shape[2]), "calls": len(calls)}
            if f32:
                # The control: the last step again, from the cache read one
                # position off.
                cache["cur"] = cache["cur"] - 2
                logits, _ = sharded_decode_step(cfg, params, specs, cache,
                                                {"tokens": steps[:, gen - 2:gen - 1]})
                rec["control_rel_rms"] = rel_rms(whole(logits), want[-1])
        if not f32:
            with torch.no_grad():
                rec["calls_max_abs_err"] = max(
                    flash_close(fa.flash_attention_cuda(*a, **kw),
                                ref.flash_attention_ref(*a, **kw),
                                f"rank {rank} prefill call {j}")
                    for j, (a, kw) in enumerate(calls))
        out[dtype] = rec
        del params, cache, calls, got, want
        gc.collect()
        torch.cuda.empty_cache()
    (run_dir / f"{backend}{world}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_sharded_serving(seed: int, run_root: Path) -> tuple[dict, dict]:
    """Phase 22 (a): qwen3-8b served sharded on ``torch.distributed``, each
    run's ranks processes of their own (:func:`serve_child`): (1, 4) TP on 4
    gloo ranks (head-parallel: 8 query and 2 KV heads a rank), (2, 2) on 4
    gloo ranks (rows over ``data``, heads over ``model``), both at
    ``gloo_layers`` layers, and (1, 1) on one NCCL rank at full depth.
    Returns the record and row 9's launches by run and rank."""
    b, p = SHARDED_SERVE["batch"], SHARDED_SERVE["prompt"]
    record: dict = {"arch": SHARDED_SERVE["arch"], "batch": [b, p]}
    launches: dict = {}
    for backend, shape in SHARDED_SERVE["runs"]:
        dims = tuple(int(x) for x in shape.split("x"))
        world = math.prod(dims)
        run_dir = run_root / f"serve_{backend}_{shape}"
        run_dir.mkdir()
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(run_dir, backend, world, flag="--serve-child", extra=(shape,),
                               timeout=SHARDED_SERVE["timeout"])
        wall = time.perf_counter() - t0
        run = f"{backend} x{world} on {dims} data x model"
        r0 = ranks[0]
        layers, gen = r0["layers"], r0["gen"]
        for r in ranks:
            where = f"phase 22 (a), {run}, rank {r['rank']}"
            bad = []
            for dtype, rec in ((k, r[k]) for k in ("float32", "bfloat16") if k in r):
                tol = SERVE_F32_REL_TOL if dtype == "float32" else LOGITS_REL_TOL
                gated = dtype == "float32" or backend == "nccl"
                if gated and (not all(map(math.isfinite, rec["rel_rms"]))
                              or max(rec["rel_rms"]) > tol):
                    bad.append(f"{dtype} logits {rec['rel_rms']} beyond {tol}")
                if "control_rel_rms" in rec and rec["control_rel_rms"] <= tol:
                    bad.append(f"the off-by-one control passed: {rec['control_rel_rms']:.3g}")
                if rec["launches"]["flash_attention"] != layers or rec["calls"] != layers:
                    bad.append(f"{dtype}: {rec['launches']} flash launches, {rec['calls']} "
                               f"calls, expected {layers}")
            if bad:
                raise AssertionError(f"{where}: " + "; ".join(bad))
            launches[f"{where} (bf16 prefill)"] = r["bfloat16"]["launches"]["flash_attention"]
            if "float32" in r:
                launches[f"{where} (float32 prefill)"] = r["float32"]["launches"][
                    "flash_attention"]
        rb = r0["bfloat16"]
        med = statistics.median(rb["step_ms"])
        record[run] = {"wall_s": wall, "layers": layers, "gen": gen, "ranks": ranks}
        f32 = (f"; float32 logits within {max(max(r['float32']['rel_rms']) for r in ranks):.3g} "
               f"relative RMS of the single device's on every rank (gate {SERVE_F32_REL_TOL}), "
               f"the off-by-one control "
               f"{min(r['float32']['control_rel_rms'] for r in ranks):.3g} failing it"
               if "float32" in r0 else "")
        log(f"phase 22 (a), {run} ({wall:.1f} s with start-up; {layers} layers, {b} x {p:,} "
            f"prompt tokens, {gen - 1} decode step(s)): bf16 prefill {rb['prefill_s']:.3f} s, "
            f"decode {med:.2f} ms a step (median); bf16 logits within "
            f"{max(max(r['bfloat16']['rel_rms']) for r in ranks):.4f} relative RMS of the single "
            f"device's{' (gate ' + str(LOGITS_REL_TOL) + ')' if backend == 'nccl' else ''}"
            f"{f32}; flash launches a rank {rb['launches']['flash_attention']} "
            f"({rb['local_heads']} heads a call), each call within its gate (max |err| "
            f"{max(r['bfloat16']['calls_max_abs_err'] for r in ranks):.3g}); peak a rank "
            f"{max(r['bfloat16']['peak_gb'] for r in ranks):.2f} GB bf16"
            + (f", {max(r['float32']['peak_gb'] for r in ranks):.2f} GB float32"
               if "float32" in r0 else "") + f"  [{smi_line()}]")
    return record, {"flash_attention": launches}


def dryrun_child(run_dir: Path, part: str) -> None:
    """Phase 22 (c) (``chip_smoke.py --dryrun-child DIR PART``): phase 12's
    step (smollm-135m, ``DRYRUN_STEP``'s batch, bf16, AdamW).  ``trace``:
    dry-run on a (1, 1) mesh of a fake group (``launch.dryrun.trace_cell``),
    written to ``dryrun_trace.json``; ``card``: run on the card through
    ``sharded_train_step`` on a (1, 1) mesh of one gloo rank, the state's
    bytes, the peak over the steps and the step times written to
    ``dryrun_card.json``."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec, demo_batch
    from repro_torch.launch import cost, dryrun, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.model import active_param_count
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.step import sharded_state, sharded_train_step
    from repro_torch.train.tree import leaves

    cfg = configs.get(DRYRUN_STEP["arch"])
    b, s = DRYRUN_STEP["batch"], DRYRUN_STEP["seq"]
    if part == "trace":
        sp = ShapeSpec("phase12", s, b, "train")
        cost.fake_world(1)
        measured = dryrun.trace_cell(cfg, sp, make_mesh((1, 1), ("data", "model"),
                                                        device_type="cpu"))
        rl = roofline.compute_roofline(
            arch=cfg.name, shape=sp.name, mesh_name="1x1", n_devices=1, costs=measured.costs,
            model_flops=roofline.model_flops_for(cfg, sp, active_param_count(cfg)))
        (run_dir / "dryrun_trace.json").write_text(json.dumps({
            "memory": measured.memory, "flops": measured.costs.flops,
            "hbm_bytes": measured.costs.hbm_bytes, "roofline": rl.as_dict(),
            "trace_s": measured.seconds}))
        dist.destroy_process_group()
        return
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{run_dir}/store_dryrun", rank=0,
                            world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    seed = int((run_dir / "seed").read_text())
    model = Model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    opt = OptimizerConfig(learning_rate=3e-3, warmup_steps=0, decay_steps=10)
    step, _, _ = sharded_train_step(model, opt, mesh)
    state = sharded_state(model, opt, mesh)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = sum(t.numel() * t.element_size()
                      for part_ in ("params", "opt") for t in leaves(state[part_]))
    batch = demo_batch(cfg, b, s, np.random.default_rng(seed), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DRYRUN_STEP["steps"]):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    (run_dir / "dryrun_card.json").write_text(json.dumps({
        "state_bytes": state_bytes, "peak_bytes": torch.cuda.max_memory_allocated(),
        "step_ms": ms, "loss": float(metrics["loss"])}))
    dist.destroy_process_group()


def _wait_child(proc, log_file, timeout: float, what: str) -> None:
    """Wait for a phase 22 subprocess; a failure or a timeout raises with
    the tail of its log."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             + Path(log_file.name).read_text()[-3000:])


def phase_sharded_serving_and_dryrun(seed: int) -> tuple[dict, dict, dict]:
    """Phase 22: sharded serving (a, :func:`phase_sharded_serving`) and the
    launch tooling: (b) the dry run's cells on this machine, each in its own
    subprocess (``python -m repro_torch.launch.dryrun``: smollm-135m x
    train_4k and qwen3-8b x decode_32k at the 256-rank mesh, and
    bitmap-join x join_1m, whose one rank's 256 ring hops run row 1 on the
    card), and (c) the dry run against the card (:func:`dryrun_child`: the
    trace, then the step on the card).  (b) and (c)'s trace start with the
    phase and run beside (a); (c)'s card part runs alone after (a).
    Returns (a)'s record, (b) and (c)'s, and row 9's launches."""
    import os
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.shapes import input_specs

    t_phase = time.perf_counter()
    log(smi_line())
    run_root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get(
        "PYTHONPATH")])), OMP_NUM_THREADS="1")
    tooling: dict = {}
    procs: list = []
    try:
        (run_root / "seed").write_text(str(seed))
        out_dir = run_root / "dryrun"

        def start(name: str, cmd: list):
            f = open(run_root / f"{name}.log", "w")
            procs.append((name, f, subprocess.Popen(cmd, env=env, stdout=f,
                                                    stderr=subprocess.STDOUT)))

        cells = [("smollm-135m", "train_4k"), ("qwen3-8b", "decode_32k"),
                 ("bitmap-join", "join_1m")]
        for arch, shape in cells:
            start(f"dryrun {arch} x {shape}",
                  [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", "single", "--out", str(out_dir)])
        start("dryrun phase 12 trace", [sys.executable, str(Path(__file__).resolve()),
                                        "--dryrun-child", str(run_root), "trace"])
        serving, launches = phase_sharded_serving(seed, run_root)
        while procs:
            name, f, proc = procs.pop(0)
            _wait_child(proc, f, 300, f"phase 22 {name}")
        for arch, shape in cells:
            rec = json.loads((out_dir / f"{arch}__{shape}__single.json").read_text())
            if not rec.get("ok") or "skipped" in rec:
                raise AssertionError(f"dry run of {arch} x {shape}: {rec}")
            rl, mem = rec["roofline"], rec["memory"]
            tooling[f"{arch} x {shape}"] = rec
            if arch == "bitmap-join":
                extra = (f"; the ring's {rec['hops']} hops on {rec['device']} "
                         f"({rec['shard_rows']:,} rows a shard) in {rec['trace_seconds']:.2f} s, "
                         f"row 1 launched {rec['row1_launches']} times, "
                         f"{rec['candidates']:,} candidates, {rec['verified']:,} verified")
            else:
                extra = "; inputs " + json.dumps(
                    {k: list(v.shape) for k, v in input_specs(configs.get(arch), shape).items()})
            log(f"phase 22 (b), dry run {arch} x {shape} at the (16, 16) mesh of 256 ranks "
                f"(traced in {rec['trace_seconds']:.1f} s): a rank's flops "
                f"{rl['flops_per_device']:.4g}, HBM bytes {rl['hbm_bytes_per_device']:.4g}, "
                f"collective bytes {rl['collective_bytes_per_device']:.4g}; on the H100 SXM's "
                f"peaks t_compute {rl['t_compute'] * 1e3:.3f} ms, t_memory "
                f"{rl['t_memory'] * 1e3:.3f} ms, t_collective {rl['t_collective'] * 1e3:.3f} ms "
                f"(bound {rl['step_time_bound'] * 1e3:.3f} ms, {rl['bottleneck']}), useful "
                f"{rl['useful_ratio']:.3f}, roofline fraction {rl['roofline_fraction']:.3f}; "
                f"arguments {mem['argument_size_in_bytes'] / 1e9:.4f} GB a rank{extra}")

        # (c) phase 12's step: the dry run's prediction against the card.
        t0 = time.perf_counter()
        start("dryrun phase 12 on the card", [sys.executable, str(Path(__file__).resolve()),
                                              "--dryrun-child", str(run_root), "card"])
        name, f, proc = procs.pop(0)
        _wait_child(proc, f, 300, f"phase 22 {name}")
        pred = json.loads((run_root / "dryrun_trace.json").read_text())
        meas = json.loads((run_root / "dryrun_card.json").read_text())
        state_pred = pred["memory"]["argument_bytes_each"][0] - 4   # the state less its step
        if state_pred != meas["state_bytes"]:
            raise AssertionError(f"phase 22 (c): predicted state bytes {state_pred} != measured "
                                 f"{meas['state_bytes']}")
        med = statistics.median(meas["step_ms"][2:])
        bound = pred["roofline"]["step_time_bound"] * 1e3
        flops_frac = pred["flops"] / (med / 1e3) / PEAK_BF16_TENSOR_OPS_PER_S
        bytes_frac = pred["hbm_bytes"] / (med / 1e3) / PEAK_BYTES_PER_S
        tooling["phase12_step"] = {"predicted": pred, "measured": meas, "step_ms": med,
                                   "flops_frac": flops_frac, "bytes_frac": bytes_frac,
                                   "card_s": time.perf_counter() - t0}
        log(f"phase 22 (c), phase 12's step ({DRYRUN_STEP['arch']}, {DRYRUN_STEP['batch']} x "
            f"{DRYRUN_STEP['seq']:,} tokens, bf16, AdamW) on a (1, 1) mesh: predicted parameters "
            f"and AdamW state {state_pred / 1e9:.4f} GB = measured {meas['state_bytes'] / 1e9:.4f} "
            f"GB ({meas['state_bytes']:,} bytes, exact); peak predicted "
            f"{pred['memory']['peak_bytes'] / 1e9:.3f} GB, measured "
            f"{meas['peak_bytes'] / 1e9:.3f} GB (torch.cuda.max_memory_allocated), ratio "
            f"{pred['memory']['peak_bytes'] / meas['peak_bytes']:.3f}; step-time bound "
            f"{bound:.3f} ms ({pred['roofline']['bottleneck']}: flops {pred['flops']:.4g}, "
            f"bytes {pred['hbm_bytes']:.4g}) beside the measured step {med:.1f} ms (median of "
            f"steps 3-{DRYRUN_STEP['steps']}; ratio {med / bound:.2f}); the measured step's "
            f"flops_frac {flops_frac:.4f}, bytes_frac {bytes_frac:.4f}; loss "
            f"{meas['loss']:.4f}  [{smi_line()}]")
    finally:
        for _, f, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
        shutil.rmtree(run_root, ignore_errors=True)
    tooling["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22: {tooling['phase_s']:.1f} s; NCCL with more than one rank is not exercised "
        f"(one card): the gloo ranks share it through host copies")
    return serving, tooling, launches


# ---------------------------------------------------------------------------
# Phase 23: the query offset on the card; the moe, vlm and audio families
# over a mesh
# ---------------------------------------------------------------------------

# (a) smollm-135m's layer (B, S, H, KV, D) with its q sequence split in
# ``parts`` (phase 21's (1, 4) slices), and at D = 112 and 128 one slice of
# (B, Sk, H, KV) whose offset and length are no multiple of a tile.
OFFSET = dict(layer=(8, 2048, 9, 3, 64), parts=4,
              odd=dict(b=2, sk=1024, heads=8, kv=2, offset=333, rows=200, dims=(112, 128)))


def offset_grads_close(got: tuple, want: tuple, what: str) -> float:
    """Gradients against another computation of them, by type: float32
    within FLASH_TOL elementwise (the largest |err|), bf16 within the
    gradient gate (the largest relative RMS).  Returns that error."""
    if want[0].dtype == torch.float32:
        tol = FLASH_TOL[torch.float32]
        err = max(max_err_float(a, w) for a, w in zip(got, want))
        if not all(torch.allclose(a, w, rtol=tol, atol=tol) for a, w in zip(got, want)):
            raise AssertionError(f"{what}: max |err| {err:.3g} (tolerance {tol})")
        return err
    return bwd_close(got, want, what)


def offset_slice_check(qs, k, v, ds, q_offset: int, what: str) -> tuple:
    """Both kernels on one q slice at ``q_offset`` against their plain
    versions: the output within FLASH_TOL, lse within LSE_TOL, dq, dk, dv
    by :func:`offset_grads_close`.  Returns (out, lse, (dq, dk, dv),
    {errors})."""
    from repro_torch.kernels import flash_attention as fa

    o, lse = fa.flash_attention_cuda(qs, k, v, q_offset=q_offset, return_lse=True)
    want_o, want_lse = plain_flash(qs, k, v, causal=True, q_offset=q_offset, return_lse=True)
    errs = {"fwd_max_abs_err": flash_close(o, want_o, what),
            "lse_max_abs_err": lse_close(lse, want_lse, what)}
    g = fa.flash_attention_bwd_cuda(qs, k, v, o, lse, ds, q_offset=q_offset)
    errs["bwd_err"] = offset_grads_close(
        g, plain_flash_bwd(qs, k, v, o, lse, ds, causal=True, q_offset=q_offset),
        f"flash backward != plain version at {what}")
    return o, lse, g, errs


def phase_flash_offset(seed: int) -> dict:
    """Phase 23 (a): both flash kernels with a query offset on the card, bf16
    and float32.  smollm-135m's layer split in OFFSET["parts"] q slices
    (offsets 0, 512, 1,024, 1,536): each slice against its plain versions,
    its output and dq equal to those rows of one causal call on the whole q,
    its dk and dv summing with the others' to the whole call's; each timed
    in turns with the whole call (slice, whole, whole, slice; its share of
    the whole is the whole's time over the share of (q, k) pairs its rows
    hold), beside its plain versions, bound and scaled_dot_product_attention
    with the slice's mask; the last slice given offset 0 (the control) must
    fail its plain version's gate.  Then D = 112 and 128 at offset 333,
    200 rows.  These launches compare kernels with their plain versions: no
    path's launch count includes them.  Returns the record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 230)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, h, kv, d = OFFSET["layer"]
    n = s // OFFSET["parts"]
    record: dict = {"layer": [b, s, h, kv, d], "parts": OFFSET["parts"]}

    def sdpa_masked(qs, k, v, q_offset):   # the library's call with the slice's mask
        mask = (torch.arange(qs.shape[1], device=dev)[:, None] + q_offset
                >= torch.arange(k.shape[1], device=dev)[None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (qs, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "float32"
        q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        whole = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
        total_pairs = sum(min(i + 1, s) for i in range(s))
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros_like(dk)
        slices = []
        for r0 in range(0, s, n):
            qs, ds = q[:, r0:r0 + n].contiguous(), do[:, r0:r0 + n].contiguous()
            what = (f"B={b} rows {r0}-{r0 + n - 1} of S={s} (q_offset {r0}) H={h} KV={kv} "
                    f"D={d} {name} causal")
            o, sl, g, errs = offset_slice_check(qs, k, v, ds, r0, what)
            errs["rows_of_whole_max_abs_err"] = flash_close(o, out[:, r0:r0 + n].contiguous(),
                                                            what + " against the whole call")
            errs["dq_of_whole"] = offset_grads_close(
                (g[0],), (whole[0][:, r0:r0 + n].contiguous(),), what + ": dq against the whole")
            dk += g[1].float()
            dv += g[2].float()
            fwd = in_turns({"slice": lambda qs=qs, r0=r0: fa.flash_attention_cuda(
                qs, k, v, q_offset=r0), "whole": lambda: fa.flash_attention_cuda(q, k, v)},
                iters=20)
            bwd = in_turns({"slice": lambda qs=qs, ds=ds, o=o, sl=sl, r0=r0:
                            fa.flash_attention_bwd_cuda(qs, k, v, o, sl, ds, q_offset=r0),
                            "whole": lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)},
                           iters=10)
            plain = cuda_ms(lambda qs=qs, r0=r0: plain_flash(qs, k, v, causal=True, q_offset=r0), 2)
            plain_bwd = cuda_ms(lambda qs=qs, ds=ds, o=o, sl=sl, r0=r0: plain_flash_bwd(
                qs, k, v, o, sl, ds, causal=True, q_offset=r0), 1)
            lib = cuda_ms(sdpa_masked(qs, k, v, r0), 20)
            flops, _, bound, term = flash_bound(qs, k, q_offset=r0)
            bflops, _, bbound, bterm = flash_bound(qs, k, backward=True, q_offset=r0)
            share = sum(min(r0 + i + 1, s) for i in range(n)) / total_pairs
            rec = {"q_offset": r0, "rows": n, "pairs_share": share, "ms_turns": fwd["slice"],
                   "whole_ms_turns": fwd["whole"], "bwd_ms_turns": bwd["slice"],
                   "whole_bwd_ms_turns": bwd["whole"], "plain_ms": plain,
                   "plain_bwd_ms": plain_bwd, "library_ms": lib, "bound_ms": bound[0],
                   "bound_by": bound[1], "bound_term": term, "bwd_bound_ms": bbound[0],
                   "bwd_bound_by": bbound[1], "gflop": flops / 1e9, "bwd_gflop": bflops / 1e9,
                   **errs}
            slices.append(rec)
            log(f"phase 23 (a) {what}: forward max |err| {errs['fwd_max_abs_err']:.3g}, lse "
                f"{errs['lse_max_abs_err']:.3g}, backward "
                + ("max |err|" if dtype == torch.float32 else "relative RMS")
                + f" {errs['bwd_err']:.4g} against the plain versions; output and dq those "
                f"rows of the whole call's "
                f"(max |err| {errs['rows_of_whole_max_abs_err']:.3g}, {errs['dq_of_whole']:.3g}); "
                f"device ms in turns: forward {fwd['slice'][0]:.4f} / {fwd['slice'][1]:.4f} "
                f"(whole {fwd['whole'][0]:.4f} / {fwd['whole'][1]:.4f}, its share of the pairs "
                f"{share:.3f}: {share * fwd['whole'][0]:.4f}), backward {bwd['slice'][0]:.4f} / "
                f"{bwd['slice'][1]:.4f} (whole {bwd['whole'][0]:.4f} / {bwd['whole'][1]:.4f}: "
                f"{share * bwd['whole'][0]:.4f}); bounds {bound[0]:.4f} ms ({term}) and "
                f"{bbound[0]:.4f} ({bterm}); plain {plain:.3f} / {plain_bwd:.3f} ms; SDPA with "
                f"the slice's mask {lib:.4f}  [{smi_line()}]")
        sum_err = offset_grads_close((dk.to(dtype), dv.to(dtype)), whole[1:],
                                     f"{name} slices' dk, dv summed against the whole call's")
        # The control: the last slice at offset 0 must miss its plain version.
        r0 = s - n
        bad = fa.flash_attention_cuda(q[:, r0:].contiguous(), k, v, q_offset=0)
        want = plain_flash(q[:, r0:].contiguous(), k, v, causal=True, q_offset=r0)
        try:
            flash_close(bad, want, "the control")
            raise AssertionError(f"phase 23 (a) {name}: the last slice at offset 0 passed")
        except AssertionError as exc:
            if "passed" in str(exc):
                raise
        control = max_err_float(bad, want)
        record[name] = {"slices": slices, "dkdv_sum_err": sum_err, "control_max_abs_err": control,
                        "whole_fwd_ms": statistics.median(r["whole_ms_turns"][0] for r in slices),
                        "whole_bwd_ms": statistics.median(r["whole_bwd_ms_turns"][0]
                                                          for r in slices)}
        fwd_sum = sum(r["ms_turns"][0] for r in slices)
        log(f"phase 23 (a) {name}: the {len(slices)} slices' dk and dv sum to the whole call's "
            f"(max error {sum_err:.3g}); offset 0's slice {slices[0]['ms_turns'][0]:.4f} ms "
            f"beside row 9's whole layer {record[name]['whole_fwd_ms']:.4f} ms; the slices' "
            f"forwards {fwd_sum:.4f} ms together; the control (the last slice at offset 0) "
            f"misses its plain version by {control:.3g}")
        del q, k, v, do, out, lse, whole, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
    odd = OFFSET["odd"]
    record["odd"] = {}
    for d in odd["dims"]:
        for dtype in (torch.bfloat16, torch.float32):
            r0, n = odd["offset"], odd["rows"]
            q, do = (torch.randn((odd["b"], n, odd["heads"], d), generator=gen,
                                 device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((odd["b"], odd["sk"], odd["kv"], d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            what = (f"B={odd['b']} {n} rows at q_offset {r0} of Sk={odd['sk']} "
                    f"H={odd['heads']} KV={odd['kv']} D={d} {dtype} causal")
            o, sl, _, errs = offset_slice_check(q, k, v, do, r0, what)
            errs["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, q_offset=r0), 20)
            errs["bwd_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, sl, do,
                                                                        q_offset=r0), 10)
            record["odd"][what] = errs
            log(f"phase 23 (a) {what}: within the gates of rows 9 and 9d ({json.dumps(errs)})")
            del q, k, v, do, o, sl
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 23 (a): {record['phase_s']:.1f} s")
    return record


# (c) The families at their published widths over a mesh: 4 gloo ranks
# sharing the card on (1, 4) (experts, heads, the MLP's hidden dim and the
# vocabulary over "model": no FSDP gather crosses the host), then one NCCL
# rank on (1, 1).  Depth is cut where the card's 80 GB force it: the 4 ranks
# hold one model's slices together with each rank drawing its leaves whole,
# and the single-device float32 references (16 bytes a parameter when
# training) run on the same card first: phi3.5-moe trains at 2 layers
# (2.86e9 parameters) and serves at 4 (5.5e9), the vision model at one group
# (4 self layers and its cross layer), musicgen uncut; arctic (14.07e9 at 1
# layer) only on the NCCL rank, whose reference is the model it serves.
FAMILY_MESH = dict(
    train=(("phi3.5-moe-42b-a6.6b", 2), ("llama-3.2-vision-11b", 5)),
    serve=(("phi3.5-moe-42b-a6.6b", 4), ("llama-3.2-vision-11b", 5), ("musicgen-medium", None)),
    nccl_serve=(("phi3.5-moe-42b-a6.6b", 4), ("llama-3.2-vision-11b", 5),
                ("musicgen-medium", None), ("arctic-480b", 1)),
    train_batch=(2, 512), serve_batch=(4, 256), gen=2, lr=3e-3,
    runs=(("gloo", "1x4"), ("nccl", "1x1")), timeout=480)
FAMILY_MESH_PARAM_REL_RMS = 1e-2


def flat_specs(specs: dict, prefix: str = "") -> dict:
    """``{dotted name: spec}`` of a nested spec tree."""
    out = {}
    for key, val in specs.items():
        if isinstance(val, dict):
            out.update(flat_specs(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def seeded_leaves(cfg, seed: int):
    """:func:`family_model`'s parameters one leaf at a time, ``(dotted name,
    whole tensor on the card)``: drawn in ``Model``'s order from the same
    seeded generator, the vision model's gates as :func:`vision_gates` sets
    them, so no more than one leaf is held here."""
    from repro_torch.models.model import dtype_of, param_layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    for name, (shape, init) in param_layout(cfg).items():
        if init == "ones":
            t = torch.ones(shape, dtype=pdt, device=dev)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=pdt, device=dev)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev).mul_(init ** -0.5).to(pdt)
        yield name, vision_gates(t, seed) if name == "cross_blocks.gate" else t


def seeded_slices(cfg, seed: int, specs: dict, layout) -> dict:
    """This rank's slices of :func:`family_model`'s parameters without the
    whole model: each leaf of :func:`seeded_leaves` sliced by its spec and
    freed.  The ranks sharing the card draw in turns, so one whole leaf at a
    time is held beside their slices (a collective: every rank calls it)."""
    import torch.distributed as dist

    from repro_torch.models.model import nest

    by_name = flat_specs(specs)
    rank = dist.get_rank()
    for turn in range(dist.get_world_size()):
        if turn == rank:
            out = [(name, t[layout.slices(t.shape, by_name[name])].clone())
                   for name, t in seeded_leaves(cfg, seed)]
            torch.cuda.empty_cache()
        dist.barrier()
    return nest(out)


def family_serve_inputs(cfg, seed: int, plan: dict = FAMILY_MESH) -> tuple:
    """Phase 23's (or ``plan``'s: phase 24's) serving inputs, the same on the
    parent and every rank: (prefill batch, decode-step batches), all rows,
    on the card: seeded prompt tokens (musicgen: frame embeddings, one a
    step), the vision model's image embeddings."""
    b, p = plan["serve_batch"]
    gen = plan["gen"]
    rng = np.random.default_rng(seed + 232)
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    if cfg.frame_inputs:
        frames = cuda(rng.normal(size=(b, p + gen - 1, cfg.d_model)).astype(np.float32))
        prefill = {"frame_embeds": frames[:, :p]}
        steps = [{"frame_embeds": frames[:, p + t:p + t + 1]} for t in range(gen - 1)]
    else:
        toks = cuda(rng.integers(0, cfg.vocab_size, (b, p + gen - 1)).astype(np.int32))
        prefill = {"tokens": toks[:, :p]}
        steps = [{"tokens": toks[:, p + t:p + t + 1]} for t in range(gen - 1)]
    if cfg.family == "vlm":
        prefill["image_embeds"] = cuda(rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    return prefill, steps


def family_train_batch(cfg, seed: int, mesh=None, plan: dict = FAMILY_MESH) -> dict:
    """Phase 23's (or ``plan``'s) training batch (the loader's, seeded): all
    rows, or this rank's over ``mesh``."""
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader

    b, s = plan["train_batch"]
    kw = {"mesh": mesh, "batch_axes": ("data",)} if mesh is not None else {}
    return next(SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed + 231,
                                                    vocab_size=cfg.vocab_size),
                                  device="cuda", **kw))


def family_mesh_references(seed: int, ref_dir: Path, plan: dict = FAMILY_MESH) -> dict:
    """Phase 23 (c)'s single-device float32 references (TF32 off), each
    model freed before the next: for each trained family one AdamW step
    (``make_train_step``) whose update (parameters after less before) goes
    to ``ref_dir`` a leaf a file in float16 (the first step's update is
    about the learning rate on every element), with its loss and
    ``moe_dropped``; for each served family the teacher-forced logits of
    the prefill's last position and each decode step (``DecodeEngine``).
    Returns the references' walls.  ``plan``: the phase's constants
    (FAMILY_MESH, or phase 24's SSM_MESH)."""
    from repro_torch.models import DecodeEngine
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    from repro_torch.train.tree import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}
    for arch, layers in plan["train"]:
        t0 = time.perf_counter()
        cfg, model = family_model(arch, layers, seed, "float32")
        opt = OptimizerConfig(learning_rate=plan["lr"], warmup_steps=0, decay_steps=10)
        state = init_state(model, opt)
        state, metrics = make_train_step(model, opt)(state, family_train_batch(cfg, seed,
                                                                                plan=plan))
        out = ref_dir / f"train_{arch}"
        out.mkdir()
        after = {".".join(path): p for path, p in leaves_with_paths(state["params"])}
        # The update against the initial parameters drawn again from the seed.
        for name, p0 in seeded_leaves(cfg, seed):
            torch.save((after[name].detach() - p0).half().cpu(), out / f"{name}.pt")
            del p0
        (out / "metrics.json").write_text(json.dumps(
            {"loss": float(metrics["loss"]), "moe_dropped": float(metrics.get("moe_dropped", -1))}))
        del model, state, after, metrics
        gc.collect()
        torch.cuda.empty_cache()
        walls[f"train {arch}"] = time.perf_counter() - t0
    for arch, layers in plan["serve"]:
        t0 = time.perf_counter()
        moe = family_config(arch, layers).family == "moe"
        routes: dict = {}
        # The moe family in bf16 too: its logits and every routing in both
        # types, for the mesh's bf16 routing against the single device's.
        for dtype in ("float32", "bfloat16") if moe else ("float32",):
            cfg, model = family_model(arch, layers, seed, dtype)
            prefill, steps = family_serve_inputs(cfg, seed, plan)
            eng = DecodeEngine(model)
            p = plan["serve_batch"][1]
            calls: list = []
            with torch.inference_mode(), capture_routes(calls):
                lg, cache = eng.prefill(model, prefill, max_len=p + plan["gen"],
                                        last_only=True)
                want = [lg[:, -1].float().cpu()]
                for batch in steps:
                    lg, cache = eng.decode_step(model, cache, batch)
                    want.append(lg[:, -1].float().cpu())
            if dtype == "float32":
                torch.save(want, ref_dir / f"serve_{arch}.pt")
            else:
                routes["bf16_logits"] = want
            routes[dtype] = [(c.cpu(), kp.cpu()) for c, kp in calls]
            del model, eng, cache, lg, prefill, steps, calls
            gc.collect()
            torch.cuda.empty_cache()
        if moe:
            torch.save(routes, ref_dir / f"routes_{arch}.pt")
        walls[f"serve {arch}"] = time.perf_counter() - t0
    return walls


@contextlib.contextmanager
def capture_routes(into: list):
    """Every moe routing's (choice, keep) (``models/moe.py::route``, the one
    copy that the single device and every expert-parallel rank run) in
    ``into``, in call order, while inside."""
    from repro_torch.models import moe

    saved = moe.route

    def recording(*args, **kw):
        r = saved(*args, **kw)
        into.append((r.choice, r.keep))
        return r

    moe.route = recording
    try:
        yield
    finally:
        moe.route = saved


def routes_alike_over_tp(routes: list, layout) -> dict:
    """Whether every TP rank made the same routing decisions: a checksum
    (CRC-32) of each routing's choices and keeps, all-gathered over
    ``"model"`` and compared (a collective: every rank calls it).  Expert
    parallelism sums each rank's experts' kept choices, so a routing that
    differs by one choice between ranks runs some choices twice and others
    never.  Returns {"calls", "tp_equal", "crc"}."""
    import zlib

    crc = [zlib.crc32(c.cpu().numpy().tobytes() + k.cpu().numpy().tobytes()) for c, k in routes]
    every = layout.all_gather(torch.tensor(crc, dtype=torch.int64, device="cuda")[None], 0,
                              "model").cpu()
    return {"calls": len(crc), "tp_equal": bool((every == every[0]).all()), "crc": crc}


def routing_flips(got: list, want: list, num_experts: int, k: int) -> list:
    """Each routing call's share of tokens whose top-k expert set differs
    from ``want``'s, and whose kept set does (choices within capacity):
    [(chosen, kept), ...]."""
    out = []
    for (c, kp), (wc, wkp) in zip(got, want):
        def sets(choice, keep):
            choice, keep = choice.cpu().long(), keep.cpu()
            g, tk = choice.shape
            chosen = torch.zeros((g, tk // k, num_experts), dtype=torch.bool)
            kept = torch.zeros_like(chosen)
            idx = choice.reshape(g, tk // k, k)
            chosen.scatter_(-1, idx, True)
            kept.scatter_(-1, idx, keep.reshape(g, tk // k, k))
            return chosen, kept
        (a, ka), (b, kb) = sets(c, kp), sets(wc, wkp)
        out.append((float((a != b).any(-1).float().mean()), float((ka != kb).any(-1).float().mean())))
    return out


def mesh_train_family(arch: str, layers, seed: int, mesh, layout, ref_dir: Path, *,
                      plan: dict = FAMILY_MESH, bf16: bool = True, before=None) -> dict:
    """One trained family on a gloo rank of phase 23 (c) (or 24 (a), by
    ``plan``): this rank's seeded slices (:func:`seeded_slices`), one
    float32 ``sharded_train_step`` (TF32 off) whose update is held to the
    single device's leaf by leaf (RMS difference over the RMS update,
    FAMILY_MESH_PARAM_REL_RMS), its loss (SHARDED_LOSS_RTOL) and
    ``moe_dropped`` (equal); then (``bf16``) one bf16 step from the updated
    slices, timed, every flash kernel call held to its plain version at its
    operands.  The launch counters are zeroed just before each step and
    read just after.  ``before(cfg, params, specs, batch)``, when given,
    runs on the float32 slices before the step and its dict joins the
    record (phase 24's gated-norm control)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.model import param_specs
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.optimizer import opt_init
    from repro_torch.train.step import sharded_train_step
    from repro_torch.train.tree import leaves_with_paths

    cfg = family_config(arch, layers, "float32")
    specs = param_specs(cfg, mesh)
    by_name = flat_specs(specs)
    t0 = time.perf_counter()
    params = seeded_slices(cfg, seed, specs, layout)
    named = leaves_with_paths(params)
    for _, p in named:
        p.requires_grad_(True)
    # On the host: the 4 ranks share the card's 80 GB.
    initial = [p.detach().to("cpu", copy=True) for _, p in named]
    opt = OptimizerConfig(learning_rate=plan["lr"], warmup_steps=0, decay_steps=10)
    rec: dict = {"setup_s": time.perf_counter() - t0,
                 "param_bytes": sum(p.numel() * p.element_size() for _, p in named)}
    for dtype in ("float32", "bfloat16") if bf16 else ("float32",):
        c = family_config(arch, layers, dtype)
        step, _, _ = sharded_train_step(c, opt, mesh)
        state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"), "params": params,
                 "opt": opt_init(opt, params)}
        batch = family_train_batch(c, seed, mesh, plan)
        if before is not None and dtype == "float32":
            rec.update(before(c, params, specs, batch))
        fwd_calls, bwd_calls, routes = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t1 = time.perf_counter()
        with capture_calls(fa, "flash_attention_cuda", fwd_calls) if dtype != "float32" else \
                contextlib.nullcontext(), capture_calls(fa, "flash_attention_bwd_cuda",
                                                        bwd_calls) if dtype != "float32" else \
                contextlib.nullcontext(), capture_routes(routes):
            state, metrics = step(state, batch)
            launches = [fa.flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches]
        torch.cuda.synchronize()
        r = {"step_ms": (time.perf_counter() - t1) * 1e3, "loss": float(metrics["loss"]),
             "moe_dropped": float(metrics.get("moe_dropped", -1.0)),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if cfg.family == "moe":   # every routing of the step (its remat replays too)
            r["routing"] = routes_alike_over_tp(routes, layout)
        del routes
        if dtype == "float32":
            r["launches"] = launches
            want = json.loads((ref_dir / "metrics.json").read_text())
            r["ref"] = want
            floor = plan.get("sign_floor")
            # AdamW's first step moves an element by lr·sign(g), so where |g|
            # is within the step's numerical noise of 0 its update's sign is
            # not defined.  With ``sign_floor``, an element whose update and
            # the single device's differ by more than the update itself (a
            # flipped sign) while this rank's |first moment| is under
            # sign_floor × its slice's RMS leaves the gate and is counted.
            small = scale = None
            if floor:
                small, scale = [], []
                for _, mu in leaves_with_paths(state["opt"]["mu"]):
                    a = mu.abs()
                    rms = a.square().mean().sqrt()
                    small.append(a < floor * rms)
                    scale.append(a / rms)   # |g| over its slice's RMS, for the record
                    del a
            del state, metrics   # the moments, before the gate's temporaries
            ratios, every, excused = [], [], []

            def ratio(num, den):
                return math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf)

            for k, ((path, p), p0) in enumerate(zip(named, initial)):
                name = ".".join(path)
                upd = torch.load(ref_dir / f"{name}.pt", mmap=True)
                upd = upd[layout.slices(upd.shape, by_name[name])]
                # Sums of squares over blocks of rows (about 2^26 elements).
                num = den = num_all = den_all = 0.0
                out = flips = 0
                worst = 0.0   # the largest |g| / RMS of a flipped element
                rows = max(1, 2 ** 26 // max(1, p[0].numel())) if p.dim() else 1
                for i in range(0, max(1, p.shape[0] if p.dim() else 1), rows):
                    at = slice(i, i + rows) if p.dim() else ...
                    u = upd[at].to("cuda", torch.float32)
                    mine = p.detach()[at] - p0[at].to("cuda")
                    u2, d2 = u.double().square(), (mine - u).double().square()
                    den_all += float(u2.sum())
                    num_all += float(d2.sum())
                    if small is not None:
                        flip = d2 > u2
                        m = ~(small[k][at] & flip)
                        den += float(u2[m].sum())
                        num += float(d2[m].sum())
                        out += int((~m).sum())
                        flips += int(flip.sum())
                        if flip.any():
                            worst = max(worst, float(scale[k][at][flip].max()))
                    del u, mine, u2, d2
                every.append((ratio(num_all, den_all), name))
                ratios.append((ratio(num, den), name) if small is not None else every[-1])
                excused.append((out, flips, worst, p.numel(), name))
            r["param_gate"] = max(ratios)
            r["param_gate_every_element"] = max(every)
            # (excused, flipped, the largest flipped |g| / RMS, size, leaf)
            r["sign_flips"] = [e for e in excused if e[1]]
            del small, scale
            state = metrics = None
        else:
            r["launches"] = launches   # the capturing wrappers' counts
            with torch.no_grad():
                r["fwd_calls_max_abs_err"] = max(
                    flash_close(fa.flash_attention_cuda(*a, **kw)[0],
                                plain_flash(*a, **kw)[0], f"{arch} step forward call {j}")
                    for j, (a, kw) in enumerate(fwd_calls))
                r["bwd_calls_rel_rms"] = max(
                    bwd_close(fa.flash_attention_bwd_cuda(*a, **kw), plain_flash_bwd(*a, **kw),
                              f"{arch} step backward call {j}")
                    for j, (a, kw) in enumerate(bwd_calls))
        rec[dtype] = r
        del state, metrics, batch, fwd_calls, bwd_calls
        gc.collect()
        torch.cuda.empty_cache()
    del params, named, initial
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_serve_family(arch: str, layers, seed: int, mesh, layout, ref_file: Path) -> dict:
    """One served family on a gloo rank of phase 23 (c): its seeded slices,
    ``sharded_prefill`` and teacher-forced ``sharded_decode_step`` calls in
    float32 (TF32 off), the logits gathered over the vocabulary's TP slices
    held to the single device's within SERVE_F32_REL_TOL relative RMS; the
    controls failing that gate: the last step again from the cache read one
    position off, and (the moe family) the prefill with layer 0's experts
    rotated by one rank; then in bf16 timed, every flash call of the
    prefill held to its plain version at its operands.  The launch counters
    are zeroed just before each prefill and read after the last step."""
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill
    from repro_torch.models.model import param_specs

    cfg = family_config(arch, layers, "float32")
    specs = param_specs(cfg, mesh)
    t0 = time.perf_counter()
    params = seeded_slices(cfg, seed, specs, layout)
    prefill, steps = family_serve_inputs(cfg, seed)
    want = [w.cuda() for w in torch.load(ref_file)]
    rec: dict = {"setup_s": time.perf_counter() - t0}
    max_len = FAMILY_MESH["serve_batch"][1] + FAMILY_MESH["gen"]

    def whole(logits):
        if logits.shape[-1] < cfg.vocab_size:
            logits = layout.all_gather(logits, -1, "model")
        return logits[:, -1].float()

    for dtype in ("float32", "bfloat16"):
        c = family_config(arch, layers, dtype)
        calls: list = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        routes: list = []
        with torch.inference_mode(), activation_sharding(mesh), \
                capture_calls(fa, "flash_attention_cuda", calls):
            with capture_routes(routes):
                t1 = time.perf_counter()
                logits, cache = sharded_prefill(c, params, specs, prefill, max_len=max_len,
                                                last_only=True)
                got = [whole(logits)]
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t1
                step_ms = []
                for batch in steps:
                    t1 = time.perf_counter()
                    logits, cache = sharded_decode_step(c, params, specs, cache, batch)
                    got.append(whole(logits))
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t1) * 1e3)
            launches = fa.flash_attention_cuda.launches   # the capturing wrapper's count
            r = {"prefill_s": prefill_s, "step_ms": step_ms, "launches": launches,
                 "rel_rms": [rel_rms(g, w) for g, w in zip(got, want)],
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "local_heads": int(calls[0][0][0].shape[2])}
            if cfg.family == "moe":
                # Every TP rank's routing alike; against the single device's
                # routing in float32 and in bf16, the share of tokens whose
                # chosen (kept) experts differ, and the logits against the
                # single device's bf16 logits.
                r["routing"] = routes_alike_over_tp(routes, layout)
                ref_routes = torch.load(ref_file.with_name(f"routes_{arch}.pt"))
                flips = functools.partial(routing_flips, num_experts=cfg.num_experts,
                                          k=cfg.experts_per_token)
                r["flips_vs_float32"] = flips(routes, ref_routes["float32"])
                if dtype == "bfloat16":
                    r["flips_vs_bf16"] = flips(routes, ref_routes["bfloat16"])
                    r["rel_rms_vs_bf16"] = [rel_rms(g, w.cuda()) for g, w in
                                            zip(got, ref_routes["bf16_logits"])]
                del ref_routes
            if dtype == "float32":
                cache["cur"] = cache["cur"] - 2   # the off-by-one cache, last step again
                logits, _ = sharded_decode_step(c, params, specs, cache, steps[-1])
                r["control_rel_rms"] = rel_rms(whole(logits), want[-1])
                if cfg.family == "moe":   # layer 0's experts rotated by one TP rank
                    moe = params["blocks"]["moe"]
                    saved = {k: moe[k][0].clone() for k in ("w_gate", "w_up", "w_down")}
                    for k, t in saved.items():
                        n = t.shape[0]
                        full = layout.all_gather(t, 0, "model")
                        nxt = (layout.coord["model"] + 1) % layout.sizes["model"]
                        moe[k][0].copy_(full[nxt * n:(nxt + 1) * n])
                        del full
                    logits, _ = sharded_prefill(c, params, specs, prefill, max_len=max_len,
                                                last_only=True)
                    r["experts_control_rel_rms"] = rel_rms(whole(logits), want[0])
                    for k, t in saved.items():
                        moe[k][0].copy_(t)
                    del saved
        if dtype != "float32":
            with torch.no_grad():
                r["calls_max_abs_err"] = max(
                    flash_close(fa.flash_attention_cuda(*a, **kw), plain_flash(*a, **kw),
                                f"{arch} prefill call {j}") for j, (a, kw) in enumerate(calls))
        rec[dtype] = r
        del cache, logits, got, calls
        gc.collect()
        torch.cuda.empty_cache()
    del params, prefill, steps, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def nccl_serve_family(arch: str, layers, seed: int, mesh) -> dict:
    """One family on phase 23 (c)'s NCCL rank ((1, 1), bf16): the whole
    seeded model, the single device's teacher-forced logits from its own
    ``DecodeEngine`` (freed before the sharded run), then
    ``sharded_prefill`` and ``sharded_decode_step`` on the model's tensors
    (a (1, 1) mesh's slices are the whole), within LOGITS_REL_TOL relative
    RMS of the single device's, every flash call of the prefill equal to its
    plain version at its operands."""
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import DecodeEngine
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill
    from repro_torch.models.model import param_specs

    t0 = time.perf_counter()
    cfg, model = family_model(arch, layers, seed)
    prefill, steps = family_serve_inputs(cfg, seed)
    max_len = FAMILY_MESH["serve_batch"][1] + FAMILY_MESH["gen"]
    with torch.inference_mode():
        eng = DecodeEngine(model)
        lg, cache = eng.prefill(model, prefill, max_len=max_len, last_only=True)
        want = [lg[:, -1].float()]
        for batch in steps:
            lg, cache = eng.decode_step(model, cache, batch)
            want.append(lg[:, -1].float())
        del eng, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    params, specs = model.param_tree(), param_specs(cfg, mesh)
    rec = {"setup_s": time.perf_counter() - t0, "params": model.num_params()}
    calls: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with torch.inference_mode(), activation_sharding(mesh), \
            capture_calls(fa, "flash_attention_cuda", calls):
        t1 = time.perf_counter()
        logits, cache = sharded_prefill(cfg, params, specs, prefill, max_len=max_len,
                                        last_only=True)
        got = [logits[:, -1].float()]
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t1
        rec["step_ms"] = []
        for batch in steps:
            t1 = time.perf_counter()
            logits, cache = sharded_decode_step(cfg, params, specs, cache, batch)
            got.append(logits[:, -1].float())
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
        rec["launches"] = fa.flash_attention_cuda.launches   # the capturing wrapper's count
        rec["rel_rms"] = [rel_rms(g, w) for g, w in zip(got, want)]
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        rec["calls_max_abs_err"] = max(
            flash_close(fa.flash_attention_cuda(*a, **kw), plain_flash(*a, **kw),
                        f"{arch} prefill call {j}") for j, (a, kw) in enumerate(calls))
    del model, params, cache, logits, got, want, calls
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def family_child(run_dir: Path, backend: str, rank: int, world: int, shape: str) -> None:
    """One rank of phase 23 (c) (``chip_smoke.py --family-child DIR BACKEND
    RANK WORLD MESH``): joins the group over a file store in ``run_dir``
    (the references and the seed in its parent), builds the (data, model)
    mesh ``AxB``; a gloo rank trains (:func:`mesh_train_family`) and serves
    (:func:`mesh_serve_family`) the families of FAMILY_MESH on its slices,
    the NCCL rank serves FAMILY_MESH["nccl_serve"]
    (:func:`nccl_serve_family`).  Writes ``<backend><world>_rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed.sharding import layout_of
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=FAMILY_MESH["timeout"]))
    mesh = make_mesh(tuple(int(x) for x in shape.split("x")), ("data", "model"))
    layout = layout_of(mesh)
    seed = int((run_dir.parent / "seed").read_text())
    out = {"rank": rank, "backend": backend, "world": world, "mesh": shape,
           "coord": layout.coord, "train": {}, "serve": {}}
    t0 = time.perf_counter()
    if backend == "gloo":
        for arch, layers in FAMILY_MESH["train"]:
            out["train"][arch] = mesh_train_family(arch, layers, seed, mesh, layout,
                                                   run_dir.parent / f"train_{arch}")
            dist.barrier()
            out["train"][arch]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        for arch, layers in FAMILY_MESH["serve"]:
            out["serve"][arch] = mesh_serve_family(arch, layers, seed, mesh, layout,
                                                   run_dir.parent / f"serve_{arch}.pt")
            dist.barrier()
            out["serve"][arch]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    else:
        for arch, layers in FAMILY_MESH["nccl_serve"]:
            out["serve"][arch] = nccl_serve_family(arch, layers, seed, mesh)
            out["serve"][arch]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    (run_dir / f"{backend}{world}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_family_mesh(seed: int) -> tuple[dict, dict]:
    """Phase 23 (c): the moe, vlm and audio families over a mesh at their
    published widths (FAMILY_MESH): the single-device float32 references
    first (:func:`family_mesh_references`), then 4 gloo ranks sharing the
    card on (1, 4) and one NCCL rank on (1, 1), each run's ranks processes
    of their own (:func:`family_child`), their records gated here.  Returns
    the record and rows 9 and 9d's launches by run, rank and family."""
    import os
    import shutil
    import tempfile

    from repro_torch.models.model import attention_applications

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_families_"))
    record: dict = {}
    launches: dict = {"flash_attention": {}, "flash_attention_bwd": {}}
    try:
        (root / "seed").write_text(str(seed))
        record["references_s"] = family_mesh_references(seed, root)
        log(f"phase 23 (c) single-device float32 references (TF32 off): "
            + ", ".join(f"{k} {v:.1f} s" for k, v in record["references_s"].items())
            + f"; this process then holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved)")
        record["single_bf16"] = {}
        for arch, layers in FAMILY_MESH["serve"]:
            if not (root / f"routes_{arch}.pt").exists():
                continue
            cfg = family_config(arch, layers)
            ref = torch.load(root / f"routes_{arch}.pt")
            f32 = torch.load(root / f"serve_{arch}.pt")
            one = record["single_bf16"][arch] = {
                "rel_rms": [rel_rms(a, b) for a, b in zip(ref["bf16_logits"], f32)],
                "flips": routing_flips(ref["bfloat16"], ref["float32"], cfg.num_experts,
                                       cfg.experts_per_token)}
            log(f"phase 23 (c) {arch} on the single device, bf16 against float32: logits "
                f"{', '.join(f'{x:.4f}' for x in one['rel_rms'])} relative RMS (prefill, "
                f"decode); tokens whose chosen / kept experts differ, a routing call each "
                f"(prefill's layers, then the decode step's): "
                + ", ".join(f"{a:.2%} / {b:.2%}" for a, b in one["flips"]))
        for backend, shape in FAMILY_MESH["runs"]:
            dims = tuple(int(x) for x in shape.split("x"))
            world = math.prod(dims)
            run = f"{backend} x{world} on {dims} data x model"
            sub = root / f"{backend}_{shape}"
            sub.mkdir()
            t0 = time.perf_counter()
            # Expandable segments: each rank's train and serve stages leave no
            # reserved fragments behind for the next stage on the shared card.
            saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            try:
                ranks = run_mesh_ranks(sub, backend, world, flag="--family-child",
                                       extra=(shape,), timeout=FAMILY_MESH["timeout"])
            finally:
                if saved is None:
                    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
                else:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
            wall = time.perf_counter() - t0
            record[run] = {"wall_s": wall, "ranks": ranks}
            for r in ranks:
                where = f"phase 23 (c), {run}, rank {r['rank']}"
                bad = []
                for arch, t in r["train"].items():
                    f32, bf16 = t["float32"], t["bfloat16"]
                    ref = f32["ref"]
                    if abs(f32["loss"] - ref["loss"]) > SHARDED_LOSS_RTOL * abs(ref["loss"]):
                        bad.append(f"{arch} float32 loss {f32['loss']} vs {ref['loss']}")
                    if f32["moe_dropped"] != ref["moe_dropped"]:
                        bad.append(f"{arch} moe_dropped {f32['moe_dropped']} vs "
                                   f"{ref['moe_dropped']}")
                    if f32["param_gate"][0] > FAMILY_MESH_PARAM_REL_RMS:
                        bad.append(f"{arch} float32 leaf {f32['param_gate'][1]}: "
                                   f"{f32['param_gate'][0]:.3g} of its update")
                    for dt, rr in (("float32", f32), ("bf16", bf16)):
                        if "routing" in rr and not rr["routing"]["tp_equal"]:
                            bad.append(f"{arch} {dt} step: the TP ranks routed differently")
                    if min(f32["launches"]) < 1 or min(bf16["launches"]) < 1 or \
                            not math.isfinite(bf16["loss"]):
                        bad.append(f"{arch}: launches {f32['launches']} / {bf16['launches']}, "
                                   f"bf16 loss {bf16['loss']}")
                    for dt, rr in (("float32", f32), ("bf16", bf16)):
                        launches["flash_attention"][f"{where}, {arch} {dt} step"] = \
                            rr["launches"][0]
                        launches["flash_attention_bwd"][f"{where}, {arch} {dt} step"] = \
                            rr["launches"][1]
                for arch, sv in r["serve"].items():
                    apps = attention_applications(family_config(arch, dict(
                        FAMILY_MESH["nccl_serve"])[arch]))
                    for dt in ("float32", "bfloat16"):
                        rr = sv.get(dt, sv)
                        if dt == "float32" and dt not in sv:
                            continue
                        tol = SERVE_F32_REL_TOL if dt == "float32" else LOGITS_REL_TOL
                        gated = dt == "float32" or backend == "nccl"
                        if gated and (not all(map(math.isfinite, rr["rel_rms"]))
                                      or max(rr["rel_rms"]) > tol):
                            bad.append(f"{arch} {dt} logits {rr['rel_rms']} beyond {tol}")
                        if "routing" in rr and not rr["routing"]["tp_equal"]:
                            bad.append(f"{arch} {dt}: the TP ranks routed differently")
                        for key in ("control_rel_rms", "experts_control_rel_rms"):
                            if key in rr and rr[key] <= tol:
                                bad.append(f"{arch}: the control {key} passed: {rr[key]:.3g}")
                        if rr["launches"] != apps:
                            bad.append(f"{arch} {dt}: {rr['launches']} flash launches, expected "
                                       f"{apps}")
                        launches["flash_attention"][f"{where}, {arch} {dt} prefill"] = \
                            rr["launches"]
                if bad:
                    raise AssertionError(f"{where}: " + "; ".join(bad))
            r0 = ranks[0]
            for arch, t in r0["train"].items():
                f32, bf16 = t["float32"], t["bfloat16"]
                log(f"phase 23 (c), {run}, {arch} trained (layers {family_config(arch, dict(FAMILY_MESH['train'])[arch]).num_layers}, "
                    f"{FAMILY_MESH['train_batch'][0]} x {FAMILY_MESH['train_batch'][1]}): float32 "
                    f"loss {f32['loss']:.6f} = the single device's {f32['ref']['loss']:.6f}, "
                    f"moe_dropped {f32['moe_dropped']} = {f32['ref']['moe_dropped']}, worst "
                    f"leaf on any rank {max(r['train'][arch]['float32']['param_gate'][0] for r in ranks):.3g} "
                    f"of its update (gate {FAMILY_MESH_PARAM_REL_RMS}); step {f32['step_ms']:.1f} "
                    f"ms float32, {bf16['step_ms']:.1f} ms bf16 (loss {bf16['loss']:.4f}); flash "
                    f"launches a rank {f32['launches']} / {bf16['launches']} (forward, backward), "
                    f"bf16 calls within their gates (max |err| {bf16['fwd_calls_max_abs_err']:.3g}, "
                    f"relative RMS {bf16['bwd_calls_rel_rms']:.3g}); a rank's slices "
                    f"{t['param_bytes'] / 1e9:.2f} GB, peak {f32['peak_gb']:.2f} GB; {t['wall_s']:.1f} "
                    f"s with its set-up ({t['setup_s']:.1f})  [{smi_line()}]")
            for arch, sv in r0["serve"].items():
                rr = sv.get("bfloat16", sv)
                f32 = sv.get("float32")
                extra = ""
                if f32:
                    extra = (f"; float32 logits within {max(max(r['serve'][arch]['float32']['rel_rms']) for r in ranks):.3g} "
                             f"(gate {SERVE_F32_REL_TOL}), the off-by-one control "
                             f"{min(r['serve'][arch]['float32']['control_rel_rms'] for r in ranks):.3g}"
                             + (f", layer 0's experts rotated {min(r['serve'][arch]['float32']['experts_control_rel_rms'] for r in ranks):.3g}"
                                if "experts_control_rel_rms" in f32 else "")
                             + " failing it")
                log(f"phase 23 (c), {run}, {arch} served ({FAMILY_MESH['serve_batch'][0]} x "
                    f"{FAMILY_MESH['serve_batch'][1]} prompt, {FAMILY_MESH['gen'] - 1} decode "
                    f"steps): bf16 prefill {rr['prefill_s']:.3f} s, decode "
                    f"{statistics.median(rr['step_ms']):.2f} ms a step, logits within "
                    f"{max(rr['rel_rms']):.4f} relative RMS of the single device's "
                    f"{'float32' if f32 else 'bf16'} logits{extra}; "
                    f"{rr['launches']} flash launches a rank ({rr.get('local_heads', 'all')} "
                    f"heads a call), each call within its gate (max |err| "
                    f"{rr['calls_max_abs_err']:.3g}); peak {rr['peak_gb']:.2f} GB; {sv['wall_s']:.1f} s "
                    f"with its set-up ({sv['setup_s']:.1f})  [{smi_line()}]")
                if "routing" in rr:
                    fl = lambda pairs: ", ".join(f"{a:.2%} / {b:.2%}" for a, b in pairs)  # noqa: E731
                    log(f"phase 23 (c), {run}, {arch} bf16 routing: every TP rank's "
                        f"{rr['routing']['calls']} routings alike (CRC-32 of choices and keeps "
                        f"all-gathered over TP, on every rank); logits "
                        f"{', '.join(f'{x:.4f}' for x in rr['rel_rms_vs_bf16'])} relative RMS "
                        f"from the single device's bf16 logits; tokens whose chosen / kept "
                        f"experts differ, a routing call each (prefill's layers, then the "
                        f"decode step's): against the single device's bf16 routing "
                        f"{fl(rr['flips_vs_bf16'])}; against its float32 routing "
                        f"{fl(rr['flips_vs_float32'])}; float32 on the mesh against float32 "
                        f"{fl(f32['flips_vs_float32'])}")
            for arch, t in r0["train"].items():
                if "routing" in t["bfloat16"]:
                    log(f"phase 23 (c), {run}, {arch} trained: every TP rank's routings alike "
                        f"({t['float32']['routing']['calls']} float32, "
                        f"{t['bfloat16']['routing']['calls']} bf16, remat's replays included)")
            log(f"phase 23 (c), {run}: {wall:.1f} s with start-up")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 23 (c): {record['phase_s']:.1f} s; NCCL with more than one rank is not exercised "
        f"(one card): the gloo ranks share it through host copies")
    return record, launches


# Phase 24: the ssm and hybrid families over a mesh.  Both families' widths
# uncut: mamba2-2.7b trained and served at 2 layers; zamba2-7b trained at 13
# (two groups behind the shared block and a tail layer, phase 16's cut) and
# served at 7 (one group and a tail layer: every (2, 2) decode step
# all-gathers the weights over "data" through the host, 7.3 s a step at 13
# layers); on (1, 4) gloo, serving also on (2, 2) and one B = 1 zamba2-7b
# prompt of 2,048 tokens there, which takes the cache's sequence fallback
# (the shared K/V's positions split over "data"); one NCCL rank serves both
# uncut on (1, 1).
SSM_MESH = dict(
    train=(("mamba2-2.7b", 2), ("zamba2-7b", 13)),
    serve=(("mamba2-2.7b", 2), ("zamba2-7b", 7)),
    train_batch=(2, 512), serve_batch=(4, 512), gen=3, lr=3e-3,
    # The update gate excuses an element whose update's sign differs from
    # the single device's where this rank's gradient is under 1e-3 of its
    # slice's RMS (mesh_train_family): at most 1% of a leaf's elements.
    sign_floor=1e-3, max_excused=0.01,
    fallback=dict(arch="zamba2-7b", layers=7, serve_batch=(1, 2048), gen=3),
    serve_meshes=("1x4", "2x2"), nccl=("mamba2-2.7b", "zamba2-7b"),
    nccl_plan=dict(serve_batch=(4, 512), gen=5),
    runs=(("gloo", "1x4"), ("nccl", "1x1")), timeout=600)


def ssm_max_len(plan: dict) -> int:
    """A cache for the prompt and the decode steps, even (the fallback splits
    its positions over 2 data ranks)."""
    n = plan["serve_batch"][1] + plan["gen"]
    return n + n % 2


def ssm_fallback_reference(seed: int, ref_dir: Path) -> float:
    """Phase 24 (b)'s single-device float32 reference for the sequence
    fallback (TF32 off): the B = 1 zamba2-7b prompt's teacher-forced logits
    (``DecodeEngine``), saved to ``ref_dir``.  Returns its wall."""
    from repro_torch.models import DecodeEngine

    t0 = time.perf_counter()
    fb = SSM_MESH["fallback"]
    cfg, model = family_model(fb["arch"], fb["layers"], seed, "float32")
    prefill, steps = family_serve_inputs(cfg, seed, fb)
    eng = DecodeEngine(model)
    with torch.inference_mode():
        lg, cache = eng.prefill(model, prefill, max_len=ssm_max_len(fb), last_only=True)
        want = [lg[:, -1].float().cpu()]
        for batch in steps:
            lg, cache = eng.decode_step(model, cache, batch)
            want.append(lg[:, -1].float().cpu())
    torch.save(want, ref_dir / "fallback.pt")
    del model, eng, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def norm_control(mesh, layout):
    """Phase 24 (a)'s control, run on a rank's float32 slices before its
    step: the loss of the batch with each rank's gated norm taken over its
    own channels only (the mean of its slice's squares, no all-reduce over
    TP), which must miss the single device's loss."""
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.models import model as model_lib

    def run(cfg, params, specs, batch):
        saved = model_lib._ShardedDecoder.ssm_norm_mean
        model_lib._ShardedDecoder.ssm_norm_mean = (
            lambda self, ss: ss / (self.cfg.ssm_inner // self.ctx.tp_size))
        try:
            count = layout.all_reduce(torch.tensor(float(batch["labels"].numel()),
                                                   device="cuda"), ("data",))
            with torch.no_grad(), activation_sharding(mesh):
                objective, _ = model_lib.sharded_loss(cfg, params, specs, batch, count=count)
            loss = float(layout.all_reduce(objective, layout.names))
        finally:
            model_lib._ShardedDecoder.ssm_norm_mean = saved
        return {"norm_control_loss": loss}

    return run


def clone_cache(cache: dict) -> dict:
    return {k: clone_cache(v) if isinstance(v, dict) else v.clone() for k, v in cache.items()}


@contextlib.contextmanager
def dropping_seq_slice(layout):
    """While inside, the rank at ``"data"`` coordinate 1 leaves its slice of
    the positions out of the sequence fallback's combine (it adds zeros to
    the sum of exponentials and outputs; the max still all-reduced)."""
    from repro_torch.models import layers

    saved = layers.decode_attention

    def dropping(*args, reduce_seq=None, **kw):
        if reduce_seq is not None and layout.coord["data"] == 1:
            inner = reduce_seq

            def reduce_seq(t, maximum):
                return inner(t if maximum else torch.zeros_like(t), maximum)
        return saved(*args, reduce_seq=reduce_seq, **kw)

    layers.decode_attention = dropping
    try:
        yield
    finally:
        layers.decode_attention = saved


def mesh_serve_ssm(arch: str, layers, seed: int, mesh, layout, ref_file: Path,
                   plan: dict) -> dict:
    """One served model on a gloo rank of phase 24 (b): its seeded slices,
    ``sharded_prefill`` and teacher-forced ``sharded_decode_step`` calls in
    float32 (TF32 off) on this rank's rows (every row where the batch does
    not divide the data axis: the sequence fallback), the logits gathered
    over the vocabulary's TP slices held to the single device's within
    SERVE_F32_REL_TOL relative RMS.  The controls, from copies of the cache
    after the prefill: the first decode step with layer 0's SSM state
    zeroed, and in the fallback with the data rank 1's positions left out
    of the combine; both must fail that gate.  The launch counters are
    zeroed just before the prefill and read after the last step."""
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill
    from repro_torch.models.model import param_specs

    cfg = family_config(arch, layers, "float32")
    specs = param_specs(cfg, mesh)
    t0 = time.perf_counter()
    params = seeded_slices(cfg, seed, specs, layout)
    prefill, steps = family_serve_inputs(cfg, seed, plan)
    b = plan["serve_batch"][0]
    n, i = layout.size(("data",)), layout.index(("data",))
    rows = slice(i * b // n, (i + 1) * b // n) if b % n == 0 else slice(0, b)
    prefill = {k: v[rows] for k, v in prefill.items()}
    steps = [{k: v[rows] for k, v in s.items()} for s in steps]
    want = [w[rows].cuda() for w in torch.load(ref_file)]
    rec: dict = {"setup_s": time.perf_counter() - t0, "rows": [rows.start, rows.stop]}

    def whole(logits):
        if logits.shape[-1] < cfg.vocab_size:
            logits = layout.all_gather(logits, -1, "model")
        return logits[:, -1].float()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with torch.inference_mode(), activation_sharding(mesh):
        t1 = time.perf_counter()
        logits, cache = sharded_prefill(cfg, params, specs, prefill, max_len=ssm_max_len(plan),
                                        last_only=True, global_batch=b)
        got = [whole(logits)]
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t1
        after_prefill = clone_cache(cache)
        rec["step_ms"] = []
        for batch in steps:
            t1 = time.perf_counter()
            logits, cache = sharded_decode_step(cfg, params, specs, cache, batch)
            got.append(whole(logits))
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
        rec["launches"] = fa.flash_attention_cuda.launches
        rec["rel_rms"] = [rel_rms(g, w) for g, w in zip(got, want)]
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["kv_positions"] = (int(cache["shared"]["k"].shape[2]) if "shared" in cache
                               else None)
        ctrl = clone_cache(after_prefill)
        ctrl["ssm"][0].zero_()
        logits, _ = sharded_decode_step(cfg, params, specs, ctrl, steps[0])
        rec["zeroed_state_rel_rms"] = rel_rms(whole(logits), want[1])
        if b % n:
            with dropping_seq_slice(layout):
                logits, _ = sharded_decode_step(cfg, params, specs, after_prefill, steps[0])
            rec["dropped_slice_rel_rms"] = rel_rms(whole(logits), want[1])
    del params, cache, after_prefill, ctrl, logits, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def nccl_serve_ssm(arch: str, seed: int, mesh) -> dict:
    """One family on phase 24 (c)'s NCCL rank ((1, 1)), uncut: the seeded
    model in float32 (TF32 off), the single device's teacher-forced logits
    from its own ``DecodeEngine`` first, then ``sharded_prefill`` and
    ``sharded_decode_step`` on the model's tensors (a (1, 1) mesh's slices
    are the whole) within SERVE_F32_REL_TOL relative RMS of them, timed;
    then the same in bf16, timed, each flash call of its prefill held to
    its plain version at its operands (seeded bf16 drifts at depth, so
    bf16 is gated per call, not end to end)."""
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import DecodeEngine
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill
    from repro_torch.models.model import param_specs

    plan = SSM_MESH["nccl_plan"]
    t0 = time.perf_counter()
    cfg, model = family_model(arch, None, seed, "float32")
    prefill, steps = family_serve_inputs(cfg, seed, plan)
    max_len = ssm_max_len(plan)
    with torch.inference_mode():
        eng = DecodeEngine(model)
        lg, cache = eng.prefill(model, prefill, max_len=max_len, last_only=True)
        want = [lg[:, -1].float()]
        for batch in steps:
            lg, cache = eng.decode_step(model, cache, batch)
            want.append(lg[:, -1].float())
        del eng, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    params, specs = model.param_tree(), param_specs(cfg, mesh)
    rec = {"setup_s": time.perf_counter() - t0, "params": model.num_params(),
           "layers": cfg.num_layers}
    for dtype in ("float32", "bfloat16"):
        c = family_config(arch, None, dtype)
        calls: list = []
        r: dict = {"step_ms": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        with torch.inference_mode(), activation_sharding(mesh), \
                capture_calls(fa, "flash_attention_cuda", calls):
            t1 = time.perf_counter()
            logits, cache = sharded_prefill(c, params, specs, prefill, max_len=max_len,
                                            last_only=True)
            got = [logits[:, -1].float()]
            torch.cuda.synchronize()
            r["prefill_s"] = time.perf_counter() - t1
            for batch in steps:
                t1 = time.perf_counter()
                logits, cache = sharded_decode_step(c, params, specs, cache, batch)
                got.append(logits[:, -1].float())
                torch.cuda.synchronize()
                r["step_ms"].append((time.perf_counter() - t1) * 1e3)
            r["launches"] = fa.flash_attention_cuda.launches   # the capturing wrapper's count
            r["rel_rms"] = [rel_rms(g, w) for g, w in zip(got, want)]
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if calls:
            with torch.no_grad():
                r["calls_max_abs_err"] = max(
                    flash_close(fa.flash_attention_cuda(*a, **kw), plain_flash(*a, **kw),
                                f"{arch} {dtype} prefill call {j}")
                    for j, (a, kw) in enumerate(calls))
        rec[dtype] = r
        del cache, logits, got, calls
        gc.collect()
        torch.cuda.empty_cache()
    del model, params, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ssm_mesh_child(run_dir: Path, backend: str, rank: int, world: int, shape: str) -> None:
    """One rank of phase 24 (``chip_smoke.py --ssm-child DIR BACKEND RANK
    WORLD MESH``): joins the group over a file store in ``run_dir`` (the
    references and the seed in its parent).  A gloo rank trains SSM_MESH's
    families on the (data, model) mesh ``AxB`` (:func:`mesh_train_family`
    with the gated-norm control; zamba2-7b also one bf16 step), serves them
    there and on each other mesh of SSM_MESH["serve_meshes"]
    (:func:`mesh_serve_ssm`), and serves the B = 1 prompt on (2, 2); the
    NCCL rank serves SSM_MESH["nccl"] uncut (:func:`nccl_serve_ssm`).
    Writes ``<backend><world>_rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed.sharding import layout_of
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{run_dir}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SSM_MESH["timeout"]))
    seed = int((run_dir.parent / "seed").read_text())
    out = {"rank": rank, "backend": backend, "world": world, "mesh": shape, "train": {},
           "serve": {}}
    t0 = time.perf_counter()

    def mesh_of(text):
        mesh = make_mesh(tuple(int(x) for x in text.split("x")), ("data", "model"))
        return mesh, layout_of(mesh)

    if backend == "gloo":
        mesh, layout = mesh_of(shape)
        out["coord"] = layout.coord
        for arch, layers in SSM_MESH["train"]:
            out["train"][arch] = mesh_train_family(
                arch, layers, seed, mesh, layout, run_dir.parent / f"train_{arch}",
                plan=SSM_MESH, bf16=family_config(arch, layers).family == "hybrid",
                before=norm_control(mesh, layout))
            dist.barrier()
            out["train"][arch]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        for text in SSM_MESH["serve_meshes"]:
            if text != shape:
                mesh, layout = mesh_of(text)
            for arch, layers in SSM_MESH["serve"]:
                key = f"{arch} on {text}"
                out["serve"][key] = mesh_serve_ssm(arch, layers, seed, mesh, layout,
                                                   run_dir.parent / f"serve_{arch}.pt", SSM_MESH)
                dist.barrier()
                out["serve"][key]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        fb = SSM_MESH["fallback"]
        key = f"{fb['arch']} B = 1 on {SSM_MESH['serve_meshes'][-1]}"
        out["serve"][key] = mesh_serve_ssm(fb["arch"], fb["layers"], seed, mesh, layout,
                                           run_dir.parent / "fallback.pt", fb)
        out["serve"][key]["wall_s"] = time.perf_counter() - t0
    else:
        mesh, _ = mesh_of(shape)
        for arch in SSM_MESH["nccl"]:
            out["serve"][arch] = nccl_serve_ssm(arch, seed, mesh)
            out["serve"][arch]["wall_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    (run_dir / f"{backend}{world}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_ssm_mesh(seed: int) -> tuple[dict, dict]:
    """Phase 24: the ssm and hybrid families over a mesh at their published
    widths (SSM_MESH): the single-device float32 references first
    (:func:`family_mesh_references` with SSM_MESH, :func:`ssm_fallback_reference`),
    then 4 gloo ranks sharing the card and one NCCL rank on (1, 1), each
    run's ranks processes of their own (:func:`ssm_mesh_child`), their
    records gated here.  Returns the record and rows 9 and 9d's launches by
    run, rank and model."""
    import os
    import shutil
    import tempfile

    from repro_torch.models.model import attention_applications

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ssm_mesh_"))
    record: dict = {}
    launches: dict = {"flash_attention": {}, "flash_attention_bwd": {}}
    try:
        (root / "seed").write_text(str(seed))
        record["references_s"] = family_mesh_references(seed, root, SSM_MESH)
        record["references_s"]["fallback"] = ssm_fallback_reference(seed, root)
        log("phase 24 single-device float32 references (TF32 off): "
            + ", ".join(f"{k} {v:.1f} s" for k, v in record["references_s"].items()))
        for backend, shape in SSM_MESH["runs"]:
            dims = tuple(int(x) for x in shape.split("x"))
            world = math.prod(dims)
            run = f"{backend} x{world}"
            sub = root / f"{backend}_{shape}"
            sub.mkdir()
            t0 = time.perf_counter()
            saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            try:
                ranks = run_mesh_ranks(sub, backend, world, flag="--ssm-child", extra=(shape,),
                                       timeout=SSM_MESH["timeout"])
            finally:
                if saved is None:
                    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
                else:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
            wall = time.perf_counter() - t0
            record[run] = {"wall_s": wall, "ranks": ranks}
            for r in ranks:
                where = f"phase 24, {run}, rank {r['rank']}"
                bad = []
                for arch, t in r["train"].items():
                    f32, ref = t["float32"], t["float32"]["ref"]
                    hybrid = family_config(arch, None).family == "hybrid"
                    if abs(f32["loss"] - ref["loss"]) > SHARDED_LOSS_RTOL * abs(ref["loss"]):
                        bad.append(f"{arch} float32 loss {f32['loss']} vs {ref['loss']}")
                    if f32["param_gate"][0] > FAMILY_MESH_PARAM_REL_RMS:
                        bad.append(f"{arch} float32 leaf {f32['param_gate'][1]}: "
                                   f"{f32['param_gate'][0]:.3g} of its update")
                    for out, _, _, n, name in f32["sign_flips"]:
                        if out > SSM_MESH["max_excused"] * n:
                            bad.append(f"{arch} float32 leaf {name}: {out} of {n} elements "
                                       f"flipped under the sign floor")
                    if not abs(t["norm_control_loss"] - ref["loss"]) > \
                            SHARDED_LOSS_RTOL * abs(ref["loss"]):
                        bad.append(f"{arch}: the local gated-norm control passed: "
                                   f"{t['norm_control_loss']} vs {ref['loss']}")
                    steps = [("float32", f32)] + ([("bf16", t["bfloat16"])] if hybrid else [])
                    for dt, rr in steps:
                        if hybrid and min(rr["launches"]) < 1:
                            bad.append(f"{arch} {dt}: flash launches {rr['launches']}")
                        if hybrid:
                            launches["flash_attention"][f"{where}, {arch} {dt} step"] = \
                                rr["launches"][0]
                            launches["flash_attention_bwd"][f"{where}, {arch} {dt} step"] = \
                                rr["launches"][1]
                    if hybrid and not math.isfinite(t["bfloat16"]["loss"]):
                        bad.append(f"{arch} bf16 loss {t['bfloat16']['loss']}")
                for key, sv in r["serve"].items():
                    arch = key.split()[0]
                    layers = None if backend == "nccl" else (
                        SSM_MESH["fallback"]["layers"] if "B = 1" in key
                        else dict(SSM_MESH["serve"])[arch])
                    apps = attention_applications(family_config(arch, layers))
                    for dt, rr in (("float32", sv.get("float32", sv)),
                                   ("bf16", sv.get("bfloat16"))):
                        if rr is None:
                            continue
                        if dt == "float32" and (not all(map(math.isfinite, rr["rel_rms"]))
                                                or max(rr["rel_rms"]) > SERVE_F32_REL_TOL):
                            bad.append(f"{key} {dt} logits {rr['rel_rms']} beyond "
                                       f"{SERVE_F32_REL_TOL}")
                        if rr["launches"] != apps:
                            bad.append(f"{key} {dt}: {rr['launches']} flash launches, "
                                       f"expected {apps}")
                        if apps:
                            launches["flash_attention"][f"{where}, {key} {dt} prefill"] = \
                                rr["launches"]
                    for ctl in ("zeroed_state_rel_rms", "dropped_slice_rel_rms"):
                        if ctl in sv and sv[ctl] <= SERVE_F32_REL_TOL:
                            bad.append(f"{key}: the control {ctl} passed: {sv[ctl]:.3g}")
                    if "B = 1" in key and "dropped_slice_rel_rms" not in sv:
                        bad.append(f"{key}: the fallback's control did not run")
                if bad:
                    raise AssertionError(f"{where}: " + "; ".join(bad))
            r0 = ranks[0]
            for arch, t in r0["train"].items():
                f32 = t["float32"]
                bf = t.get("bfloat16")
                log(f"phase 24 (a), {run} on {shape}, {arch} trained "
                    f"({family_config(arch, dict(SSM_MESH['train'])[arch]).num_layers} layers, "
                    f"{SSM_MESH['train_batch'][0]} x {SSM_MESH['train_batch'][1]}): float32 loss "
                    f"{f32['loss']:.6f} = the single device's {f32['ref']['loss']:.6f}, worst "
                    f"leaf on any rank {max(x['train'][arch]['float32']['param_gate'][0] for x in ranks):.3g} "
                    f"of its update (gate {FAMILY_MESH_PARAM_REL_RMS}), excusing the elements "
                    f"whose sign flipped under a gradient of {SSM_MESH['sign_floor']} of their "
                    f"slice's RMS (by rank: excused, flipped, the largest flipped |g| / RMS, "
                    f"leaf size, leaf: {[x['train'][arch]['float32']['sign_flips'] for x in ranks]}), "
                    f"over every element "
                    f"{max(x['train'][arch]['float32']['param_gate_every_element'][0] for x in ranks):.3g} "
                    f"(leaf {f32['param_gate_every_element'][1]}); the local gated-norm "
                    f"control's loss {t['norm_control_loss']:.6f} (fails); step "
                    f"{f32['step_ms']:.1f} ms float32"
                    + (f", {bf['step_ms']:.1f} ms bf16 (loss {bf['loss']:.4f}), flash launches a "
                       f"rank {f32['launches']} / {bf['launches']} (forward, backward), bf16 "
                       f"calls within their gates (max |err| {bf['fwd_calls_max_abs_err']:.3g}, "
                       f"relative RMS {bf['bwd_calls_rel_rms']:.3g})" if bf else "")
                    + f"; a rank's slices {t['param_bytes'] / 1e9:.2f} GB, peak "
                    f"{f32['peak_gb']:.2f} GB; {t['wall_s']:.1f} s with its set-up "
                    f"({t['setup_s']:.1f})  [{smi_line()}]")
            for key, sv in r0["serve"].items():
                rr = sv.get("float32", sv)
                worst = max(max(x["serve"][key].get("float32", x["serve"][key])["rel_rms"])
                            for x in ranks)
                extra = "".join(
                    f", {ctl.replace('_rel_rms', '').replace('_', ' ')} control "
                    f"{min(x['serve'][key][ctl] for x in ranks):.3g}"
                    for ctl in ("zeroed_state_rel_rms", "dropped_slice_rel_rms") if ctl in sv)
                bf = sv.get("bfloat16")
                log(f"phase 24, {run}, {key} served: float32 prefill {rr['prefill_s']:.3f} s, "
                    f"decode {statistics.median(rr['step_ms']):.2f} ms a step, logits within "
                    f"{worst:.3g} relative RMS of the single device's (gate {SERVE_F32_REL_TOL})"
                    f"{extra}; {rr['launches']} flash launches a rank"
                    + (f", {rr['kv_positions']} K/V positions a rank" if rr.get("kv_positions")
                       else "")
                    + (f"; bf16 prefill {bf['prefill_s']:.3f} s, decode "
                       f"{statistics.median(bf['step_ms']):.2f} ms a step, peak "
                       f"{bf['peak_gb']:.2f} GB, flash calls within their gates (max |err| "
                       f"{bf.get('calls_max_abs_err', 0.0):.3g})" if bf else "")
                    + f"; peak {rr['peak_gb']:.2f} GB; {sv['wall_s']:.1f} s with its set-up "
                    f"({sv['setup_s']:.1f})  [{smi_line()}]")
            log(f"phase 24, {run}: {wall:.1f} s with start-up")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 24: {record['phase_s']:.1f} s; NCCL with more than one rank is not exercised "
        f"(one card): the gloo ranks share it through host copies")
    return record, launches


# ---------------------------------------------------------------------------
# Phase 25: the bitmap build's kernel (row 10), run after phase 8 while phase
# 4's collections are at hand
# ---------------------------------------------------------------------------

# (a) Every method at ``widths`` with and without the mixer on phase 4's
# ZIPF and UNIFORM, and at ``edge_widths`` on ``edge_rows`` seeded rows that
# hold the kernel's edge cases (32 * 12,289 bits exceed one warp's 48 KB of
# shared memory, so those bits live in the output row; its rows are cut to
# 64 positions, since the plain Next loops over positions).  (b) ZIPF timed
# at ``widths``.  (c) UNIFORM's self-join at ``tau``, which Algorithm 6
# sends through Bitmap-Next.
BUILD = dict(widths=(128, 1024), edge_widths=(32, 96, 160, 1024, 1056, 4096, 32 * 12289),
             edge_rows=64, serving_rows=(16, 512), tau=0.35, kernel_iters=50, plain_iters=2,
             budget_s=30)
# Integer operations a valid token needs at least: its PAD test, h(t)'s
# modulo, the word's and the bit's shifts and the OR / XOR into the word
# (token); the mixer's multiply, shift and XOR (mix); Next's probe, the
# word's read, NOT, the mask's shift and AND, __ffs and the bit's index
# (probe).
BUILD_OPS = dict(token=5, mix=3, probe=6)
BUILD_SOURCE = "src/repro_torch/kernels/csrc/bitmap_build.cu"
BUILD_REPLACES = {"set": "src/repro/core/bitmap.py:71", "xor": "src/repro/core/bitmap.py:77",
                  "next": "src/repro/core/bitmap.py:83"}


def build_edge_rows(n: int, b: int, seed: int, l: int | None = None):
    """int32 tokens [n, l] (l = b + 8 by default) and lengths holding the
    bitmap build's edge cases that fit in l: probes that wrap past bit b - 1
    (tokens that all hash to it), rows of exactly b and of more than b
    tokens (Next saturates), an empty row, PAD inside a length and a length
    past the row; the other rows random, of up to 60 tokens."""
    from repro_torch.core.constants import PAD_TOKEN

    rng = np.random.default_rng(seed + b)
    l = b + 8 if l is None else l
    toks = np.full((n, l), PAD_TOKEN, np.int32)
    lens = rng.integers(0, min(60, l) + 1, n).astype(np.int32)
    for i, k in enumerate(lens):
        toks[i, :k] = rng.integers(0, 2**31 - 1, k)
    edges = [(b - 1) + b * np.arange(min(12, l)), rng.choice(100 * b, b, replace=False),
             rng.choice(100 * b, b + 8, replace=False), rng.integers(0, 3 * b, b + 8), []]
    edges = [row for row in edges if len(row) <= l]
    for i, row in enumerate(edges[:n]):
        toks[i] = PAD_TOKEN
        toks[i, :len(row)] = row
        lens[i] = len(row)
    if n > 6:
        toks[5, [0, l // 2]] = PAD_TOKEN
        lens[5] = l
        lens[6] = l + 5
    return toks, lens


def build_serving_batch(col, rows: int, seed: int):
    """int32 tokens [rows, width] and lengths: ``rows`` sets of ``col`` in a
    seeded random order, padded as a serving flush pads its probe rows
    (``serve/session.py``: the width the power of two, at least 8, at or
    above the longest row)."""
    from repro_torch.core.constants import PAD_TOKEN
    from repro_torch.serve.entrypoints import pow2_bucket

    pick = np.random.default_rng(seed + rows).choice(col.num_sets, rows, replace=False)
    lens = col.lengths[pick].astype(np.int32)
    width = pow2_bucket(int(lens.max()), floor=8)
    toks = np.full((rows, width), PAD_TOKEN, np.int32)
    keep = min(width, col.tokens.shape[1])
    toks[:, :keep] = col.tokens[pick, :keep]
    return toks, lens


def build_bound(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str,
                mix: bool = False) -> dict:
    """The bitmap build's least time on these rows: the bytes it must move
    (each position it has to read, the lengths, the words written once)
    over the memory rate; the integer operations its valid tokens need
    (``BUILD_OPS``) over the float32 rate; for Next also the longest set's
    chain of probes, each waiting on the one before, at one dependent
    instruction a probe at the card's maximum SM clock.  Next reads a row
    only until b tokens are placed.  Returns the terms (ms), the bound, its
    term and what bounds it ("bytes" or "operations")."""
    from repro_torch.core.constants import PAD_TOKEN

    n, l = tokens.shape
    inside = torch.arange(l, device=tokens.device)[None, :] < lengths.to(torch.int64)[:, None]
    valid = inside & (tokens != PAD_TOKEN)
    if method == "next":
        placed_before = valid.cumsum(1) - valid.to(torch.int64)
        inside &= placed_before < b
        valid &= inside
    per_set = valid.sum(1)
    n_valid = int(per_set.sum())
    nbytes = 4 * int(inside.sum()) + 4 * n + 4 * n * (b // 32)
    per_token = (BUILD_OPS["token"] + (BUILD_OPS["mix"] if mix else 0)
                 + (BUILD_OPS["probe"] if method == "next" else 0))
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "operations": n_valid * per_token / PEAK_OPS_PER_S * 1e3}
    if method == "next":
        chain = int(per_set.max()) if n else 0
        terms["sequential probes"] = chain / max_sm_clock_hz() * 1e3
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "term": term,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "terms_ms": terms, "bytes": nbytes, "valid_tokens": n_valid}


def time_build(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str) -> dict:
    """The rule's form, the warp form (one warp a set) and the plain
    version in turns (lane, warp, plain, plain, warp, lane; the lane form
    only up to its widest b), device ms each; ``ms_turns`` are the rule's
    form's, with the kernel's launches in the timing."""
    from repro_torch.kernels import bitmap_build, ref

    wrapper = bitmap_build.WRAPPERS[method]
    before = wrapper.launches
    n = tokens.shape[0]
    form = bitmap_build.form(method, b, n)
    forms = ("lane", "warp") if b // 32 <= bitmap_build.LANE_MAX_WORDS else ("warp",)
    run = {f: functools.partial(wrapper, tokens, lengths, b, form=f) for f in forms}
    plain = functools.partial(ref.bitmap_build_ref, tokens, lengths, b, method)
    turns = {f: [cuda_ms(run[f], BUILD["kernel_iters"])] for f in forms}
    p1, p2 = (cuda_ms(plain, BUILD["plain_iters"], warmup=1) for _ in range(2))
    for f in forms[::-1]:
        turns[f].append(cuda_ms(run[f], BUILD["kernel_iters"]))
    return {"form": form, "ms_turns": turns[form], "plain_ms_turns": [p1, p2],
            **{f"{f}_ms_turns": turns[f] for f in forms},
            "timing_launches": wrapper.launches - before}


def build_turns_line(name: str, tt: dict) -> str:
    """One line of (b): each form's and the plain version's times in turns,
    the bound and its terms."""
    forms = ", ".join(f"{f} {tt[f + '_ms_turns'][0]:.4f} / {tt[f + '_ms_turns'][1]:.4f}"
                      for f in ("lane", "warp") if f + "_ms_turns" in tt)
    return (f"{name}: rule's form {tt['form']}; {forms}, plain {tt['plain_ms_turns'][0]:.4f} / "
            f"{tt['plain_ms_turns'][1]:.4f} ms (in turns; {tt['timing_launches']} kernel "
            f"launches); bound {tt['bound_ms']:.5f} ms ({tt['term']}: "
            + ", ".join(f"{k} {v:.5f}" for k, v in tt["terms_ms"].items())
            + f"; {tt['bytes']} bytes, {tt['valid_tokens']} valid tokens); the rule's form at "
            f"{tt['bound_ms'] / tt['ms_turns'][0]:.1%} of it")


@contextlib.contextmanager
def counting_plain_generators(calls: list):
    """Record every call of the plain bit-matrix generators inside."""
    from repro_torch.core import bitmap as bm

    saved = dict(bm.GENERATORS)

    def counted(method, fn):
        def run(*args, **kw):
            calls.append(method)
            return fn(*args, **kw)
        return run

    bm.GENERATORS.update({m: counted(m, fn) for m, fn in saved.items()})
    try:
        yield calls
    finally:
        bm.GENERATORS.update(saved)


@contextlib.contextmanager
def plain_bitmap_build():
    """``ops.bitmap_build`` computed by its plain version inside, so a join
    on the card builds its words without the kernel."""
    from repro_torch.kernels import ops, ref

    saved = ops.bitmap_build
    ops.bitmap_build = ref.bitmap_build_ref
    try:
        yield
    finally:
        ops.bitmap_build = saved


def build_words_check(cols: dict) -> dict:
    """(a): the kernel's words against the plain version's, bit for bit;
    returns each method's largest difference."""
    from repro_torch.kernels import bitmap_build, ref

    errs = dict.fromkeys(bitmap_build.WRAPPERS, 0)

    def check(t, l, b, where):
        forms = [None] + [f for f in bitmap_build.FORMS
                          if f == "warp" or b // 32 <= bitmap_build.LANE_MAX_WORDS]
        for method in errs:
            for mix in (False, True):
                want = ref.bitmap_build_ref(t, l, b, method, mix)
                for form in forms:
                    got = bitmap_build.bitmap_build_cuda(t, l, b, method, mix, form=form)
                    err = max_err(got, want)
                    errs[method] = max(errs[method], err)
                    if err or got.shape != (t.shape[0], b // 32):
                        raise AssertionError(f"bitmap_build {method} ({form or 'rule'} form) "
                                             f"{where}, b={b}, mix={mix}: words differ by "
                                             f"up to {err}")

    for name, (t, l) in cols.items():
        for b in BUILD["widths"]:
            check(t, l, b, f"on {name}")
        log(f"phase 25 (a): bitmap_build on {name} ({t.shape[0]} x {t.shape[1]}) equals its "
            f"plain version bit for bit at b={list(BUILD['widths'])}, every method and form "
            f"(the rule's, lane, warp), mix on and off")
    for b in BUILD["edge_widths"]:
        short = 64 if b > 4096 else None
        for n in (0, 1, BUILD["edge_rows"]):
            toks, lens = build_edge_rows(n, b, seed=n, l=short)
            check(torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda(), b,
                  f"at the edges, N={n}")
    log(f"phase 25 (a): the edge rows equal the plain version at b={list(BUILD['edge_widths'])}"
        f" (the lane form up to b={32 * bitmap_build.LANE_MAX_WORDS}), N in (0, 1, "
        f"{BUILD['edge_rows']}), every form (wrapping probes, rows of b and more, PAD inside a "
        f"length, a length past the row, an empty row)")
    return errs


def build_next_join(uniform) -> dict:
    """(c): UNIFORM's self-join at tau = 0.35 through JoinEngine, whose plan
    must be blocked with Bitmap-Next; the path launches bitmap_build_next
    and no plain generator; its pairs equal the same join without the
    bitmap filter, and its pairs and JoinStats a run whose words came from
    the plain version."""
    from repro_torch.core import engine, join
    from repro_torch.kernels import bitmap_build

    tau = BUILD["tau"]
    eng = engine.JoinEngine(uniform, MAIN["sim"], tau, device="cuda")
    plan = eng.plan
    if plan.driver != "blocked" or plan.method != "next":
        raise AssertionError(f"UNIFORM tau={tau} planned {plan.describe()}")
    counts = LaunchCounts(**bitmap_build_wrappers())
    plain_calls: list = []
    with counting_plain_generators(plain_calls):
        # The path: counters zeroed just before, read just after.
        counts.zero()
        (pairs, stats), cold = _timed(lambda: eng.self_join(return_stats=True))
        warm_out, warm = _timed(lambda: eng.self_join(return_stats=True))
        launches, all_forms = counts.read(), counts.read_forms()
    forms = all_forms["bitmap_build_next"]
    log(f"phase 25 (c) path launches: {json.dumps(launches)}, Next by form {forms}; plain "
        f"generator calls {len(plain_calls)}")
    if (plain_calls or launches["bitmap_build_next"] <= 0 or launches["bitmap_build_set"]
            or launches["bitmap_build_xor"]):
        raise AssertionError(f"the tau={tau} join must build its words with bitmap_build_next "
                             f"only: {launches}, plain generators {plain_calls}")
    want_form = bitmap_build.form("next", plan.b, uniform.num_sets)
    if want_form != "lane" or forms["warp"] or forms["lane"] != launches["bitmap_build_next"]:
        raise AssertionError(f"the tau={tau} join must run Next's lane form (the rule gives "
                             f"{want_form}): {forms}")
    record_build_launches(launches, all_forms, "phase 25 (c)")
    _same((pairs, stats), warm_out, f"UNIFORM tau={tau} cold vs warm")

    (nf_pairs, nf_stats), nf_s = _timed(lambda: join.blocked_bitmap_join_prepared(
        eng.prepared, sim=MAIN["sim"], tau=tau, b=plan.b, block=plan.block,
        method=plan.method, mix=plan.mix, compaction="device", use_bitmap=False,
        return_stats=True))
    if not np.array_equal(pairs, nf_pairs):
        raise AssertionError(f"UNIFORM tau={tau}: {len(pairs)} pairs with the filter, "
                             f"{len(nf_pairs)} without")
    prep = engine.prepare(uniform, "cuda")
    with plain_bitmap_build():
        plain_eng = engine.JoinEngine(prep, MAIN["sim"], tau, plan=plan, device="cuda")
        counts.zero()
        plain_out, plain_s = _timed(lambda: plain_eng.self_join(return_stats=True))
        if sum(counts.read().values()):
            raise AssertionError(f"the plain-words run launched the kernel: {counts.read()}")
    words = eng.prepared.bitmap_words(plan.b, plan.method, mix=plan.mix)
    err = max_err(words, prep.bitmap_words(plan.b, plan.method, mix=plan.mix))
    if err:
        raise AssertionError(f"the join's Next words differ from the plain version's by {err}")
    _same((pairs, stats), plain_out, f"UNIFORM tau={tau} kernel words vs plain words")
    log(f"phase 25 (c): UNIFORM {uniform.num_sets} sets, tau={tau} {plan.driver} "
        f"b={plan.b} method={plan.method} block={plan.block}: cold {cold:.3f} s (incl. the "
        f"bitmap build), warm {warm:.3f} s, {len(pairs)} pairs = the join without the filter "
        f"({nf_s:.3f} s, candidates {nf_stats.candidates}) = the join over the plain "
        f"version's words ({plain_s:.3f} s cold, JoinStats identical); stats "
        f"{json.dumps(stats.to_dict())}")
    return {"cold_s": cold, "warm_s": warm, "pairs": len(pairs), "stats": stats.to_dict(),
            "no_filter_s": nf_s, "plain_words_cold_s": plain_s, "form_launches": forms}


def phase_bitmap_build(zipf, uniform, seed: int) -> list[dict]:
    """Phase 25: the bitmap build's kernel on phase 4's collections, (a)
    words, (b) timing, (c) the join through Next; returns rows
    ``bitmap_build_set``, ``_xor`` and ``_next``."""
    t_phase = time.perf_counter()
    cols = {name: (torch.from_numpy(col.tokens).cuda(), torch.from_numpy(col.lengths).cuda())
            for name, col in (("ZIPF", zipf), ("UNIFORM", uniform))}
    errs = build_words_check(cols)

    timing = {}
    for b in BUILD["widths"]:
        for method in errs:
            t, l = cols["ZIPF"]
            timing[(method, b)] = time_build(t, l, b, method) | build_bound(t, l, b, method)
            log(build_turns_line(f"phase 25 (b) ZIPF b={b} {method}", timing[(method, b)]))
    t, l = cols["UNIFORM"]
    uni_next = time_build(t, l, MAIN["b"], "next") | build_bound(t, l, MAIN["b"], "next")
    log(build_turns_line(f"phase 25 (b) UNIFORM b={MAIN['b']} next (the join's words)",
                         uni_next))
    serving = {}
    for rows in BUILD["serving_rows"]:
        toks, lens = build_serving_batch(zipf, rows, seed)
        t, l = torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda()
        serving[rows] = time_build(t, l, WIDE_B, "xor") | build_bound(t, l, WIDE_B, "xor")
        log(build_turns_line(f"phase 25 (b) serving-shaped ZIPF batch {rows} x {t.shape[1]} "
                             f"b={WIDE_B} xor", serving[rows]))
    del cols
    join_rec = build_next_join(uniform)

    for method in ("set", "xor"):
        if not BUILD_LAUNCHES[f"bitmap_build_{method}"]:
            raise AssertionError(f"no join path of phases 4-8 launched bitmap_build_{method}")
    paths = {"set": "phases 4-8: every join path's bitmap build (Set: UNIFORM tau = 0.5)",
             "xor": "phases 4-8: every join path's bitmap build (Xor: ZIPF, SKEWED, the "
                    "store, serving)",
             "next": f"phase 25 (c): UNIFORM tau = {BUILD['tau']} blocked self-join, cold "
                     f"and warm"}
    rows = []
    for method in errs:
        main_t = timing[(method, MAIN["b"])]
        rows.append(kernel_row(
            f"bitmap_build_{method}", BUILD_SOURCE, BUILD_REPLACES[method], err=errs[method],
            ms=main_t["ms_turns"][0], plain_ms=main_t["plain_ms_turns"][0],
            bound=(main_t["bound_ms"], main_t["bound_by"]), path=paths[method])
            | {"shape": f"ZIPF {zipf.num_sets} x {zipf.tokens.shape[1]}, b={MAIN['b']}",
               "form": main_t["form"], "warp_form_ms": main_t["warp_ms_turns"][0],
               "ms_turns": main_t["ms_turns"], "plain_ms_turns": main_t["plain_ms_turns"],
               "lane_ms_turns": main_t["lane_ms_turns"],
               "warp_ms_turns": main_t["warp_ms_turns"],
               "bound_term": main_t["term"], "bound_terms_ms": main_t["terms_ms"],
               f"at_b{WIDE_B}": timing[(method, WIDE_B)],
               **({"at_uniform_join": uni_next, "join": join_rec}
                  if method == "next" else {}),
               **({"at_serving": {str(r): v for r, v in serving.items()}}
                  if method == "xor" else {})})
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s (budget {BUILD['budget_s']} s)")
    return rows


def phase_bitmap_build_alone(seed: int) -> list[dict]:
    """Phase 25 without phases 4-8 (after ``phase_build()``): phase 4's ZIPF
    and UNIFORM made here, and a stand-in for the Set and Xor launches that
    phases 4-8's paths would record."""
    from repro_torch.data.collections import uniform_collection, with_duplicates, zipf_collection

    zipf = with_duplicates(zipf_collection(n_sets=100_000, seed=seed), **ZIPF_CLUSTERS,
                           seed=seed)
    uniform = uniform_collection(n_sets=100_000, seed=seed)
    for method in ("set", "xor"):
        BUILD_LAUNCHES[f"bitmap_build_{method}"].setdefault("stand-in for phases 4-8", 1)
    rows = phase_bitmap_build(zipf, uniform, seed)
    log(json.dumps({"kernels": rows}))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh-child", nargs=4, metavar=("DIR", "BACKEND", "RANK", "WORLD"),
                        help=argparse.SUPPRESS)   # one rank of phase 20
    parser.add_argument("--train-child", nargs=5,
                        metavar=("DIR", "BACKEND", "RANK", "WORLD", "MESH"),
                        help=argparse.SUPPRESS)   # one rank of phase 21
    parser.add_argument("--serve-child", nargs=5,
                        metavar=("DIR", "BACKEND", "RANK", "WORLD", "MESH"),
                        help=argparse.SUPPRESS)   # one rank of phase 22 (a)
    parser.add_argument("--dryrun-child", nargs=2, metavar=("DIR", "PART"),
                        help=argparse.SUPPRESS)   # phase 22 (c)
    parser.add_argument("--family-child", nargs=5,
                        metavar=("DIR", "BACKEND", "RANK", "WORLD", "MESH"),
                        help=argparse.SUPPRESS)   # one rank of phase 23 (c)
    parser.add_argument("--ssm-child", nargs=5,
                        metavar=("DIR", "BACKEND", "RANK", "WORLD", "MESH"),
                        help=argparse.SUPPRESS)   # one rank of phase 24
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.mesh_child:
        run_dir, backend, rank, world = args.mesh_child
        mesh_child(Path(run_dir), backend, int(rank), int(world))
        return 0
    if args.train_child:
        run_dir, backend, rank, world, shape = args.train_child
        train_child(Path(run_dir), backend, int(rank), int(world), shape)
        return 0
    if args.serve_child:
        run_dir, backend, rank, world, shape = args.serve_child
        serve_child(Path(run_dir), backend, int(rank), int(world), shape)
        return 0
    if args.dryrun_child:
        dryrun_child(Path(args.dryrun_child[0]), args.dryrun_child[1])
        return 0
    if args.family_child:
        run_dir, backend, rank, world, shape = args.family_child
        family_child(Path(run_dir), backend, int(rank), int(world), shape)
        return 0
    if args.ssm_child:
        run_dir, backend, rank, world, shape = args.ssm_child
        ssm_mesh_child(Path(run_dir), backend, int(rank), int(world), shape)
        return 0
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import engine
    from repro_torch.data.collections import (skewed_collection, uniform_collection,
                                              with_duplicates, zipf_collection)

    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(name: str) -> None:   # each group of phases' wall, for the time budget
        now = time.perf_counter()
        log(f"[wall] {name}: {now - marks[-1][1]:.1f} s (script {now - t_start:.1f} s)")
        marks.append((name, now))

    log(smi_line())
    # The kernels build (nvcc processes, waited on by a thread) while this
    # thread makes the collections on the host.
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(phase_build)
        t0 = time.perf_counter()
        zipf_10k = with_duplicates(zipf_collection(n_sets=10_000, seed=args.seed),
                                   n_clusters=100, cluster_size=3, jaccard=0.9, seed=args.seed)
        skewed_10k = with_duplicates(skewed_collection(n_sets=10_000, seed=args.seed),
                                     n_clusters=100, cluster_size=3, jaccard=0.9, seed=args.seed)
        zipf_base = zipf_collection(n_sets=100_000, seed=args.seed)
        zipf = with_duplicates(zipf_base, **ZIPF_CLUSTERS, seed=args.seed)
        skewed = with_duplicates(skewed_collection(n_sets=100_000, seed=args.seed),
                                 n_clusters=1000, cluster_size=3, jaccard=0.9, seed=args.seed)
        batches = probe_batches(skewed, args.seed)
        uniform = uniform_collection(n_sets=100_000, seed=args.seed)
        log(f"generated ZIPF 10k, SKEWED 10k, ZIPF {zipf.num_sets}, SKEWED {skewed.num_sets}, "
            f"{len(batches)} probe batches and UNIFORM {uniform.num_sets} in "
            f"{time.perf_counter() - t0:.1f} s (set-up, beside the build)")
        build.result()
    mark("build and set-up")
    kernels = phase_dense_kernels(args.seed, engine.prepare(zipf_10k, "cuda"))
    kernels += phase_postings_kernels(args.seed, engine.prepare(skewed, "cuda"))
    phase_bitplane_parity(args.seed)
    mark("phases 1-3")
    launches = phase_slice(zipf_10k, skewed_10k)
    blocked_launches, zipf_pairs, zipf_candidates = phase_full_blocked(zipf, uniform)
    launches.update(blocked_launches)
    indexed_launches, skewed_results = phase_full_indexed(args.seed, skewed, batches)
    launches.update(indexed_launches)
    store_launches, store_ops = phase_store(args.seed, zipf)
    _, serve_call = phase_serve(args.seed, skewed)
    for name, n in store_launches.items():   # the tensor-core verdicts: b = 128 and 1024
        launches[name] += n
    wide = phase_wide_verdict_timing(store_ops)
    for k in kernels:
        if k["name"] in wide:
            k[f"at_b{WIDE_B}"] = wide[k["name"]]
    mark("phases 4-8")
    kernels += phase_bitmap_build(zipf, uniform, args.seed)
    del uniform
    mark("phase 25")
    rows, serve_turns = phase_bitplane_timing(store_ops[0], serve_call)
    kernels += rows
    for k in kernels:
        if k["name"] == "verdict_verify":
            k[f"at_serve_b{WIDE_B}"] = serve_turns
    # The LM phases need the card's memory: release the join phases' tensors.
    del store_ops, serve_call
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 9")
    phase_flash_parity(args.seed)
    mark("flash parity")
    lm_launches, qkv, flash_err = phase_lm(args.seed)
    launches.update(lm_launches)
    kernels.append(phase_flash_timing(qkv, flash_err))
    del qkv
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 10")
    for phase in (phase_flash_small_d, phase_flash_f32):
        phase_launches, rows = phase(args.seed)
        launches.update(phase_launches)
        kernels.extend(rows)
        gc.collect()
        torch.cuda.empty_cache()
    mark("phase 11")
    training, bwd_row = phase_train(args.seed)
    kernels.append(bwd_row)
    launches["flash_attention_bwd"] = training["bwd_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 12")
    _, dedup_launches = phase_cpu_and_dedup(args.seed, zipf_base, zipf, zipf_pairs)
    mark("phase 13")
    kernels.extend(phase_flash_d112(args.seed))
    ssm_serving, serve_launches = phase_ssm_serving(args.seed)
    hybrid_training, train_launches = phase_hybrid_train(args.seed)
    launches.update(serve_launches)
    launches.update(train_launches)
    log(json.dumps({"ssm_serving": ssm_serving, "hybrid_training": hybrid_training}))
    moe_serving, moe_launches = phase_family_serving(args.seed, ("phi3.5-moe-42b-a6.6b",
                                                                 "arctic-480b"))
    va_serving, va_launches = phase_family_serving(args.seed, ("llama-3.2-vision-11b",
                                                               "musicgen-medium"))
    mark("phases 14-16")
    family_training, fwd_train_launches, bwd_train_launches = phase_family_train(args.seed)
    family_serving = {**moe_serving, **va_serving}
    log(json.dumps({"family_serving": family_serving, "family_training": family_training}))
    by_path = {"flash_attention": {**moe_launches, **va_launches, **fwd_train_launches},
               "flash_attention_bwd": bwd_train_launches}
    launches.update({name: sum(by_path.values()) for name, by_path in BUILD_LAUNCHES.items()})
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in BUILD_LAUNCHES:   # row 10: the join paths of phases 4-8 and 25
            k["launches_by_path"] = dict(BUILD_LAUNCHES[k["name"]])
            k["path_form_launches"] = dict(BUILD_FORMS[k["name"]])
        if k["name"] == "flash_attention":
            k["training"] = training
        if k["name"] in dedup_launches:   # rows 1-2: their launches on the dedup path too
            k["launches_by_path"] = {k["path"]: k["launches"],
                                     "dedup": dedup_launches[k["name"]]}
        if k["name"] in by_path:          # rows 9 and 9d: phases 17-19's paths too
            k["launches_by_path"] = {k["path"]: k["launches"], **by_path[k["name"]]}
            k["at_family_shapes"] = {
                arch: res[key] for arch, res in (family_serving if k["name"] ==
                                                 "flash_attention" else family_training).items()
                for key in ("kernel_timing", "bwd_timing") if key in res}
    gc.collect()
    torch.cuda.empty_cache()
    mark("phases 17-19")
    kernels += phase_mesh_drivers(zipf, zipf_pairs, zipf_candidates, skewed, skewed_results,
                                  batches)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 20")
    sharded, sharded_launches = phase_sharded_train(args.seed)
    for k in kernels:
        if k["name"] in sharded_launches:   # rows 9 and 9d: phase 21's ranks too
            k.setdefault("launches_by_path", {k["path"]: k["launches"]})
            k["launches_by_path"].update(sharded_launches[k["name"]])
    log(json.dumps({"sharded_training": sharded}))
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 21")
    serving, launch_tooling, serve_launches = phase_sharded_serving_and_dryrun(args.seed)
    mark("phase 22")
    for k in kernels:
        if k["name"] in serve_launches:     # row 9: phase 22's ranks too
            k.setdefault("launches_by_path", {k["path"]: k["launches"]})
            k["launches_by_path"].update(serve_launches[k["name"]])
    log(json.dumps({"sharded_serving": serving, "launch_tooling": launch_tooling}))
    # Phase 23 needs the card's memory for one single-device model's training
    # state and then for 4 ranks: the join phases' collections and results go.
    del zipf_base, zipf, skewed, batches, zipf_pairs, zipf_candidates, skewed_results
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    log(f"{smi_line()}; this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
        f"card before phase 23")
    offset = phase_flash_offset(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    families, family_launches = phase_family_mesh(args.seed)
    for k in kernels:
        if k["name"] in family_launches:    # rows 9 and 9d: phase 23's ranks too
            k.setdefault("launches_by_path", {k["path"]: k["launches"]})
            k["launches_by_path"].update(family_launches[k["name"]])
        if k["name"] == "flash_attention":
            k["at_query_offsets"] = offset
    log(json.dumps({"query_offset": offset, "families_over_a_mesh": families}))
    log(f"phase 23: {time.perf_counter() - t23:.1f} s (budget 240 s)")
    mark("phase 23")
    gc.collect()
    torch.cuda.empty_cache()
    ssm_mesh, ssm_launches = phase_ssm_mesh(args.seed)
    for k in kernels:
        if k["name"] in ssm_launches:       # rows 9 and 9d: phase 24's ranks too
            k.setdefault("launches_by_path", {k["path"]: k["launches"]})
            k["launches_by_path"].update(ssm_launches[k["name"]])
    log(json.dumps({"ssm_and_hybrid_over_a_mesh": ssm_mesh}))
    mark("phase 24")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
