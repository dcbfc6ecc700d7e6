"""Smoke run of the PyTorch port (vidgraph_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, each failing the run on error:

1. setup: the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from ``vidgraph_tpu_torch/csrc``;
2. the cosine top-k kernels against their plain PyTorch versions on the
   card, on a 200,000 x 512 float32 store made from ``--seed`` (count
   199,937), B in {1, 16, 30}, k in {1, 5, 64}, k above the count and a
   count below one tile: scores within 1e-5, indices equal where the
   neighbouring scores are more than 1e-5 apart, no masked row above
   -1e29; then median times over 20 runs (CUDA events), of the whole
   top-k and of each of its two kernels alone;
3. the main path, between a reset and a read of the launch counts:
   ``kg`` on the card from ``tests/golden/vlm_output_golden.json`` must
   rebuild ``tests/golden/pipeline_golden.json`` exactly, and ``kg`` with
   ``config/high_recall_config.yaml`` must launch the dense scoring (its
   graph must equal the CPU build's, checked after the read); then
4. the bench's reference-scale graph (600 entities, 326 chunks, 1,600
   relations; ``bench.py::_build_graph``) and its 5 warm-up and 30 timed
   queries through hybrid retrieval with vector search, post-compression
   and rerank must launch the top-k kernels at least once per query; the
   plain version must not have served.  After the read: top-5 searches of
   a 200,000-row store, and the same queries on the CPU, which must give
   the same retrieval texts;
5. the CLI in subprocesses: ``kg`` -> ``batch-retrieve`` -> ``benchmark``
   with ``config/high_recall_config.yaml`` and NetworkX ACS;
6. the FlashAttention kernel against its plain version on the card, at
   the chat LM's serving shapes (b in {1, 8, 32} x T = 2056, 8 heads of
   64, bf16, nv = 8), a ragged T = 1033 and T = 40 < nv + 64: within
   ``TOL_ABS + TOL_REL * |plain|`` (``ops/flash_attention.py``); then
   median times of both (CUDA events);
7. the on-device chat LM (``backend.llm: tpu``) at ``CaptionerConfig.
   chat()`` width, with seed-initialised weights written to an npz in the
   JAX format: ``config/tpu_llm_config.yaml`` (checkpoint and graph store
   pointed at a temp dir), through the CLI in subprocesses, ``kg`` on the
   golden vlm output -> ``batch-retrieve`` -> ``benchmark``, and one
   ``benchmark`` with ``config/judge_tpu_config.yaml`` (judge on the chat
   LM).  Random weights write no parseable triplet, so a second ``kg``
   serves the same weights with a planted byte bigram
   (``plant_bigram``), whose grounded triplet must reach the graph
   through a refinement dispatch.  Each subprocess reports its launch
   counts at exit; after the ``kg`` runs and after the benchmarks the
   flash kernel must have launched at least once per layer per dispatch
   and the plain version served no call;
8. the kernel inside the model: one b_pad 8 dispatch's prefill logits,
   with the kernel and with the plain version, within ``LOGIT_TOL``, and
   equal first tokens wherever the top-2 margin exceeds it;
9. the preprocessing kernel against its plain version: 5 and 160 frames
   of 405 x 720 (what ``io/video.py::resize_max_dim`` makes of 16:9
   video) -> 224 in the fast (bf16) and exact (float32) modes, 224^2
   (normalise only) and 120 x 160 -> 224, within ``ops/preprocess.py``'s
   tolerances; the device's time per call (``graph_ms``, 20 calls replayed
   from a CUDA graph: at these sizes CUDA events around one call mostly
   time the host's launch) of the kernel, the plain version and a library
   yardstick the port never calls
   (``F.interpolate(bilinear, antialias=True)`` and the affine), the
   CUDA-event median of a call of the kernel's wrapper, and of the uint8
   upload;
10. the short-attention kernel (tensor cores) against its plain version
   at B in {1, 5, 160} frames x 12 heads x N 50 x hd 64, bf16, and at B 5
   and 160 on the ViT's strided views of one qkv product; device times of
   both and of ``F.scaled_dot_product_attention`` as the yardstick, and
   the wrapper's call time;
11. the vision path (``backend.vlm: tpu``) at full width:
   ``ViTConfig.b32()`` and ``CaptionerConfig.base()`` with seed weights
   written as a JAX-format npz and loaded through ``vlm.checkpoint_path``
   (``preprocess: device``, ``fast_resize: true``, 256 new bytes).  No
   video is decoded on the card's machine, so the frame seam is replaced: in
   ``vidgraph_tpu_torch.pipeline.vlm_extractor``'s namespace only,
   ``iter_chunk_frames`` and ``count_chunks`` become a numpy source of 6
   chunks of 5 RGB uint8 frames at 405 x 720, drawn as
   ``io/video.py::write_synthetic_video`` draws them (a background of 30,
   one coloured moving square per scene).  Everything from
   ``VLMExtractor.process_video`` on is the real path.  It runs twice, with
   the default ``attn_impl='einsum'`` (through ``make_vlm_client``) and
   with ``'fused'``, each between a reset and a read of the launch counts:
   the preprocessing kernel at least once per chunk, the short-attention
   kernel 12 times per chunk in fused mode and never in einsum mode, the
   flash kernel 8 times per chunk, and no plain version.  After the reads:
   the two modes' embeddings agree (cosine >= 0.999); one chunk with every
   kernel and with every plain version (``preprocess_ref``, the einsum
   tower and the plain prefill) gives embeddings with cosine >= 0.999 and
   first-token logits within ``VISION_LOGIT_TOL``, and the logits of a
   planted fault (the short-attention kernel without its ``1/sqrt(hd)``
   scale) are read beside them; ``kg`` -> ``batch-retrieve`` run on the
   written ``vlm_output.json`` as subprocesses, and the ViT and
   ``generate`` are timed;
12. the w8a16 kernel (``ops/q8_matmul.py``) against its plain version on
   the card: the eight (K, N) of the block matrices of
   ``CaptionerConfig.large()`` and ``base()`` x M in ``Q8_CHECK_M``,
   plus a column of zeros (the scale's floor, 1e-8) and |x| up to 1e3:
   max |err| <= 1e-4 x max |plain|, two runs equal bit for bit, and the
   bfloat16 output equal to the float32 output's ``.to(bfloat16)``.
   Then device times per call (``graph_ms``; every call of a replay reads
   another copy of the weights, 20 copies, so that the weights of
   ``large()`` come from device memory as they do in a decode) of the
   kernel (float32 and bfloat16 out), the plain version, the plain
   ``a16`` expression, and two yardsticks the port never calls: cuBLAS
   ``x_bf16 @ w_bf16`` and ``torch._weight_int8pack_mm`` (null where this
   torch does not run it); and the wrapper's host time a call;
13. quantised serving at full width: seed weights for ``ViTConfig.b32()``
   and ``CaptionerConfig.large()`` in bfloat16, written as a JAX-format
   npz and loaded by ``TPUVLMClient(checkpoint=..., param_dtype=bfloat16,
   quantize=...)``.  (i) ``quantize`` None, ``int8`` and ``int8_a8`` each
   caption two synthetic chunks; the int8 tree holds under 0.55 of the
   bf16 tree's bytes.  (ii) The int8 tree with ``qmode='a16p'`` through
   ``generate`` at B = 4 and 8, 64 new bytes, between a reset and a read
   of the counts: the kernel's launches equal 4 products x 24 layers x the
   decode steps, plus the prefill's when its B x 9 rows are at most 64,
   and the plain version serves nothing; one ``wdot(a16p)`` product at
   each of a ``large()`` layer's four shapes (M 8, bf16 out), captured
   into a CUDA graph, is one kernel node, the q8 kernel's, and nothing
   else.  (iii) Teacher-forced ``forward``
   logits (one sequence a call, 40 rows): each int8 mode against bf16 by
   cosine, ``a16p`` against ``a16`` within ``Q8_LOGIT_TOL``, and a planted
   fault (the kernel without its scale) past it.  (iv) ms/step and
   tokens/s of the four modes at B = 8 and 32
   (``scripts/profile_torch_int8_decode.py::bench_decode``), and ``a16p``'s
   kernel launches a decode step at B = 8 from one profiled call, whose
   q8 kernels on the device number 96 a decode step.  (v) The
   CLI's ``vlm`` with ``vlm.quantize: int8`` at ``base()`` width on phase
   11's frame source;
14. the FlashAttention backward kernels (``flash_bwd_delta``,
   ``flash_bwd_fused``, ``flash_bwd_dq_convert``: one pass, five products)
   and the forward's log-sum-exp
   against their plain versions (``attention_bwd_ref``, ``lse_ref``; one
   batch row at a time, so that the plain [h, T, T] tensors stay small) at
   the shapes the training paths launch: B 8 x T 3080 and B 16 x T 1544 at
   8 heads x 64 (``CaptionerConfig.chat()``, both buckets of the instruct
   trainer), B 16 x T 1032 at 16 x 64 (the mid-scale config), T 1033 at
   16 x 128, T 40 and 1033 with nv 0 and 8, and prefixes of 64, 70 and
   100 (T 64, 130, 200): dq, dk, dv within
   ``TOL_ABS + TOL_REL * |plain|`` and ``BWD_REL_FRO`` of the plain
   gradient's norm, two runs' dk and dv equal bit for bit and their float32
   dq accumulators within ``DQ_RUN_REL`` of its norm (atomics add in no
   fixed order), and a planted fault (the plain backward without
   ``delta``) outside the tolerance.  Then CUDA-event medians at the three
   training shapes: the forward with its residual, each backward kernel
   and the three together, the plain backward, and
   ``F.scaled_dot_product_attention`` forward + backward under autograd
   with the boolean prefix mask (the yardstick, never called by the port);
15. training at full width through the trainers' ``main``: (a)
   ``scripts/train_torch_instruct_lm.py`` at ``CaptionerConfig.chat()``
   width, ``--seq-len 3072 --batch 8 --flash``, 12 steps, on the golden
   vlm output plus synthetic captions with the dataset counts of
   ``--smoke``: between a reset and a read of the counts, the forward and
   both backward kernels launch once per layer per step (the forward also
   for the held-out evaluations and the eval's prefills) and the plain
   attention serves nothing; the held-out loss is finite and lower at the
   end; the first batch's loss and the gradient of every leaf with the
   kernels against the masked einsum with remat from the same weights
   (max |diff| / max |plain| < ``TRAIN_GRAD_TOL`` per leaf), and a planted
   fault (the attention output cut from the graph, as it was before the
   kernels had a backward) past it; the saved ``instruct_lm.npz`` then
   serves one completion through ``make_chat_client("tpu")``.  (b)
   ``scripts/train_torch_midscale.py --flash --steps 12`` at the 204M
   config (batch 16 x 1024), then 12 steps with the masked einsum and
   remat from the same seed (the same weights, batches and schedule): step
   time, tokens/s, MFU against 989 TFLOP/s, peak memory, the bf16 round
   trip; the two runs' first four losses within ``MIDSCALE_LOSS_TOL``, and
   every leaf's gradient at the mid-scale width (16 heads x 1024, a batch
   of 4 x 1024 windows) with the kernels against einsum + remat within
   ``TRAIN_GRAD_TOL``.  (c) ``models/train.py::TrainState`` at
   ``ViTConfig.b32()`` + ``CaptionerConfig.base()`` width, B 8, 3 steps on
   one batch: the loss falls;
16. ACS, the device sweep as torch ops (``pipeline/acs.py``, no kernel of
   its own): on ``bench.py``'s ``barabasi_albert_graph(926, 2, seed=0)``
   (the edge list of ``tests/torch_jax_draws.json``), ``_louvain`` with
   the port's masks (JAX's stream) gives the JAX package's labels and
   community count, its modularity within ``LOUVAIN_Q_TOL``;
   ``update_metrics`` under ``acs.backend: auto`` takes the device sweep
   and returns no ``error`` and JAX's Louvain count and rounded
   modularity; every other metric equals exact
   NetworkX (the port's ``networkx`` backend with sampling off) within
   ``tests/test_acs.py``'s tolerances, the others within
   ``ACS_OTHER_TOL``.  Then ms of a full metric pass (``_compute``, the
   mean of 3 after a warm-up) with the device sweep
   (``acs_full_metrics_ms_926n``, ``bench.py``'s key) and with the
   ``networkx`` backend as ``auto`` would run it, at 926 nodes and on
   Barabási–Albert graphs of 64, 96, 128, 256 and 512 nodes: where
   ``auto`` would switch on this card.

17. the live multi-stream runtime at full width (``backend.vlm: tpu``:
   ViT-B/32 + ``CaptionerConfig.base()`` from seed 0, 256 new bytes; the
   hash embed client), driven by ``scripts/measure_torch_stream_scaling.py``'s
   ``run`` on numpy frame sources of 240 x 320 at 30 fps, 1 s chunks of 5
   frames, a query to every stream each 0.5 video-seconds.  First the
   kernels at the stream's shapes against their plain versions:
   preprocessing of 5, 40 and 80 frames of 240 x 320 (fast and exact),
   the flash prefill at B 1, 8 and 16 (nv 8 + BOS), the top-k on a 1024-row
   memory holding 0, 1, k - 1 and 300 rows (and an empty memory's search
   launches nothing), with times and bounds.  Then, between a reset and a
   read of the launch counts, ``STREAM_SECONDS`` of video on 1 stream and
   on 8 as fast as the card allows (the 8 with a ``LiveKGIngestor`` on the
   local chat client) and on 8 paced by the wall clock: every stream
   completes chunks, every query's hits are its own stream's chunks (and
   a query with one of a stream's captions finds that chunk), each
   unpaced 8-stream batch captions 8 chunks (a paced one up to 16: two
   windows a stream, the lag limit), every live graph holds nodes after
   ``flush``, the preprocessing kernel launches at least once and the
   flash kernel once a layer per batch, the top-k kernels serve the
   queries, and no plain version serves.  After the read: one batch of 8
   chunks' tokens against each chunk's own B = 1 tokens, equal or (first
   differing step printed) a near-tie under ``CAPTION_TIE_TOL`` of the
   B = 1 context's logits; and one ``process_ready`` of 8 chunks profiled
   (launches, device busy share).  Prints realtime and throughput factor,
   coverage, shed chunks, dropped frames, chunk latency p50, query p50
   and p95 under load (from the query's arrival to its answer, the
   caption batch it waits behind included) and the engine's own query
   service time (``query_p50_ms``, ``query_p95_ms``);
18. the HTTP server (``services/server.py::VideoMemoryServer``) in-process
   on an ephemeral port on the card: 240 ``/v1/ingest`` over 4 streams, 24
   ``/v1/query``, 4 ``/v1/retrieve`` on ``bench.py::_build_graph``'s graph
   exported and imported under uuid ``bench``, ``/v1/stats``; then the
   same session on the CPU: every response's keys equal, query hits equal
   (ties in any order, scores within ``TOL``), retrieved texts equal.
   Prints the request p50 by route;
19. the trained encoders at their default widths with the port's seeded
   weights, on the card against the same module on the CPU: the
   transformer text embedder (bf16 at B 8/64/256 within ``ENC_BF16_TOL``,
   float32 at B 8 within ``ENC_F32_TOL``), the cross-encoder reranker
   (``RerankerConfig()``, 8/16/32 pairs), ms a call and the device's busy
   share; bench's retrieval with ``backend.embedder: transformer`` and
   ``backend.reranker: trained`` (its p50 and p95 over bench's 30 queries
   after its 5 warm-ups, and how many of the first ``ENC_CPU_QUERIES``
   texts equal a CPU run's); the
   answer selector in ``blend`` and ``pure`` modes on four of those
   contexts: answers equal to the CPU's;
20. the encoder trainers through their ``main`` at the JAX scripts'
   default widths on ``training_corpus``:
   ``scripts/train_torch_reranker.py`` (``RerankerConfig()``, 8 groups x
   12 documents a step), ``train_torch_answer_selector.py``
   (``RerankerConfig(max_len=256)``, 8 lists x K 64) and
   ``train_torch_text_embedder.py`` (256 x 4 layers, dim 512, bf16, 128
   documents of 384 + 128 query views of 96), ``ENC_TRAIN_STEPS`` each:
   the loss is finite and falls (the mean of the last quarter of the
   steps below the first quarter's); the loss of a fixed batch from the
   seed weights on the card equals the CPU's within ``TRAINER_LOSS_TOL``
   (float32); the saved checkpoint serves through the port's
   ``CrossEncoderReranker``, ``AnswerSelector`` and
   ``make_embed_client("transformer", checkpoint_path=...)``.  Prints
   each trainer's ms a step, peak memory, and one step's ms and device
   busy share;
21. the tooling: ``scripts/profile_torch_vit.py --attn`` at B = 160
   (720p frames) between a reset and a read of kernels 2 and 5 (no plain
   version serves), then both kernels held to their plain versions at
   its shapes (its frames; the first block's qkv of the fused tower) and
   timed; one epoch of ``scripts/run_torch_parameter_sweep.py`` from
   ``config/high_recall_config.yaml`` on ``sweep_workload`` (215
   synthetic lab captions of 8 sentences and 30 questions grounded in
   them: the size of the reference's workload) through the CLI in
   subprocesses (each stage as ``chip_smoke.py --cli``, which
   writes its launch counts): the epoch succeeds and launches kernel 1
   (dense in ``kg``, top-k a query in ``batch-retrieve``), no plain
   version; then
   ``scripts/run_torch_judge_agreement.py`` on that epoch's retrieval
   results (its 30 questions) with the chat LM at
   ``CaptionerConfig.chat()`` width from seed weights on the card: kernel 3a launches at least once a layer a
   judged question, no plain version.  Between the sweep and the judge,
   ``scripts/repro_torch_best_config.sh`` reruns the epoch's config on the
   same workload: its ``REPRO RESULT`` statistics must equal the epoch's;
22. the multi-device layer (``parallel/``) on the one card.  (1) NCCL at
   a world of one, ``mesh.enabled: true``, each check between a reset and
   a read of the launch counts, no plain version serving: the
   ``ShardedEmbeddingStore`` on phase 2's 200,000 x 512 store (top-5 at B
   1 and 16, ids equal to ``EmbeddingStore``'s, kernel 1 launched), bench's
   hybrid retrieval through the mesh (texts equal to one card's), one
   ``TPUChatClient`` dispatch at ``chat()`` width of 64 new bytes (texts
   equal to one card's, the flash kernel once a layer), and one
   ``TrainState`` step at ViT-B/32 + ``base()`` over the mesh (loss within
   1e-5 of the one-device state's).  (2) Four gloo ranks, each computing
   on ``cuda:0`` (``parallel/launch.py``; the kernels are built before
   they start): the store split 4 ways (ids equal to one card's, kernel 1
   launched on every rank), the chat decode at ``chat()`` width over
   ``model_axis=2``, 16 new bytes (every byte equal to one card's, or
   at the first differing step a near-tie of one card's teacher-forced
   logits under ``CAPTION_TIE_TOL``; the flash kernel once a layer on
   every rank), ``base()`` blocks over 2 pipeline
   stages at B 8 x T 128 (within ``PIPE_TOL`` of the sequential stack) and
   the MoE at the dry-run's sizes (within 1e-5).  Prints the world-1
   sharded search's ms beside the one-card store's, and the gloo ranks'
   times as one card's, not a multi-card number;
23. ``stream`` and ``serve`` under the rank-0 leader
   (``parallel/leader.py``) at phase 17's width (``backend.vlm: tpu``,
   ViT-B/32 + ``base()`` from seed 0, the hash embed client, phase 17's
   numpy frames), captions cut to ``LEADER_NEW_BYTES`` new bytes.  First
   one card's references: phase 17's engine on 4 streams x
   ``STREAM_SECONDS`` of 240 x 320 unpaced with its queries, and phase
   18's server session with a fifth stream of ``LEADER_LONG_ROWS`` chunks
   (past the first of its memory's two data shards) and 4 queries of it.
   (1) NCCL at a world of one, ``mesh.enabled: true``: the
   ``RankedEngine`` on the same streams between a reset and a read of the
   launch counts (kernel 2 at least once a batch, 3a once a layer a
   batch, kernel 1 for the queries, no plain version), its table equal to
   one card's, every caption equal or a near-tie under
   ``CAPTION_TIE_TOL`` (the first differing step printed), hits equal;
   the session through ``RankedServer``, responses equal to one card's
   (``same_hits``).  (2) Four gloo ranks on ``cuda:0``
   (``run_ranks``, the kernels built before) on a (2 data, 2 model)
   mesh: the same stream run (rank 0's table, captions and hits equal to
   (1)'s; every follower's captions and memories equal rank 0's; kernels
   2 and 3a on every rank, no plain version), a ``LEADER_PACED_SECONDS``
   paced run (the followers hold what the leader kept), the session
   (responses equal to (1)'s; kernel 1 on every rank's shard).  Prints
   the steps and bytes broadcast, the leader's ms a message and a
   follower's wait, an 8-stream step's broadcast timed alone, query p50
   and p95 under load, and request p50 by route; the gloo numbers are one
   card's, not a multi-card time.
24. seeded draws: ``core/prng.py`` on the card against the JAX package's
   ``jax.random`` on the CPU, from ``tests/torch_jax_draws.json``
   (``tests/make_torch_jax_draws.py``): threefry bits and a
   Bernoulli(0.5) mask equal, normals and truncated normals within
   ``SEEDED_ULP`` (the bit-equal share printed), and ViT-B/32 +
   ``CaptionerConfig.base()`` from seed 0 leaf by leaf (shape, float64
   sum and sum of squares within what ``SEEDED_ULP`` allows, the first 16
   values within it; bit-equal leaves counted by hash), with the trees'
   draw time on the card (cold and warm) beside the host ``torch.randn``
   draw the port made before.  Then the CLI's ``vlm`` at the shipped
   config (no checkpoint: the weights from seed 0) on ``SEEDED_CHUNKS``
   of ``synthetic_chunks``' frames between a reset and a read of the
   launch counts (kernel 2 once a chunk, 3a once a layer a chunk, no
   plain version), and its captions beside the JAX package's at the same
   seed on the CPU: equal rows, and each other row's logit gap at its
   first differing byte.  The captions are reported, not gated: with
   random weights near-ties are common.
25. kernel domains: kernels 1 and 2 at the inputs their TPU kernels take
   and the port once refused, each held to its plain version with the
   tolerances of phases 2 and 9 and timed (kernel, plain version,
   library yardstick, bound); the timed calls' launches are reported
   apart (``kernel1_timing_calls``, ``kernel2_timing_calls``: no plain
   version serves) and stay out of the kernels record, which takes only
   the launches of the paths below, each path between a reset and a read
   of the counts.  Kernel 1: top-k at k 65, 100, 256 and 1000 (the dense
   scores and a stable sort) at B 1 and 16 on a
   200,000 x 512 float32 store whose row 10 is copied across tile and
   segment boundaries (a query of it gets the copies in row order); d
   1000, 2560 and 4096 on 20,000 rows (top-5 and dense); the
   ``EmbeddingStore`` mirror of the 200,000 rows in float32, bfloat16 and
   float16 (its ``torch.cuda.memory_allocated`` bytes: a 16-bit mirror
   half the float32's; top-5 at B 1 / 16 and top-100 against the plain
   version on the rounded rows upcast) and ``search(k=100)`` on each
   equal to a CPU store's (``hits_match``: ids equal where the scores are
   more than ``TOL`` apart); bench's
   retrieval with ``rerank_pool: 100`` and the trained reranker: bench's
   30 queries on the card after its warm-up queries, timed one by one,
   and the first ``DOMAIN_QUERIES`` on the CPU, texts equal to the card's
   or their 100-chunk pools equal (the reranker's near-ties).  Kernel 2:
   5 frames of 2160 x 3840, 3840 x 2160, 4320 x 7680 and 1081 x 1921 ->
   224, fast
   and exact (strips of output columns; 4K and 8K with bands of more
   than 32 source rows), and
   ``TPUVLMClient(preprocess="device")`` captioning one chunk of five 4K
   frames: kernel 2 once, no plain version.

26. attention domains: kernels 3, 4 and 5 at the inputs their TPU
   kernels take and the port once refused.  Paths, each between a reset
   and a read of the counts: ``TPUVLMClient(preset="tiny64", seed=0)``
   (float32, 4 heads of 32) captions 4 chunks on the card through the
   general forward (tokens equal to ``generate(..., flash=False)`` on the
   card; against the port's CPU caption of the same frames, which the CPU
   tests hold to the JAX package's: a differing row's teacher-forced
   logits within ``TINY64_LOGIT_TOL`` and its first differing byte a
   near-tie under ``TINY64_TIE``); ``train_torch_instruct_lm.py --smoke
   --flash`` (2 heads of 32, bf16) for ``SMOKE_TRAIN_STEPS`` steps, the
   general forward and backward, its first loss within
   ``SMOKE_LOSS_TOL`` of the einsum path's; the tiny64 tower with
   ``attn_impl='fused'`` (kernel 5's general route, within 1e-5 of the
   einsum tower).  Then 3a and 3b/3c at hd 32 and 80 in float32 and
   bfloat16 (B 2 x T 1033 x 8 heads) and at B x h = 65,600 (T 9, bf16 hd
   64 on the wgmma kernels, float32 hd 32 on the general ones) against
   the plain versions, kernel 5 at hd 32 float32 N 5, N 257 and 1025
   bfloat16 and hd 80, kernel 4 at M 65 and 200 (one launch a 64-row
   slab), each timed beside its bound, its plain version and the library
   call (SDPA, cuBLAS bf16).

27. decode attention: kernel D on the paths that reach it, each between
   a reset and a read of the counts: ``generate`` of the ``large()``
   captioner at B 1 (the ingest cell's decode) and
   ``generate_from_tokens`` of the chat LM at B 1 after a 4,000-token
   prompt, both under the profiling spans (launches and the decode
   span's ``attn_kernel_calls`` both layers x steps, no plain call).
   Then the kernel against its plain version at ``large()`` B 1 x 16 x
   265 x 128 and ``chat()`` B 1 x 8 x 4,096 x 64 (bf16, ragged mask;
   the cache writes bit-equal, ``o`` within the dtype's tolerance), timed
   beside the plain chain, SDPA at q-length 1 and its bound.

``--phases 14,15,16,17,18,19,20,21,22,23,24,25,26,27`` runs only the
named phases of 14-27 (with the build): a partial run prints no kernels record and no
``ok`` line.

The last three lines: the kernels' JSON record (``seconds`` last: the
run's time from before the build), the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  Each
kernel's entry carries its launches on the main path, its max |error|
against its plain version, the times of the kernel, the plain version and
a library call (``library_ms``, or null; CUDA-event medians, and for the
two vision kernels the device's time per call from a CUDA graph of 20
calls, with ``call_ms`` the CUDA-event median of a call of the wrapper),
and ``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
its operations over the card's peak for their type (989 TFLOP/s bf16, 67
TFLOP/s float32).  Without a CUDA card, or outside a checkout, it exits nonzero and prints no result.
``tiktoken`` is kept out of every phase: its encoder would be fetched over
the network; without it the token splitter uses its calibrated estimator.

``python3 chip_smoke.py --cli COUNTS.json <command> [args]`` is the
subprocess side of phase 7: the port's CLI ``main`` with the launch counts
and chat-LM dispatches written to ``COUNTS.json`` at exit.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import hashlib
import itertools
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
STORE_ROWS, STORE_COUNT, DIM = 200_000, 199_937, 512
# phase 2: the selection kernel's k (past the lists) on the dense scores
SELECT_K = (100, 1000)
# phase 8: bf16 prefill logits with and without the kernel (8 layers of
# one-ulp differences in the attention output; logits of about unit scale)
LOGIT_TOL = 0.05
# phase 11: first-token logits with every kernel and with every plain
# version.  On an H100 80GB HBM3 (700 W) the two sides' embeddings agreed
# bit for bit and the logits (max |logit| 1.45) differed by 0.0078, the
# flash prefill's share; the planted fault (short attention without its
# 1/sqrt(hd) scale) moved them by 0.85.  The limit sits between the two,
# and the run fails if the planted fault does not exceed it.
VISION_LOGIT_TOL = 0.05
# phase 13: teacher-forced logits of the int8 tree at CaptionerConfig.
# large() width, 24 layers deep.  The kernel (a16p) rounds a product to
# bf16 once, the plain a16 expression twice: on an H100 80GB HBM3 (700 W)
# the two differed by 0.047 at a logit scale of 3.4, and the planted fault
# (the kernel without its scale) moved the logits by 3.2; the limit sits
# between, and the run fails if the fault does not exceed it.  The cosines
# against the bf16 tree read 0.99953 (a16), 0.99954 (a16p), 0.99916 (a8).
Q8_LOGIT_TOL = 0.1
Q8_COSINE_MIN = 0.998
# phase 13: the same bf16 logits with the flash kernel (16 heads of 128,
# T = 40) and with the plain attention, 24 layers deep: 0.031 apart at a
# logit scale of 3.4 on an H100 80GB HBM3 (700 W).
LARGE_FLASH_LOGIT_TOL = 0.1
# phase 14: ||kernel - plain||_F <= BWD_REL_FRO x ||plain||_F per gradient
# (the gradients of late rows are far below TOL_ABS, so the elementwise
# tolerance alone would pass much there)
BWD_REL_FRO = 2e-2
# phase 14: two runs' float32 dq accumulators (atomics add in no fixed
# order): ||a - b||_F <= DQ_RUN_REL x ||a||_F
DQ_RUN_REL = 1e-6
# phase 15: per-leaf gradients of the training loss with the kernels and
# with the masked einsum + remat, max |diff| / max |plain| (the limit of the
# JAX package's own flash-vs-einsum gradient test on its chip)
TRAIN_GRAD_TOL = 0.05
# phase 15b: |loss_flash - loss_einsum_remat| over the mid-scale runs' first
# four steps (same seed: same weights, batches and schedule).  The two
# differ by bf16 products in another order: the logits by bf16 rounding
# (~1e-4 on a step's loss), which Adam's first updates, near lr x sign(g),
# may carry into the next steps' weights.  0.01 stays far below what one
# update moves the loss (~0.8 at step 2), so a wrong gradient cannot pass
MIDSCALE_LOSS_TOL = 0.01
# phase 16: the metrics tests/test_acs.py does not name, device sweep vs
# exact NetworkX (both exact; rounded to 4 decimals)
ACS_OTHER_TOL = 1e-3
# phase 16: Louvain's modularity on the card against the JAX package's on
# the CPU (integer sums until one float32 division, the same masks)
LOUVAIN_Q_TOL = 1e-6
# H100 SXM peaks (NVIDIA's data sheet): memory, bf16 and float32 dense
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
MESH_RANKS = 4
CUDA = torch.device("cuda")
# phase 22: base() blocks through 2 pipeline stages against the sequential
# stack, bf16 compute (the same products in the same order on one card)
PIPE_TOL = 2e-3
_TIKTOKEN_BLOCK = ('raise ImportError("tiktoken is kept out of this run: its '
                   'encoder would be fetched over the network")\n')


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2
def check_topk(tc, q, store, k, count) -> float:
    """Kernel top-k against the plain version; returns the max |error|."""
    vals, idx = tc.cosine_topk(q, store, k, count=count)
    torch.cuda.synchronize()
    rv, ri = tc.cosine_topk_ref(q, store, k + 1, count=count)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    err = float(np.abs(vals - rv[:, :k]).max())
    assert err <= TOL, f"B={q.shape[0]} k={k}: score error {err}"
    padded = np.concatenate([np.full((rv.shape[0], 1), np.inf), rv,
                             np.full((rv.shape[0], 1), -np.inf)], axis=1)
    for j in range(k):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        assert (idx[apart, j] == ri[apart, j]).all(), \
            f"B={q.shape[0]} k={k}: index mismatch at rank {j}"
    masked = idx >= count
    assert not (vals[masked] > -1e29).any(), "a masked row scored above -1e29"
    return err


def phase_kernels(tc, seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms

    rng = np.random.default_rng(seed)
    host = rng.normal(size=(STORE_ROWS, DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    queries = torch.from_numpy(
        rng.normal(size=(30, DIM)).astype(np.float32)).cuda()
    topk_err = 0.0
    for b in (1, 16, 30):
        for k in (1, 5, 64):
            topk_err = max(topk_err, check_topk(tc, queries[:b], store, k,
                                                STORE_COUNT))
    check_topk(tc, queries[:4], store, 5, 3)        # k above the count
    check_topk(tc, queries[:4], store, 64, 100)     # count below one tile
    # one launch a search up to a launch's queries
    for b, k in ((1, 5), (16, 5), (30, 64)):
        tc.reset_counts()
        tc.cosine_topk(queries[:b], store, k, count=STORE_COUNT)
        assert tc.LAUNCHES == {"score_topk": 1, "score_dense": 0,
                               "select": 0}, (b, k, tc.LAUNCHES)
    dense = tc.cosine_scores(queries[:16], store, count=STORE_COUNT)
    torch.cuda.synchronize()
    dense_ref = tc.cosine_scores_ref(queries[:16], store, count=STORE_COUNT)
    score_err = float((dense - dense_ref).abs().max())
    assert score_err <= TOL, f"dense score error {score_err}"
    log(f"phase 2: kernel agrees with the plain version: top-k max |err| "
        f"{topk_err:.3e}, dense max |err| {score_err:.3e}")

    times = {}
    for b in (1, 16):
        q = queries[:b]
        times[f"topk_b{b}_k5"] = {
            "kernel_ms": cuda_ms(
                lambda: tc.cosine_topk(q, store, 5, count=STORE_COUNT)),
            # the device's time alone: a CUDA-event median of one call
            # also holds the wrapper's host launch
            "device_ms": graph_ms(
                lambda: tc.cosine_topk(q, store, 5, count=STORE_COUNT)),
            "plain_ms": cuda_ms(
                lambda: tc.cosine_topk_ref(q, store, 5, count=STORE_COUNT)),
            # context, not the plain version: an unordered-ties top-k
            "matmul_topk_ms": cuda_ms(lambda: torch.topk(
                tc.cosine_scores_ref(q, store, count=STORE_COUNT), 5)),
        }
    q = queries[:16]
    times["dense_b16"] = {
        "kernel_ms": cuda_ms(
            lambda: tc.cosine_scores(q, store, count=STORE_COUNT)),
        "device_ms": graph_ms(
            lambda: tc.cosine_scores(q, store, count=STORE_COUNT)),
        "plain_ms": cuda_ms(
            lambda: tc.cosine_scores_ref(q, store, count=STORE_COUNT)),
    }
    stages = time_topk_stages(tc, queries[:16], store)
    past = torch.arange(STORE_ROWS, device="cuda") >= STORE_COUNT
    library = {
        "topk_b1_k5": cuda_ms(lambda: library_topk(q[:1], store, past, 5)),
        "topk_b16_k5": cuda_ms(lambda: library_topk(q, store, past, 5)),
        "dense_b16": cuda_ms(lambda: library_scores(q, store, past)),
    }
    log(f"phase 2 times on {card} (median of 20, ms) at 200,000 x 512 f32:",
        json.dumps(times), json.dumps(stages), "library:",
        json.dumps(library))
    return {"topk_err": topk_err, "score_err": score_err, "times": times,
            "stages": stages, "library": library}


def library_scores(q, store, past):
    """The library yardstick of the dense mode: ``F.normalize`` and one
    matrix product (a 16-bit store upcast first), the rows ``past`` the
    count masked."""
    scores = F.normalize(q, dim=-1) @ store.float().T
    return scores.masked_fill_(past, -1e30)


def library_topk(q, store, past, k):
    """The library yardstick of the top-k: ``torch.topk`` over the
    masked cosine scores."""
    return torch.topk(library_scores(q, store, past), k)


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_topk_stages(tc, q, store, k: int = 5) -> dict:
    """Each kernel of the top-k apart, at B=16: ``cosine_score_tile`` in
    top-k mode at k 5 (its lists, read from the launch's scratch, against
    ``topk_partials_ref``; its last block's merge against
    ``topk_merge_ref`` on those lists, bit for bit; the whole against
    ``cosine_topk_ref``), and ``cosine_select`` at k 100 and 1000 on the
    dense scores (bit for bit against ``select_ref``), each with the
    plain version's time, the library call's and the bound."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms

    b = q.shape[0]
    tile = tc.segment_rows(store.shape[0], store.device)
    vals, idx, pv, pi = tc.topk_lists(q, store, k, STORE_COUNT)
    torch.cuda.synchronize()
    rv, _ = tc.topk_partials_ref(q, store, k, STORE_COUNT, tile)
    assert torch.equal(pv.isinf(), rv.isinf()), "partials past the store"
    finite = ~rv.isinf()
    partial_err = float((pv[finite] - rv[finite]).abs().max())
    assert partial_err <= TOL, f"top-k partials error {partial_err}"
    mv, mi = tc.topk_merge_ref(pv, pi, k)
    assert torch.equal(vals, mv) and torch.equal(idx, mi), \
        "the last block's merge disagrees with topk_merge_ref"
    past = torch.arange(STORE_ROWS, device="cuda") >= STORE_COUNT
    out = {"score_topk_b16_k5": {
        "max_abs_err": check_topk(tc, q, store, k, STORE_COUNT),
        "kernel_ms": cuda_ms(
            lambda: tc.topk_lists(q, store, k, STORE_COUNT)),
        "device_ms": graph_ms(
            lambda: tc.topk_lists(q, store, k, STORE_COUNT)),
        "plain_ms": cuda_ms(
            lambda: tc.cosine_topk_ref(q, store, k, count=STORE_COUNT)),
        "partials_plain_ms": cuda_ms(
            lambda: tc.topk_partials_ref(q, store, k, STORE_COUNT, tile)),
        "merge_plain_ms": cuda_ms(lambda: tc.topk_merge_ref(pv, pi, k)),
        "partial_max_abs_err": partial_err,
        **topk_bound(STORE_COUNT, DIM, 4, b, k)}}
    scores = tc.cosine_scores(q, store, count=STORE_COUNT)
    for kk in SELECT_K:
        assert_select_exact(tc, scores, kk)
        out[f"select_b{b}_k{kk}"] = {
            "max_abs_err": 0.0,
            "kernel_ms": cuda_ms(lambda: tc.select_topk(scores, kk)),
            "device_ms": graph_ms(lambda: tc.select_topk(scores, kk)),
            "plain_ms": cuda_ms(lambda: tc.select_ref(scores, kk)),
            "library_ms": cuda_ms(lambda: torch.topk(scores, kk)),
            # the scores read once, the k values and columns written
            **bound(scores.numel() * 4 + b * kk * 8, 0.0, F32_FLOPS)}
    out["library_topk_b16_k5"] = cuda_ms(
        lambda: library_topk(q, store, past, k))
    return out


# ---------------------------------------------------------------- phases 3-4
def build_kg(device: str, recall: bool):
    """``kg`` in-process on ``device`` from the golden vlm output, with the
    golden recipe's settings or with ``config/high_recall_config.yaml``,
    whose pre-injector scores each batch against the chunk memory."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph import open_graph_store
    from vidgraph_tpu_torch.pipeline.kg_builder import KGBuilder

    os.environ["VIDGRAPH_TORCH_DEVICE"] = device
    vlm_path = ROOT / "tests/golden/vlm_output_golden.json"
    with tempfile.TemporaryDirectory() as tmp:
        old = os.getcwd()
        os.chdir(tmp)
        try:
            if recall:
                cfg = PipelineConfig.from_yaml(
                    str(ROOT / "config/high_recall_config.yaml"))
                cfg.acs.backend = "networkx"
            else:
                cfg = PipelineConfig()
                cfg.backend.llm = "local"
                cfg.kg.batch_size = 2
            cfg.graph_store.persist_dir = "gs"
            asyncio.run(KGBuilder(cfg, run_uuid="golden")
                        .build_knowledge_graph(str(vlm_path)))
            store = open_graph_store(cfg, "golden")
        finally:
            os.chdir(old)
    assert store._chunk_emb.device.type == device
    return store


def graph_of(store) -> tuple:
    return (sorted(store.entities), sorted("|".join(k) for k in store.rels),
            sorted(store.chunks), store.get_chunk_counts())


def phase_golden(device: str = "cuda") -> None:
    golden = json.loads((ROOT / "tests/golden/pipeline_golden.json")
                        .read_text())
    store = build_kg(device, recall=False)
    assert graph_of(store) == (golden["entities"], golden["rels"],
                               golden["chunk_ids"], golden["chunk_counts"])
    assert [e["name"] for e in store.fulltext_search_entities(
        "red shape object", 3)] == golden["fulltext_top"]
    log("phase 3: golden rebuild on the card matches "
        "tests/golden/pipeline_golden.json")


def bench_retriever(device: str, embedder_kind: str = "tpu",
                    reranker_kind: str = "tpu", rerank_pool: int = 0):
    """bench.py's reference-scale graph on ``device``, behind a hybrid
    retriever set as ``bench.py:93-95`` sets it (``retrieval.rerank_pool``
    as given), and its 30 queries; the chunks embedded and the queries
    served by the ``backend.embedder`` and ``backend.reranker`` kinds
    given."""
    import bench
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu_torch.pipeline.retriever_hybrid import HybridRetriever
    from vidgraph_tpu_torch.services.embed_client import make_embed_client
    from vidgraph_tpu_torch.services.rerank_client import make_rerank_client

    os.environ["VIDGRAPH_TORCH_DEVICE"] = device
    rng = random.Random(42)
    cfg = PipelineConfig()
    cfg.retrieval.entity_first = False
    cfg.retrieval.post_compression = True
    cfg.retrieval.rerank_after_traversal = True
    cfg.retrieval.rerank_pool = rerank_pool
    embedder = make_embed_client(embedder_kind,
                                 dim=cfg.embedding_memory.dim)
    reranker = make_rerank_client(reranker_kind, embed_client=embedder)
    store = EmbeddedGraphStore("bench", persist_dir=None, persist=False)
    bench._build_graph(store, embedder, rng)
    assert store._chunk_emb.device.type == device
    retriever = HybridRetriever(cfg.retrieval, store, embedder, reranker,
                                output_file=None)
    queries = [f"What color is the {rng.choice(bench._OBJECTS)} "
               f"{rng.choice(['on the bench', 'in the lab', 'nearby'])}?"
               for _ in range(bench.N_QUERIES)]
    return retriever, store, queries


def bench_retrieval(device: str, embedder: str = "tpu",
                    reranker: str = "tpu", queries: int = 0,
                    warmup: int = -1) -> dict:
    """bench.py's 30 queries after its 5 warm-up queries, timed one by
    one; the CPU comparisons of the trained encoders take the first
    ``queries`` after ``warmup`` warm-ups instead."""
    import bench

    retriever, store, asked = bench_retriever(device, embedder, reranker)
    asked = asked[:queries or len(asked)]
    warmup = bench.WARMUP if warmup < 0 else warmup

    async def run_all():
        for q in asked[:warmup]:
            await retriever.perform_hybrid_retrieval(q)
        texts, times = [], []
        for q in asked:
            t = time.perf_counter()
            text, _ = await retriever.perform_hybrid_retrieval(q)
            times.append((time.perf_counter() - t) * 1e3)
            texts.append(text)
        return texts, times

    texts, times = asyncio.run(run_all())
    times.sort()
    return {"texts": texts, "queries": asked,
            "p50_ms": statistics.median(times),
            "p95_ms": times[int(0.95 * (len(times) - 1))],
            "entities": len(store.entities), "chunks": len(store.chunks),
            "rels": len(store.rels)}


def store_search_ms(seed: int) -> dict:
    """Top-5 search of the port's EmbeddingStore at the bench's 200k rows,
    host clock around calls that end with the results on the host."""
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore

    rng = np.random.default_rng(seed + 1)
    store = EmbeddingStore(dim=DIM, capacity=STORE_ROWS)
    step = 20_000
    for i in range(0, STORE_ROWS, step):
        store.add([f"c{j}" for j in range(i, i + step)],
                  rng.normal(size=(step, DIM)).astype(np.float32))
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    out = {}
    for b in (1, 16):
        store.search(q[:b], k=5)
        times = []
        for _ in range(20):
            t = time.perf_counter()
            hits = store.search(q[:b], k=5)
            times.append((time.perf_counter() - t) * 1e3)
        assert len(hits) == b and all(len(h) == 5 for h in hits)
        out[f"b{b}_ms"] = statistics.median(times)
    return out


def launch_counts(tc) -> dict:
    return {**tc.LAUNCHES, "plain": tc.REF_CALLS}


def take_counts(tc, into: dict) -> None:
    """Add kernel 1's launch counts to ``into`` and set them to 0."""
    for key, n in launch_counts(tc).items():
        into[key] = into.get(key, 0) + n
    tc.reset_counts()


def phase_main_path(tc, seed: int) -> dict:
    """The main path on the card, ``kg`` and then retrieval, between a
    reset and a read of the launch counts; the store timing and the CPU
    reference run only after the read."""
    import bench

    tc.reset_counts()
    phase_golden("cuda")
    recall_graph = graph_of(build_kg("cuda", recall=True))
    kg = launch_counts(tc)
    cuda = bench_retrieval("cuda")
    total = launch_counts(tc)
    retrieval = {key: total[key] - kg[key] for key in total}
    log(f"phase 3-4: launches in kg {kg}, in retrieval {retrieval}")
    assert kg["score_dense"] > 0, f"kg launched no dense scoring: {kg}"
    n_searches = bench.WARMUP + bench.N_QUERIES
    assert retrieval["score_topk"] >= n_searches, \
        f"{n_searches} queries but launches {retrieval}"
    assert total["plain"] == 0, f"the plain version served {total}"
    assert all(cuda["texts"]), "an empty retrieval text"

    store_ms = store_search_ms(seed)
    log(f"phase 4: bench-scale retrieval on the card: "
        f"{cuda['entities']} entities, {cuda['chunks']} chunks, "
        f"{cuda['rels']} relations; p50 {cuda['p50_ms']:.3f} ms, "
        f"p95 {cuda['p95_ms']:.3f} ms; 200k-row store top-5 search "
        f"{json.dumps(store_ms)}")
    assert graph_of(build_kg("cpu", recall=True)) == recall_graph, \
        "the recall-config graph differs from the CPU build"
    log(f"phase 3: recall-config kg on the card: {len(recall_graph[0])} "
        f"entities, {len(recall_graph[1])} relations, "
        f"{len(recall_graph[2])} chunks, equal to the CPU build")
    cpu = bench_retrieval("cpu")
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    same = sum(a == b for a, b in zip(cuda["texts"], cpu["texts"]))
    assert same == len(cpu["texts"]), \
        f"{len(cpu['texts']) - same} retrieval texts differ from the CPU run"
    log(f"phase 4: all {same} retrieval texts equal the CPU run's")
    return {"launches": total, "p50_ms": cuda["p50_ms"],
            "p95_ms": cuda["p95_ms"], "store_ms": store_ms}


# ------------------------------------------------------------------ phase 5
def phase_cli(device: str = "cuda") -> None:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "block").mkdir()
        (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
        cfg = tmp / "cfg.yaml"
        cfg.write_text((ROOT / "config/high_recall_config.yaml").read_text()
                       + "\nacs:\n  backend: networkx\n")
        queries = tmp / "queries.json"
        queries.write_text(json.dumps([
            {"query": "What color is the object?", "groundtruth": "red"},
            {"query": "What do the frames contain?",
             "groundtruth": "a static scene"}]))
        env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": device,
               "PYTHONPATH": os.pathsep.join(
                   [str(tmp / "block"), str(ROOT),
                    os.environ.get("PYTHONPATH", "")])}

        def cli(*args) -> str:
            res = subprocess.run(
                [sys.executable, "-m", "vidgraph_tpu_torch.cli.main", *args],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=300)
            assert res.returncode == 0, \
                f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
            return res.stdout

        out = cli("kg", "--config", str(cfg), "--vlm-output",
                  str(ROOT / "tests/golden/vlm_output_golden.json"))
        uuid = out.strip().rsplit("UUID: ", 1)[1]
        cli("batch-retrieve", "--config", str(cfg), "--graph-uuid", uuid,
            "--input", str(queries), "--output", "results.json")
        cli("benchmark", "--config", str(cfg), "--input", "results.json",
            "--output", "bench.json")
        results = json.loads((tmp / "results.json").read_text())
        assert len(results) == 2 and all(
            {"query", "groundtruth", "retrieval", "retrieval_time"}
            <= set(r) and r["retrieval"] for r in results), results
        stats = json.loads((tmp / "bench.json").read_text())
        assert set(stats) == {"statistics", "results"}
        assert stats["statistics"]["total_queries"] == 2
        log(f"phase 5: CLI kg -> batch-retrieve -> benchmark on the card: "
            f"uuid {uuid}, statistics {json.dumps(stats['statistics'])}")


# ------------------------------------------------------------------ phase 6
# (B, T, heads, head dim): the chat LM's and base()'s 8 x 64, then the 16 x
# 128 of CaptionerConfig.large() at the shapes phase 13 gives the kernel
# (generate's prefill of nv + BOS = 9 at B 4/8/32, sequence_logits' T = 40)
# and one long T.
FLASH_SHAPES = [(1, 2056, 8, 64), (8, 2056, 8, 64), (32, 2056, 8, 64),
                (4, 1033, 8, 64), (4, 40, 8, 64),
                (4, 9, 16, 128), (8, 9, 16, 128), (32, 9, 16, 128),
                (1, 40, 16, 128), (1, 2056, 16, 128)]


def phase_flash(seed: int, card: str) -> dict:
    """The flash kernel against ``attention_ref`` at the serving shapes,
    then CUDA-event medians of both at T = 2056."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed + 2)
    rows = {}
    for b, t, h, hd in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        got = fa.flash_attention(q, k, v, 8)
        torch.cuda.synchronize()
        ref = fa.attention_ref(q, k, v, 8).to(torch.bfloat16).float()
        err = (got.float() - ref).abs()
        excess = float((err - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max())
        assert bool(torch.isfinite(got).all()) and excess <= 0, \
            f"flash b={b} T={t} heads {h} x {hd}: max |err| " \
            f"{float(err.max())} over tolerance"
        row = {"max_abs_err": float(err.max())}
        del got, ref, err
        if t == 2056:
            row["kernel_ms"] = cuda_ms(
                lambda: fa.flash_attention(q, k, v, 8))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attention_ref(q, k, v, 8), reps=5 if b > 8 else 20)
            row.update(library_sdpa(q, k, v, fa.prefix_causal_mask(
                t, 8, q.device)))
        rows[f"b{b}_T{t}" + ("" if hd == 64 else f"_h{h}x{hd}")] = row
        del q, k, v
        torch.cuda.empty_cache()
    log(f"phase 6: flash kernel within {fa.TOL_ABS} + {fa.TOL_REL} x |plain| "
        f"of the plain version at 8 heads x 64 and 16 x 128 (keys "
        f"_h16x128), bf16, nv 8; times on {card} (median, ms): "
        f"{json.dumps(rows)}")
    return rows


def device_kernels(fn) -> list:
    """The names of the device kernels that ``fn()`` runs (three calls
    traced): which backend served a library call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name[:80] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def graph_node_types(fn) -> list:
    """The node types of ``fn()`` captured into a CUDA graph after a
    warm-up call (``CU_GRAPH_NODE_TYPE_*``: 0 a kernel, 1 a copy, 2 a
    memset): every piece of device work it issues, whichever library
    issues it, read from the driver's graph, not from a profiler."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def library_sdpa(q, k, v, mask) -> dict:
    """``F.scaled_dot_product_attention`` on [B, T, h, hd] inputs (as
    [B, h, T, hd] views) with a boolean mask: its median time, the
    backends that accept the call, and the device kernels that PyTorch's
    default choice ran."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vidgraph_tpu_torch.core.profiling import cuda_ms

    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    accepted = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
            torch.cuda.synchronize()
            accepted.append(backend.name)
        except RuntimeError:
            pass
    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    return {"library_ms": cuda_ms(sdpa, reps=10),
            "library_backends": accepted,
            "library_kernels": device_kernels(sdpa)}


# ------------------------------------------------------------------ phase 7
def cli_with_counts(counts_path: str, argv) -> int:
    """Subprocess side of phase 7: the port's CLI, then its launch counts
    into ``counts_path``."""
    from vidgraph_tpu_torch.cli.main import main as cli_main
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    Path(counts_path).write_text(json.dumps({
        "rc": rc, "seconds": time.perf_counter() - t0,
        "flash": fa.LAUNCHES["flash_fwd"], "flash_plain": fa.REF_CALLS,
        "topk": {**tc.LAUNCHES, "plain": tc.REF_CALLS}}))
    return rc


_DISPATCH_LOG = re.compile(r"decode dispatch b=(\d+)\(pad (\d+)\) "
                           r"t_pad=(\d+) max_new=(\d+): ([\d.]+)s")


def dispatches(stderr: str) -> list:
    """(b, b_pad, t_pad, max_new, seconds) of each chat-LM dispatch that
    ``TPUChatClient`` logged."""
    return [(*map(int, m.groups()[:4]), float(m.group(5)))
            for m in _DISPATCH_LOG.finditer(stderr)]


def chat_config(tmp: Path, name: str, checkpoint: Path) -> Path:
    """``config/<name>`` with the chat LM's checkpoint and the graph store
    pointed into ``tmp``; nothing else changed."""
    import yaml

    data = yaml.safe_load((ROOT / "config" / name).read_text())
    data["llm_injector"]["checkpoint_path"] = str(checkpoint)
    data["graph_store"]["persist_dir"] = str(tmp / "graph_store")
    out = tmp / f"{checkpoint.stem}_{name}"
    out.write_text(yaml.safe_dump(data))
    return out


# The byte chain of ``plant_bigram``: ``view| dark| dark`` lines, words of
# the golden captions, so that the refiner's grounding guard keeps them.
_PLANTED = {"\n": "v", "v": "i", "i": "e", "e": "w", "w": "|", "|": " ",
            " ": "d", "d": "a", "a": "r", "r": "k", "k": "|"}


def on_host(tree):
    """A parameter tree (dicts and lists of tensors) moved to the host."""
    if isinstance(tree, dict):
        return {k: on_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [on_host(v) for v in tree]
    return tree.cpu()


def plant_bigram(params: dict) -> dict:
    """Seed weights with a byte bigram planted, so that extraction writes
    a parseable, grounded triplet after a prompt's final newline and
    ``kg`` reaches refinement: each byte of ``_PLANTED`` gets a large
    zero-mean embedding direction of its own, and the head maps it to the
    byte's successor (``k``: ``|``, or a newline where the grammar forbids
    ``|``).  Everything else stays random."""
    tok, head = params["tok_emb"].clone(), params["head_w"].clone()
    for i, (byte, nxt) in enumerate(_PLANTED.items()):
        u = torch.zeros(head.shape[0])
        u[2 * i], u[2 * i + 1] = 1.0, -1.0
        tok[ord(byte)] = 30.0 * u
        head[:, ord(nxt)] += 2.0 * u
    head[:, ord("\n")] += tok[ord("k")] / 30.0
    return {**params, "tok_emb": tok, "head_w": head}


def check_flash_path(stage: str, runs, layers: int) -> dict:
    """Flash launches >= layers x dispatches, and no plain-version call,
    over the subprocess runs of one stage."""
    n = sum(len(r["dispatches"]) for r in runs)
    flash = sum(r["flash"] for r in runs)
    plain = sum(r["flash_plain"] for r in runs)
    log(f"phase 7: {stage}: {n} chat-LM dispatches, flash launches {flash}, "
        f"plain-version calls {plain}; top-k launches "
        f"{[r['topk'] for r in runs]}")
    assert n > 0, f"{stage} made no chat-LM dispatch"
    assert flash >= layers * n, f"{stage}: {flash} flash launches for {n} " \
        f"dispatches of {layers} layers"
    assert plain == 0, f"{stage}: the plain attention served {plain} calls"
    return {"dispatches": n, "flash": flash, "plain": plain}


def phase_chat_lm(seed: int) -> dict:
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params

    cfg = CaptionerConfig.chat()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "block").mkdir()
        (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
        ckpt, planted = tmp / "instruct_lm.npz", tmp / "planted_lm.npz"
        params = on_host(init_params(cfg, seed, device=CUDA))
        save_params(params, str(ckpt))
        save_params(plant_bigram(params), str(planted))
        llm_cfg = chat_config(tmp, "tpu_llm_config.yaml", ckpt)
        planted_cfg = chat_config(tmp, "tpu_llm_config.yaml", planted)
        judge_cfg = chat_config(tmp, "judge_tpu_config.yaml", ckpt)
        (tmp / "queries.json").write_text(json.dumps([
            {"query": "What color is the object?", "groundtruth": "red"},
            {"query": "What do the frames contain?",
             "groundtruth": "a static scene"}]))
        env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": "cuda",
               "PYTHONPATH": os.pathsep.join(
                   [str(tmp / "block"), str(ROOT),
                    os.environ.get("PYTHONPATH", "")])}
        env.pop("VIDGRAPH_NO_FLASH_PREFILL", None)

        def cli(*args) -> dict:
            counts = tmp / f"counts_{len(list(tmp.glob('counts_*')))}.json"
            res = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--cli",
                 str(counts), *args], cwd=tmp, env=env,
                capture_output=True, text=True, timeout=600)
            assert res.returncode == 0, \
                f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
            return {**json.loads(counts.read_text()), "stdout": res.stdout,
                    "stderr": res.stderr,
                    "dispatches": dispatches(res.stderr)}

        kg, kg_planted = (
            cli("kg", "--config", str(c), "--vlm-output",
                str(ROOT / "tests/golden/vlm_output_golden.json"))
            for c in (llm_cfg, planted_cfg))
        kg_check = check_flash_path("kg (seed, planted)", [kg, kg_planted],
                                    cfg.layers)
        assert any(d[3] == 768 for d in kg_planted["dispatches"]), \
            "the planted kg made no refinement dispatch"
        uuid = kg["stdout"].strip().rsplit("UUID: ", 1)[1]
        retrieve = cli("batch-retrieve", "--config", str(llm_cfg),
                       "--graph-uuid", uuid, "--input", "queries.json",
                       "--output", "results.json")
        bench = cli("benchmark", "--config", str(llm_cfg), "--input",
                    "results.json", "--output", "bench.json")
        judged = cli("benchmark", "--config", str(judge_cfg), "--input",
                     "results.json", "--output", "bench_judge.json")
        bench_check = check_flash_path("benchmark (chat-LM answers, chat-LM "
                                       "judge)", [bench, judged], cfg.layers)
        for name in ("bench.json", "bench_judge.json"):
            stats = json.loads((tmp / name).read_text())
            assert stats["statistics"]["total_queries"] == 2, stats
        graphs = {}
        for name, run in (("seed", kg), ("planted", kg_planted)):
            snap = json.loads((tmp / "graph_store" / "{}.json".format(
                run["stdout"].strip().rsplit("UUID: ", 1)[1])).read_text())
            graphs[name] = {"entities": len(snap["entities"]),
                            "relations": len(snap["rels"])}
        assert graphs["planted"]["relations"] > 0, graphs
        n_batches = kg["stderr"].count(" injected in ")
        assert n_batches > 0, "kg injected no batch"
        runs = {"kg": kg, "kg (planted)": kg_planted,
                "batch-retrieve": retrieve, "benchmark": bench,
                "benchmark (judge tpu)": judged}
    by_shape: dict = {}
    for run in runs.values():
        for _b, b_pad, t_pad, max_new, secs in run["dispatches"]:
            by_shape.setdefault(f"b_pad {b_pad}, t_pad {t_pad}, max_new "
                                f"{max_new}", []).append(secs)
    per_dispatch = {k: {"n": len(v), "mean_s": statistics.mean(v)}
                    for k, v in sorted(by_shape.items())}
    out = {"kg": kg_check, "benchmark": bench_check,
           "kg_s": kg["seconds"], "kg_batches": n_batches,
           "kg_s_per_batch": kg["seconds"] / n_batches,
           "kg_planted_s": kg_planted["seconds"], "graphs": graphs,
           "s_per_dispatch": per_dispatch,
           "wall_s": {k: r["seconds"] for k, r in runs.items()}}
    log(f"phase 7: backend.llm tpu at CaptionerConfig.chat() width: kg "
        f"{out['kg_s']:.2f} s for {n_batches} batches "
        f"({out['kg_s_per_batch']:.2f} s/batch), planted kg "
        f"{out['kg_planted_s']:.2f} s; graphs {json.dumps(graphs)}; "
        f"s/dispatch "
        f"{json.dumps(per_dispatch)}; CLI wall s {json.dumps(out['wall_s'])}")
    return out


# ------------------------------------------------------------------ phase 8
def phase_prefill_logits(seed: int) -> dict:
    """One b_pad 8 dispatch's prefill at full width, with the kernel and
    with the plain version, from the same seed-initialised weights."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params,
                                                     prefill_logits)

    cfg = CaptionerConfig.chat()
    params = init_params(cfg, seed, device=CUDA)
    golden = json.loads((ROOT / "tests/golden/vlm_output_golden.json")
                        .read_text())["results"]
    prompts = [f"TEXT TO ANALYSE:\n{it['content'] * (1 + 3 * i)}\n\n"
               f"TRIPLET LINES:\n" for i, it in enumerate(golden * 2)]
    t_pad = 2048
    toks = np.full((len(prompts), t_pad), tokenizer.PAD_ID, np.int32)
    last = []
    for r, p in enumerate(prompts):
        ids = tokenizer.encode(p, add_bos=True, add_eos=False)[:t_pad]
        toks[r, :len(ids)] = ids
        last.append(cfg.num_vision_tokens + len(ids) - 1)
    toks = torch.from_numpy(toks).cuda()
    with torch.no_grad():
        flash, _ = prefill_logits(params, cfg, toks, 512, flash=True)
        plain, _ = prefill_logits(params, cfg, toks, 512, flash=False)
    torch.cuda.synchronize()
    err = float((flash - plain).abs().max())
    assert bool(torch.isfinite(flash).all()) and err <= LOGIT_TOL, \
        f"prefill logits differ by {err} > {LOGIT_TOL}"
    rows = torch.arange(len(prompts), device="cuda")
    at = torch.tensor(last, device="cuda")
    lf, lp = flash[rows, at], plain[rows, at]
    top2 = torch.topk(lp, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    same = lf.argmax(-1) == lp.argmax(-1)
    assert bool(same[decided].all()), "a first token differs where the " \
        "top-2 margin exceeds the tolerance"
    out = {"max_abs_err": err, "tol": LOGIT_TOL,
           "first_tokens_equal": int(same.sum()),
           "decided_rows": int(decided.sum()), "rows": len(prompts),
           "logit_scale": float(plain.abs().max())}
    log(f"phase 8: prefill logits with and without the kernel, b_pad 8 x "
        f"t_pad {t_pad} at full width: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phase 9
PRE_SHAPES = [(5, 405, 720, True), (5, 405, 720, False),
              (160, 405, 720, True), (160, 405, 720, False),
              (5, 224, 224, True), (5, 120, 160, True)]


def library_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """The preprocessing's library yardstick, never called by the port:
    ``F.interpolate(bilinear, antialias=True)`` and the CLIP affine."""
    from vidgraph_tpu_torch.ops.preprocess import _mean_std_255

    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size),
                      mode="bilinear", antialias=True, align_corners=False)
    mean, std = _mean_std_255(x.device)
    return (y.permute(0, 2, 3, 1) - mean) / std


def phase_preprocess(seed: int, card: str) -> dict:
    """Kernel A against its plain version at the serving shapes, then
    medians of the kernel, the plain version, the library yardstick and
    the upload of the uint8 frames from (pageable) host memory."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import preprocess as pre

    rng = np.random.default_rng(seed + 3)
    rows = {}
    for b, h, w, fast in PRE_SHAPES:
        host = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        x = torch.from_numpy(host).cuda()
        got = pre.preprocess_frames(x, 224, fast)
        torch.cuda.synchronize()
        ref = pre.preprocess_ref(x, 224, fast)
        tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
        err = float((got.float() - ref.float()).abs().max())
        assert got.dtype == ref.dtype and got.shape == ref.shape, got.shape
        assert bool(torch.isfinite(got).all()) and err <= tol, \
            f"preprocess {b}x{h}x{w} fast={fast}: max |err| {err} > {tol}"
        lib_err = float((library_resize(x, 224)
                         - pre.preprocess_ref(x, 224, False)).abs().max())
        out_bytes = b * 224 * 224 * 3 * got.element_size()

        def kernel():
            return pre.preprocess_frames(x, 224, fast)
        rows[f"b{b}_{h}x{w}_{'fast' if fast else 'exact'}"] = {
            "max_abs_err": err, "tol": tol,
            "kernel_ms": graph_ms(kernel),
            "plain_ms": graph_ms(lambda: pre.preprocess_ref(x, 224, fast)),
            "library_ms": graph_ms(lambda: library_resize(x, 224)),
            "call_ms": cuda_ms(kernel),
            "library_max_abs_diff_vs_exact": lib_err,
            "upload_ms": cuda_ms(lambda: torch.from_numpy(host).cuda()),
            **bound(host.nbytes + out_bytes, 0.0, F32_FLOPS)}
        del x, got, ref
    log(f"phase 9: preprocessing kernel within its tolerances of the plain "
        f"version; times on {card} (ms; device time per call, 20 calls "
        f"replayed from a CUDA graph; call_ms and upload_ms CUDA-event "
        f"medians): {json.dumps(rows)}")
    return rows


# ----------------------------------------------------------------- phase 10
def phase_short_attention(seed: int, card: str) -> dict:
    """Kernel B against its plain version at the ViT's shapes (separate
    tensors, and strided views of one qkv product as ``models/vit.py``
    passes them), then device times of the kernel, the plain version and
    SDPA."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import short_attention as sa

    rng = np.random.default_rng(seed + 4)
    rows = {}
    for name, b, strided in (("b1", 1, False), ("b5", 5, False),
                             ("b160", 160, False), ("b5_strided", 5, True),
                             ("b160_strided", 160, True)):
        if strided:
            qkv = torch.from_numpy(rng.standard_normal(
                (b, 50, 3 * 768), dtype=np.float32)).to("cuda",
                                                       torch.bfloat16)
            q, k, v = (z.reshape(b, 50, 12, 64).transpose(1, 2)
                       for z in qkv.split(768, dim=-1))
        else:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, 12, 50, 64), dtype=np.float32)).to("cuda",
                                                       torch.bfloat16)
                for _ in range(3))
        got = sa.fused_short_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.short_attention_ref(q, k, v).float()
        err = (got.float() - ref).abs()
        excess = float((err - sa.TOL_ABS - sa.TOL_REL * ref.abs()).max())
        assert bool(torch.isfinite(got).all()) and excess <= 0, \
            f"short attention {name}: max |err| {float(err.max())}"

        def kernel():
            return sa.fused_short_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v)
        rows[name] = {
            "max_abs_err": float(err.max()),
            "kernel_ms": graph_ms(kernel),
            "plain_ms": graph_ms(lambda: sa.short_attention_ref(q, k, v)),
            "library_ms": graph_ms(sdpa),
            "library_kernels": device_kernels(sdpa),
            "call_ms": cuda_ms(kernel),
            **bound(4 * b * 12 * 50 * 64 * 2, 4.0 * b * 12 * 50 * 50 * 64,
                    BF16_FLOPS)}
    log(f"phase 10: short-attention kernel within {sa.TOL_ABS} + "
        f"{sa.TOL_REL} x |plain|; times on {card} (ms; device time per call, 20 "
        f"calls replayed from a CUDA graph; call_ms a CUDA-event median), 12 heads x N 50 x hd "
        f"64, bf16: {json.dumps(rows)}")
    return rows


# ----------------------------------------------------------------- phase 11
VISION_CHUNKS, VISION_FRAMES, VISION_HW = 6, 5, (405, 720)
_SCENES = ["red", "green", "blue", "yellow", "magenta", "cyan"]


def synthetic_chunks(n_chunks: int, frames_per_chunk: int,
                     chunk_seconds: float, fps: int = 10):
    """(chunk_idx, time label, [RGB uint8 frames]) as ``iter_chunk_frames``
    yields them, for a video that ``write_synthetic_video`` would write
    with one scene a chunk: a background of 30, a square of the scene's
    colour moving along a sine, at 405 x 720."""
    from vidgraph_tpu_torch.io.video import _COLORS, format_chunk_time

    h, w = VISION_HW
    side = min(h, w) // 2
    offsets = np.linspace(0, int(fps * chunk_seconds) - 1,
                          frames_per_chunk).astype(int)
    for idx in range(n_chunks):
        rgb = _COLORS[_SCENES[idx % len(_SCENES)]]
        frames = []
        for i in offsets:
            frame = np.full((h, w, 3), 30, np.uint8)
            x = int((w - side) * (0.5 + 0.4 * np.sin(i / 5.0)))
            y = (h - side) // 2
            frame[y:y + side, x:x + side] = rgb
            frames.append(frame)
        yield idx, format_chunk_time(idx, chunk_seconds), frames


def vision_counts() -> dict:
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    return {"preprocess": pre.LAUNCHES["preprocess"],
            "short_attention": sa.LAUNCHES["short_attention"],
            "flash": fa.LAUNCHES["flash_fwd"],
            "plain": pre.REF_CALLS + sa.REF_CALLS + fa.REF_CALLS}


def reset_vision_counts() -> None:
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    for mod in (pre, sa, fa):
        mod.reset_counts()


def extract(cfg, client, out: Path) -> dict:
    """``VLMExtractor.process_video`` between a reset and a read of the
    launch counts; returns the counts, the wall time and the output."""
    from vidgraph_tpu_torch.pipeline.vlm_extractor import VLMExtractor

    reset_vision_counts()
    t0 = time.perf_counter()
    asyncio.run(VLMExtractor(cfg, vlm_client=client).process_video(
        "synthetic_405x720.mp4", str(out)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = vision_counts()
    data = json.loads(out.read_text())
    assert set(data) == {"metadata", "results"}, set(data)
    assert set(data["metadata"]) == {"run_id", "video_path", "total_chunks",
                                     "config"}, data["metadata"]
    results = data["results"]
    assert data["metadata"]["total_chunks"] == len(results) == VISION_CHUNKS
    for i, r in enumerate(results):
        assert set(r) == {"time", "content", "chunk_idx", "processing_time"}
        assert r["chunk_idx"] == i and isinstance(r["content"], str)
    return {"counts": counts, "wall_s": wall, "results": results}


def vision_cli(vlm_output: Path, tmp: Path) -> dict:
    """``kg`` -> ``batch-retrieve`` on the written vlm output, as
    subprocesses with ``config/high_recall_config.yaml``."""
    (tmp / "block").mkdir(exist_ok=True)
    (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
    cfg = tmp / "recall.yaml"
    cfg.write_text((ROOT / "config/high_recall_config.yaml").read_text()
                   + "\nacs:\n  backend: networkx\n")
    (tmp / "queries.json").write_text(json.dumps([
        {"query": "What color is the square?", "groundtruth": "red"},
        {"query": "What moves in the frames?", "groundtruth": "a square"}]))
    env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": "cuda",
           "PYTHONPATH": os.pathsep.join(
               [str(tmp / "block"), str(ROOT),
                os.environ.get("PYTHONPATH", "")])}

    def cli(*args) -> str:
        res = subprocess.run(
            [sys.executable, "-m", "vidgraph_tpu_torch.cli.main", *args],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, \
            f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
        return res.stdout

    uuid = cli("kg", "--config", str(cfg), "--vlm-output",
               str(vlm_output)).strip().rsplit("UUID: ", 1)[1]
    cli("batch-retrieve", "--config", str(cfg), "--graph-uuid", uuid,
        "--input", "queries.json", "--output", "results.json")
    results = json.loads((tmp / "results.json").read_text())
    assert len(results) == 2, results
    snap = json.loads((tmp / "graph_store" / f"{uuid}.json").read_text())
    return {"uuid": uuid, "chunks": len(snap.get("chunks", {})),
            "entities": len(snap.get("entities", {}))}


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())


def planted_fault_logits(client, stack, first_logits) -> dict:
    """First-token logits of the fused client with a planted fault: the
    short-attention kernel run without its ``1/sqrt(hd)`` scale (q handed
    over times ``sqrt(hd)``).  They show how far a wrong kernel moves what
    ``VISION_LOGIT_TOL`` holds."""
    from vidgraph_tpu_torch.models import vit

    fused = vit.fused_short_attention

    def unscaled(q, k, v):
        return fused((q * q.shape[-1] ** 0.5).contiguous(), k.contiguous(),
                     v.contiguous())
    vit.fused_short_attention = unscaled
    try:
        emb = client.embed_frames(stack)
    finally:
        vit.fused_short_attention = fused
    sound = client.embed_frames(stack)
    return {"logits": first_logits(emb, True),
            "cosine": cosine_rows(emb, sound)}


def phase_vision(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     generate, init_params,
                                                     vision_prefill)
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.models.vit import (ViTConfig, init_vision_tower,
                                               param_tree)
    from vidgraph_tpu_torch.ops.preprocess import (preprocess_frames,
                                                   preprocess_ref)
    from vidgraph_tpu_torch.pipeline import vlm_extractor
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm_extractor.iter_chunk_frames = (
        lambda path, secs, per_chunk, *a: synthetic_chunks(
            VISION_CHUNKS, per_chunk, secs))
    vlm_extractor.count_chunks = lambda path, secs: VISION_CHUNKS
    tower = init_vision_tower(ViTConfig.b32(), seed, device=CUDA)
    cap = init_params(CaptionerConfig.base(), seed, device=CUDA)
    n_layers_vit, n_layers_cap = tower.cfg.layers, CaptionerConfig.base().layers
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            ckpt = save_params({"vit": param_tree(tower), "cap": cap},
                               str(tmp / "vlm.npz"))
            del tower, cap
            cfg = PipelineConfig()
            cfg.backend.vlm = "tpu"
            cfg.vlm.checkpoint_path = ckpt
            cfg.vlm.preprocess = "device"
            cfg.vlm.fast_resize = True
            einsum = extract(cfg, None, tmp / "vlm_output.json")
            fused_client = TPUVLMClient(
                vit_cfg=ViTConfig(attn_impl="fused"), checkpoint=ckpt,
                preprocess="device", fast_resize=True)
            fused = extract(cfg, fused_client, tmp / "vlm_output_fused.json")
            n = VISION_CHUNKS
            for name, run, attn in (("einsum", einsum, 0),
                                    ("fused", fused, n_layers_vit * n)):
                c = run["counts"]
                log(f"phase 11: {name}: launches {json.dumps(c)} for {n} "
                    f"chunks, wall {run['wall_s']:.3f} s")
                assert c["preprocess"] >= n, f"{name}: {c}"
                assert c["short_attention"] == attn, f"{name}: {c}"
                assert c["flash"] == n_layers_cap * n, f"{name}: {c}"
                assert c["plain"] == 0, f"{name}: a plain version served {c}"
            same = sum(a["content"] == b["content"] for a, b in
                       zip(einsum["results"], fused["results"]))

            client = fused_client
            chunk = next(synthetic_chunks(1, VISION_FRAMES, 5.0))[2]
            stack = np.stack(chunk)
            einsum_tower = type(client.vit)(ViTConfig())
            einsum_tower.load_state_dict(client.vit.state_dict())
            einsum_tower = einsum_tower.cuda().eval()

            def first_logits(emb, flash):
                vis = client.vision_prefixes([chunk], emb)
                return vision_prefill(client._serve_params, client.cap_cfg,
                                      vis, client.max_new, flash=flash)[0]
            with torch.no_grad():
                xin = torch.from_numpy(stack).cuda()
                x = preprocess_frames(xin, 224, fast=True)
                emb_f, emb_e = client.vit(x), einsum_tower(x)
                cos_modes = cosine_rows(emb_f, emb_e)
                assert cos_modes >= 0.999, f"einsum vs fused: {cos_modes}"
                # every kernel (preprocessing, short attention, flash)
                # against every plain version: preprocess_ref, the einsum
                # attention (short_attention_ref's arithmetic) and the
                # plain prefill
                emb_k = client.embed_frames(stack)
                emb_p = einsum_tower(preprocess_ref(xin, 224, fast=True))
                emb_err = float((emb_k - emb_p).abs().max())
                cos_plain = cosine_rows(emb_k, emb_p)
                assert cos_plain >= 0.999, f"kernels vs plain: {cos_plain}"
                lk, lp = first_logits(emb_k, True), first_logits(emb_p, False)
                fault = planted_fault_logits(client, stack, first_logits)
            torch.cuda.synchronize()
            err = float((lk - lp).abs().max())
            assert bool(torch.isfinite(lk).all()) and err <= VISION_LOGIT_TOL, \
                f"first-token logits differ by {err} > {VISION_LOGIT_TOL}"
            fault_err = float((fault["logits"] - lp).abs().max())
            assert fault_err > VISION_LOGIT_TOL, \
                f"a planted fault moved the logits by {fault_err} only"
            top2 = torch.topk(lp, 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > VISION_LOGIT_TOL
            first_same = lk.argmax(-1) == lp.argmax(-1)
            assert bool(first_same[decided].all()), "a first token differs"

            times = {}
            frames160 = np.concatenate([stack] * 32)
            for nf, frames in ((5, stack), (160, frames160)):
                xin = torch.from_numpy(frames).cuda()
                xp = preprocess_frames(xin, 224, fast=True)
                with torch.no_grad():
                    times[f"vit_fused_{nf}_ms"] = cuda_ms(
                        lambda: client.vit(xp), reps=10)
                    times[f"vit_einsum_{nf}_ms"] = cuda_ms(
                        lambda: einsum_tower(xp), reps=10)
                times[f"upload_{nf}_ms"] = cuda_ms(
                    lambda: torch.from_numpy(frames).cuda())
                times[f"preprocess_{nf}_ms"] = cuda_ms(
                    lambda: preprocess_frames(xin, 224, fast=True))
            chunks = [c for _, _, c in synthetic_chunks(
                VISION_CHUNKS, VISION_FRAMES, 5.0)]
            vis = client.vision_prefixes(
                chunks, client.embed_frames(np.concatenate(chunks)))
            gen_s = {}
            for b in (1, VISION_CHUNKS):
                generate(client._serve_params, client.cap_cfg, vis[:b],
                         client.max_new)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = generate(client._serve_params, client.cap_cfg,
                                vis[:b], client.max_new)
                torch.cuda.synchronize()
                gen_s[f"b{b}"] = time.perf_counter() - t0
                assert toks.shape == (b, client.max_new)
            times["generate_s"] = gen_s
            cli = vision_cli(tmp / "vlm_output.json", tmp)
        finally:
            os.chdir(old_cwd)
    per_chunk = {name: statistics.mean(r["processing_time"]
                                       for r in run["results"])
                 for name, run in (("einsum", einsum), ("fused", fused))}
    out = {"counts": {"einsum": einsum["counts"], "fused": fused["counts"]},
           "s_per_chunk": per_chunk,
           "wall_s": {"einsum": einsum["wall_s"], "fused": fused["wall_s"]},
           "captions_equal_across_modes": same,
           "embedding_cosine_einsum_vs_fused": cos_modes,
           "embeddings_kernels_vs_plain": {"min_cosine": cos_plain,
                                           "max_abs_err": emb_err},
           "planted_fault": {"fault": "short attention without 1/sqrt(hd)",
                             "embedding_min_cosine": fault["cosine"],
                             "first_token_logits_max_abs_diff": fault_err},
           "first_token_logits": {
               "max_abs_err": err, "tol": VISION_LOGIT_TOL,
               "first_tokens_equal": bool(first_same.all()),
               "decided": bool(decided.all()),
               "logit_scale": float(lp.abs().max())},
           "times": times, "cli": cli}
    log(f"phase 11: the vision path at ViT-B/32 + captioner base width on "
        f"{card}: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------- phase 12
Q8_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
             (512, 1536), (512, 512), (512, 2048), (2048, 512)]
Q8_COPIES = 20
# rows held against the plain version: decode steps, 5 (no multiple of 16),
# and what phase 13 gives the kernel besides: B = 4 (generate's steps, and
# its prefill of 4 x 9 = 36 rows) and sequence_logits' 40.  Between them
# every product width (8, 16, 32, 64 rows) runs, full and ragged (33, 63:
# the rows past M zero-filled by TMA).
Q8_CHECK_M = (1, 4, 5, 8, 32, 33, 36, 40, 63, 64)


def rotating(fn, items):
    """``fn`` over ``items`` in turn, one a call: each of a replay's 20
    calls reads another copy of the weights."""
    turn = itertools.cycle(items)
    return lambda: fn(next(turn))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` (the wrapper's checks, tables
    and launch), enqueued back to back without a synchronise."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def check_q8(q8, x, q, s) -> tuple:
    """The kernel twice (equal bits) and against the plain version;
    returns (max |err|, max |plain|)."""
    got = q8.q8_matmul(x, q, s)
    again = q8.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = q8.q8_matmul_ref(x, q, s)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(torch.isfinite(got).all()), "q8_matmul: not finite"
    assert torch.equal(got, again), \
        f"q8_matmul {tuple(x.shape)} x {tuple(q.shape)}: two runs differ"
    err, top = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= q8.TOL_REL * top, \
        f"q8_matmul {tuple(x.shape)} x {tuple(q.shape)}: max |err| {err} " \
        f"> {q8.TOL_REL} x {top}"
    return err, top


def phase_q8_matmul(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.models import quant8
    from vidgraph_tpu_torch.ops import q8_matmul as q8

    rng = np.random.default_rng(seed + 5)
    bf16 = torch.bfloat16

    def activations(m, k, scale=1.0):
        return torch.from_numpy(rng.standard_normal(
            (m, k), dtype=np.float32) * scale).to("cuda", bf16)

    rows, worst_abs, worst_rel = {}, 0.0, 0.0
    int8pack_reason = None
    for k, n in Q8_SHAPES:
        w = torch.from_numpy(rng.standard_normal(
            (k, n), dtype=np.float32) * 0.02).cuda()
        wq = quant8.quantize_matrix(w)
        for m in Q8_CHECK_M:
            err, top = check_q8(q8, activations(m, k), wq.q, wq.s)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                            err / top)
        qs = [wq.q.clone() for _ in range(Q8_COPIES)]
        qts = [q.t().contiguous() for q in qs]
        ws = [w.to(bf16) for _ in range(Q8_COPIES)]
        s, s16 = wq.s, wq.s.to(bf16)
        for m in (1, 8, 32):
            x = activations(m, k)
            got = q8.q8_matmul(x, qs[0], s)
            got16 = q8.q8_matmul(x, qs[0], s, bf16)
            torch.cuda.synchronize()
            assert torch.equal(got16, got.to(bf16)), \
                f"q8_matmul K{k} N{n} M{m}: bf16 output is not the " \
                f"float32 output rounded"
            row = {
                "kernel_ms": graph_ms(rotating(
                    lambda q: q8.q8_matmul(x, q, s), qs)),
                "kernel_bf16_out_ms": graph_ms(rotating(
                    lambda q: q8.q8_matmul(x, q, s, bf16), qs)),
                "bf16_out_bit_equal": True,
                "host_us": host_us(lambda: q8.q8_matmul(x, qs[0], s)),
                "cluster": q8.plan(m, k, n).cluster,
                "plain_ms": graph_ms(rotating(
                    lambda q: q8.q8_matmul_ref(x, q, s), qs)),
                "a16_ms": graph_ms(rotating(
                    lambda q: ((x @ q.to(bf16)).float() * s).to(bf16), qs)),
                "cublas_bf16_ms": graph_ms(rotating(lambda v: x @ v, ws)),
                "int8pack_ms": None,
                **bound(k * n + 2 * m * k + 4 * n + 4 * m * n,
                        2.0 * m * k * n, BF16_FLOPS),
                "bf16_bound_ms": bound(2 * k * n + 2 * m * k + 2 * m * n,
                                       2.0 * m * k * n,
                                       BF16_FLOPS)["bound_ms"]}
            if int8pack_reason is None:
                try:
                    row["int8pack_ms"] = graph_ms(rotating(
                        lambda qt: torch._weight_int8pack_mm(x, qt, s16),
                        qts))
                except (RuntimeError, AttributeError,
                        NotImplementedError) as exc:
                    int8pack_reason = f"{type(exc).__name__}: {exc}"[:300]
                    torch.cuda.synchronize()
            rows[f"K{k}_N{n}_M{m}"] = row
        del qs, qts, ws, w, wq
        torch.cuda.empty_cache()
    # a column of zeros (its scale is the floor) and |x| up to 1e3
    w = torch.from_numpy(rng.standard_normal(
        (2048, 2048), dtype=np.float32) * 0.02).cuda()
    w[:, 3] = 0.0
    wq = quant8.quantize_matrix(w)
    x = activations(8, 2048)
    x = (x.float() / x.float().abs().max() * 1e3).to(bf16)
    assert float(wq.s[3]) == float(np.float32(1e-8))
    err, top = check_q8(q8, x, wq.q, wq.s)
    assert not bool(q8.q8_matmul(x, wq.q, wq.s)[:, 3].any())
    worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
    if int8pack_reason:
        log(f"phase 12: torch._weight_int8pack_mm does not run here: "
            f"{int8pack_reason}")
    log(f"phase 12: q8_matmul within {q8.TOL_REL} x max |plain| of the plain "
        f"version at {len(Q8_SHAPES)} (K, N) x M "
        f"{'/'.join(map(str, Q8_CHECK_M))} (worst max "
        f"|err| / max |plain| {worst_rel:.3e}), two runs equal bit for bit, "
        f"the bf16 output the float32 output rounded, bit for bit; "
        f"times on {card} (ms; device time per call, 20 calls replayed "
        f"from a CUDA graph over 20 copies of the weights; host_us: the "
        f"wrapper's host time a call): "
        f"{json.dumps(rows)}")
    return {"rows": rows, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "int8pack_reason": int8pack_reason}


# ----------------------------------------------------------------- phase 13
QUANT_CHUNKS, QUANT_NEW = 2, 64


def flat_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def phase_quantized(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.cli.main import main as cli_main
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     decode_steps, generate,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.models.quant8 import (is_q8, quantize_matrix,
                                                  tree_bytes, wdot)
    from vidgraph_tpu_torch.models.vit import (ViTConfig, init_vision_tower,
                                               param_tree)
    from vidgraph_tpu_torch.ops import q8_matmul as q8
    from vidgraph_tpu_torch.pipeline import vlm_extractor
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_torch_int8_decode as p8

    large = CaptionerConfig.large()
    rng = np.random.default_rng(seed + 6)
    chunks = [c for _, _, c in synthetic_chunks(QUANT_CHUNKS, VISION_FRAMES,
                                                5.0)]
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            tower = init_vision_tower(ViTConfig.b32(), seed, device=CUDA)
            cap = init_params(large, seed, param_dtype=torch.bfloat16,
                              device=CUDA)
            ckpt = save_params({"vit": param_tree(tower), "cap": cap},
                               str(tmp / "vlm_large.npz"))
            del tower, cap
            log(f"phase 13: seed weights for ViT-B/32 + CaptionerConfig."
                f"large() written in {time.perf_counter() - t0:.1f} s "
                f"({Path(ckpt).stat().st_size / 1e9:.2f} GB npz)")

            # (i) the three clients a config can ask for
            clients, captions, nbytes, caption_s = {}, {}, {}, {}
            for name, quantize in (("bf16", None), ("int8", "int8"),
                                   ("int8_a8", "int8_a8")):
                t0 = time.perf_counter()
                client = TPUVLMClient(cap_cfg=large, checkpoint=ckpt,
                                      param_dtype=torch.bfloat16,
                                      quantize=quantize, preprocess="device")
                load_s = time.perf_counter() - t0
                assert client.quantize == quantize
                assert client.cap_cfg.qmode == {"int8_a8": "a8"}.get(name,
                                                                     "a16")
                assert is_q8(client._serve_params["blocks"][0]["qkv_w"]) \
                    == (quantize is not None)
                q8.reset_counts()
                t0 = time.perf_counter()
                captions[name] = client.caption_batch_sync(chunks)
                torch.cuda.synchronize()
                caption_s[name] = {"load_s": load_s,
                                   "caption_s": time.perf_counter() - t0}
                assert len(captions[name]) == QUANT_CHUNKS and all(
                    isinstance(c, str) for c in captions[name])
                assert q8.LAUNCHES["q8_matmul"] == 0 and q8.REF_CALLS == 0, \
                    f"{name}: a config value reached the a16p kernel"
                nbytes[name] = tree_bytes(client.cap_params)
                if name != "int8_a8":
                    clients[name] = client
                del client
            ratio = nbytes["int8"] / nbytes["bf16"]
            assert nbytes["int8"] == nbytes["int8_a8"] and ratio < 0.55, nbytes
            log(f"phase 13: three clients captioned {QUANT_CHUNKS} chunks; "
                f"tree bytes {json.dumps(nbytes)} (int8 / bf16 {ratio:.4f}); "
                f"{json.dumps(caption_s)}")

            # (ii) the kernel's path: the int8 tree with qmode a16p
            qtree = clients["int8"]._serve_params
            ftree = clients["bf16"]._serve_params
            qcfg = {m: dataclasses.replace(large, qmode=m)
                    for m in ("a16", "a8", "a16p")}
            per_step = 4 * large.layers
            launches = {}
            for b in (4, 8):
                vis = torch.from_numpy(rng.standard_normal(
                    (b, large.num_vision_tokens, large.vision_dim),
                    dtype=np.float32)).cuda()
                q8.reset_counts()
                toks = generate(qtree, qcfg["a16p"], vis, max_new=QUANT_NEW)
                torch.cuda.synchronize()
                got = {"kernel": q8.LAUNCHES["q8_matmul"],
                       "plain": q8.REF_CALLS}
                steps = decode_steps(toks, QUANT_NEW)
                rows = b * (large.num_vision_tokens + 1)
                want = per_step * steps + (per_step if rows <= q8.MAX_M
                                           else 0)
                launches[f"b{b}"] = {**got, "expected": want,
                                     "decode_steps": steps,
                                     "prefill_rows": rows}
                assert toks.shape == (b, QUANT_NEW)
                assert got["kernel"] == want, launches
                assert got["plain"] == 0, launches
            log(f"phase 13: generate with qmode a16p: launches "
                f"{json.dumps(launches)}")

            # one product, one kernel on the device: wdot(a16p) at M 8 and
            # bf16 out, captured into a CUDA graph, is one kernel node, the
            # q8 kernel's (the wrapper counts one launch), with no
            # reduction and no cast, at the four shapes of a large() layer
            product_kernels = {}
            for k, n in Q8_SHAPES[:4]:
                w = quantize_matrix(torch.from_numpy(
                    (rng.standard_normal((k, n)) * 0.02).astype(
                        np.float32)).cuda())
                x = torch.from_numpy(rng.standard_normal((8, k)).astype(
                    np.float32)).cuda().to(torch.bfloat16)
                q8.reset_counts()
                nodes = graph_node_types(
                    lambda: wdot(x, w, torch.bfloat16, "a16p"))
                product_kernels[f"{k}x{n}"] = nodes
                assert nodes == [0] and q8.LAUNCHES["q8_matmul"] == 2, \
                    f"wdot(a16p) at ({k}, {n}): graph nodes {nodes}, " \
                    f"{q8.LAUNCHES['q8_matmul']} launches for 2 calls"
            log(f"phase 13: one wdot(a16p) product is one kernel node in a "
                f"CUDA graph: {json.dumps(product_kernels)}")

            # (iii) logits: each int8 mode against bf16, a16p against a16,
            # and a planted fault
            vis = torch.from_numpy(rng.standard_normal(
                (4, large.num_vision_tokens, large.vision_dim),
                dtype=np.float32)).cuda()
            toks = torch.from_numpy(rng.integers(3, 250, (4, 32))).cuda()
            ref = p8.sequence_logits(ftree, large, vis, toks)
            no_flash = p8.sequence_logits(ftree, large, vis, toks,
                                          flash=False)
            flash_diff = float((ref - no_flash).abs().max())
            del no_flash
            q8.reset_counts()
            got = {m: p8.sequence_logits(qtree, qcfg[m], vis, toks)
                   for m in qcfg}
            assert q8.LAUNCHES["q8_matmul"] == 4 * per_step, q8.LAUNCHES
            sound = q8.q8_matmul
            q8.q8_matmul = lambda x, q, s, *a: sound(x, q, torch.ones_like(s),
                                                     *a)
            try:
                fault = p8.sequence_logits(qtree, qcfg["a16p"], vis, toks)
            finally:
                q8.q8_matmul = sound
            torch.cuda.synchronize()
            cosines = {m: flat_cosine(ref, got[m]) for m in got}
            diff = float((got["a16p"] - got["a16"]).abs().max())
            fault_diff = float((fault - got["a16"]).abs().nan_to_num(
                nan=float("inf")).max())
            logits = {
                "cosine_vs_bf16": cosines,
                "max_abs_diff_vs_bf16": {
                    m: float((got[m] - ref).abs().max()) for m in got},
                "a16p_vs_a16_max_abs_diff": diff, "tol": Q8_LOGIT_TOL,
                "bf16_flash_vs_plain_attention_max_abs_diff": flash_diff,
                "flash_tol": LARGE_FLASH_LOGIT_TOL,
                "planted_fault": "q8_matmul without its scale",
                "planted_fault_max_abs_diff": fault_diff,
                "logit_scale": float(ref.abs().max())}
            log(f"phase 13: teacher-forced logits at large() width: "
                f"{json.dumps(logits)}")
            assert all(bool(torch.isfinite(v).all()) for v in got.values())
            assert min(cosines.values()) > Q8_COSINE_MIN, cosines
            assert flash_diff <= LARGE_FLASH_LOGIT_TOL, \
                f"bf16 logits with the flash kernel (16 heads of 128) " \
                f"differ from the plain attention's by {flash_diff} > " \
                f"{LARGE_FLASH_LOGIT_TOL}"
            assert diff <= Q8_LOGIT_TOL, \
                f"a16p logits differ from a16 by {diff} > {Q8_LOGIT_TOL}"
            assert fault_diff > Q8_LOGIT_TOL, \
                f"a planted fault moved the logits by {fault_diff} only"

            # (iv) the four modes' decode rates
            trees = {"bf16": (ftree, large), "int8_a16": (qtree, qcfg["a16"]),
                     "int8_a8": (qtree, qcfg["a8"]),
                     "int8_a16p": (qtree, qcfg["a16p"])}
            rates = {name: p8.bench_decode(p, c, (8, 32), QUANT_NEW, 1)
                     for name, (p, c) in trees.items()}
            row = rates["int8_a16p"]["batches"][8]
            assert row["q8_launches_per_call"] == \
                per_step * row["decode_steps"] and not row["q8_plain_calls"]
            # every kernel launch a decode step, from one profiled call
            profiled = p8.bench_decode(qtree, qcfg["a16p"], (8,), QUANT_NEW,
                                       1, profiled=True)["batches"][8]
            step_launches = {8: profiled["launches_per_step"],
                             "device_busy_share":
                             profiled["device_busy_share"],
                             "q8_kernels": profiled["q8_kernel_events"],
                             "decode_steps":
                             profiled["profiled_decode_steps"]}
            # the profiled call's q8 kernels on the device: 96 a decode
            # step (B 8's prefill of 72 rows takes the a16 expression)
            rows = 8 * (large.num_vision_tokens + 1)
            want = per_step * profiled["profiled_decode_steps"] + (
                per_step if rows <= q8.MAX_M else 0)
            assert profiled["q8_kernel_events"] == want, \
                f"{profiled['q8_kernel_events']} q8 kernels on the device " \
                f"in a profiled a16p decode, {want} products"
            log(f"phase 13: decode at CaptionerConfig.large() width on "
                f"{card}, {QUANT_NEW} new bytes: {json.dumps(rates)}")
            del clients, qtree, ftree, trees, got, ref, fault
            torch.cuda.empty_cache()

            # (v) vlm.quantize through the CLI, at base() width
            vlm_extractor.iter_chunk_frames = (
                lambda path, secs, per_chunk, *a: synthetic_chunks(
                    QUANT_CHUNKS, per_chunk, secs))
            vlm_extractor.count_chunks = lambda path, secs: QUANT_CHUNKS
            (tmp / "quant.yaml").write_text(
                "backend:\n  vlm: tpu\nvlm:\n  preprocess: device\n"
                "  quantize: int8\n")
            q8.reset_counts()
            rc = cli_main(["vlm", "--config", str(tmp / "quant.yaml"),
                           "--video", "synthetic_405x720.mp4", "--output",
                           str(tmp / "vlm_int8.json")])
            assert rc == 0, f"vlm with vlm.quantize int8 exited {rc}"
            data = json.loads((tmp / "vlm_int8.json").read_text())
            assert data["metadata"]["config"]["vlm"]["quantize"] == "int8"
            assert len(data["results"]) == QUANT_CHUNKS and all(
                isinstance(r["content"], str) for r in data["results"])
            assert q8.LAUNCHES["q8_matmul"] == 0 and q8.REF_CALLS == 0
            log(f"phase 13: CLI vlm with vlm.quantize int8 at base() width: "
                f"{QUANT_CHUNKS} chunks, exit 0")
        finally:
            os.chdir(old_cwd)
    return {"tree_bytes": nbytes, "int8_over_bf16_bytes": ratio,
            "clients": caption_s, "launches": launches, "logits": logits,
            "a16p_launches_per_step": step_launches,
            "decode": rates}


# ----------------------------------------------------------------- phase 14
# (B, T, heads, hd, nv); the first three are the training paths' shapes;
# the last three hold prefixes of a tile and more (key tiles above the
# diagonal that rows below nv still see)
BWD_SHAPES = [(8, 3080, 8, 64, 8), (16, 1544, 8, 64, 8),
              (16, 1032, 16, 64, 8), (2, 1033, 16, 128, 8),
              (2, 1033, 16, 128, 0), (2, 1033, 8, 64, 8),
              (2, 1033, 8, 64, 0), (3, 40, 8, 64, 8), (3, 40, 8, 64, 0),
              (3, 40, 16, 128, 8), (1, 64, 8, 64, 64), (2, 130, 8, 64, 70),
              (2, 200, 16, 128, 100)]
BWD_TIMED = 3


def visible_pairs(t: int, nv: int) -> int:
    """(query, key) pairs of the prefix-causal mask over t tokens."""
    return sum(min(max(r, nv - 1), t - 1) + 1 for r in range(t))


def bwd_errors(fa, q, k, v, out, lse, do, grads, nv, use_delta=True) -> dict:
    """The kernels' (dq, dk, dv) against ``attention_bwd_ref``, one batch
    row at a time: max |err|, the worst excess over ``TOL_ABS + TOL_REL *
    |plain|``, and the worst Frobenius error over the plain norm."""
    err = fro = 0.0
    excess = float("-inf")
    for i in range(q.shape[0]):
        row = slice(i, i + 1)
        refs = fa.attention_bwd_ref(q[row], k[row], v[row], out[row],
                                    lse[row], do[row], nv, use_delta)
        for got, ref in zip(grads, refs):
            got = got[row].float()
            ref = ref.to(torch.bfloat16).float()
            diff = (got - ref).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float(
                (diff - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max()))
            fro = max(fro, float(diff.norm())
                      / max(float(ref.norm()), 1e-12))
    return {"max_abs_err": err, "excess": excess, "rel_fro": fro}


def library_sdpa_train(q, k, v, do, mask) -> dict:
    """The yardstick of the training attention, never called by the port:
    ``F.scaled_dot_product_attention`` forward and backward under autograd
    with the boolean prefix mask; medians of the forward alone and of the
    forward + backward, and the device kernels PyTorch chose."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms

    ql, kl, vl = (z.detach().clone().requires_grad_(True) for z in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(
            ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (ql, kl, vl), do.transpose(1, 2))

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, reps=10)
    both_ms = cuda_ms(fwd_bwd, reps=10)
    return {"library_fwd_ms": fwd_ms, "library_fwd_bwd_ms": both_ms,
            "library_bwd_ms": both_ms - fwd_ms,
            "library_kernels": device_kernels(fwd_bwd)}


def phase_flash_backward(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed + 14)
    rows = {}
    planted = None
    for n, (b, t, h, hd, nv) in enumerate(BWD_SHAPES):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))

        def grads():
            ql, kl, vl = (z.detach().requires_grad_(True) for z in (q, k, v))
            out = fa.flash_attention(ql, kl, vl, nv)
            assert out.grad_fn is not None, "the output is cut from the graph"
            return out.detach(), torch.autograd.grad(out, (ql, kl, vl), do)

        out, first = grads()
        _, second = grads()
        torch.cuda.synchronize()
        # dk and dv: bit-equal; dq: summed by atomics, compared before its
        # rounding to bf16
        same_bits = all(torch.equal(a, c) for a, c in zip(first[1:],
                                                          second[1:]))
        lse = fa._cuda_flash(q, k, v, nv, with_lse=True)[1]
        accs = []
        for _ in range(2):
            delta, acc = fa._cuda_delta(out, do)
            fa._cuda_bwd_fused(q, k, v, do, lse, delta, acc, nv)
            accs.append(acc)
        torch.cuda.synchronize()
        dq_run_rel = float((accs[0] - accs[1]).norm()) / max(
            float(accs[0].norm()), 1e-30)
        scale = 1.0 / math.sqrt(hd)
        convert_err = float((fa._cuda_dq_convert(accs[0]).float() - (
            accs[0] * scale).to(torch.bfloat16).float()).abs().max())
        lse_err = max(float((lse[i] - fa.lse_ref(q[i:i + 1], k[i:i + 1],
                                                 nv)[0]).abs().max())
                      for i in range(b))
        delta_err = float((delta - (do.float() * out.float()).sum(-1)
                           .transpose(1, 2)).abs().max())
        row = {**bwd_errors(fa, q, k, v, out, lse, do, first, nv),
               "dk_dv_bit_equal": same_bits, "dq_run_rel": dq_run_rel,
               "convert_err": convert_err, "lse_err": lse_err,
               "delta_err": delta_err}
        name = f"b{b}_T{t}_h{h}x{hd}_nv{nv}"
        assert all(bool(torch.isfinite(g).all()) for g in first), name
        assert row["excess"] <= 0 and row["rel_fro"] <= BWD_REL_FRO, \
            f"flash backward {name}: {row}"
        assert same_bits, f"flash backward {name}: two runs' dk, dv differ"
        assert dq_run_rel <= DQ_RUN_REL and convert_err == 0.0, \
            f"flash backward {name}: {row}"
        assert lse_err <= 2e-3 and delta_err <= 1e-3 * max(
            1.0, float(delta.abs().max())), f"{name}: {row}"
        if planted is None and t <= 1100:
            bad = bwd_errors(fa, q, k, v, out, lse, do, first, nv,
                             use_delta=False)
            assert bad["excess"] > 0 and bad["rel_fro"] > BWD_REL_FRO, \
                f"the backward without delta passes at {name}: {bad}"
            planted = {"shape": name, **bad}
        if n < BWD_TIMED:
            pairs = visible_pairs(t, nv)
            tensor = b * t * h * hd * 2                 # one bf16 tensor
            vec = b * h * t * 4                         # lse or delta
            product = 2.0 * b * h * hd * pairs          # one T x T product
            mask = fa.prefix_causal_mask(t, nv, q.device)
            row.update({
                "fwd_lse_ms": cuda_ms(lambda: fa._cuda_flash(
                    q, k, v, nv, with_lse=True)),
                "delta_ms": cuda_ms(lambda: fa._cuda_delta(out, do)),
                "fused_ms": cuda_ms(lambda: fa._cuda_bwd_fused(
                    q, k, v, do, lse, delta, acc, nv)),
                "convert_ms": cuda_ms(lambda: fa._cuda_dq_convert(acc)),
                "bwd_ms": cuda_ms(lambda: fa._cuda_flash_bwd(
                    q, k, v, out, lse, do, nv)),
                "plain_delta_ms": cuda_ms(
                    lambda: (do.float() * out.float()).sum(-1)
                    .transpose(1, 2).contiguous()),
                "plain_convert_ms": cuda_ms(
                    lambda: (acc * scale).to(torch.bfloat16)),
                "bound": {
                    "fwd": bound(4 * tensor + vec, 2 * product, BF16_FLOPS),
                    # o and dO in, delta out, the float32 dq accumulator
                    # (two bf16 tensors' bytes) zeroed
                    "delta": bound(4 * tensor + vec, 2.0 * b * t * h * hd,
                                   F32_FLOPS),
                    # q, k, v, dO, L, delta in; dk, dv and the dq
                    # accumulator out; S, dP, dV, dK, dQ: 5 products
                    "fused": bound(8 * tensor + 2 * vec, 5 * product,
                                   BF16_FLOPS),
                    "convert": bound(3 * tensor, 0.0, F32_FLOPS),
                    # the whole backward: q, k, v, o, dO, L in, dq, dk,
                    # dv out, 5 products
                    "bwd": bound(8 * tensor + vec, 5 * product,
                                 BF16_FLOPS)}})
            del first, second
            torch.cuda.empty_cache()
            row["plain_bwd_ms"] = cuda_ms(
                lambda: fa.attention_bwd_ref(q, k, v, out, lse, do, nv),
                reps=3, warmup=1)
            torch.cuda.empty_cache()
            row.update(library_sdpa_train(q, k, v, do, mask))
        rows[name] = row
        del q, k, v, do, out, lse, delta, acc, accs
        torch.cuda.empty_cache()
    log(f"phase 14: flash backward kernels within {fa.TOL_ABS} + "
        f"{fa.TOL_REL} x |plain| and {BWD_REL_FRO} of the plain norm, two "
        f"runs' dk, dv bit-equal and dq accumulators within {DQ_RUN_REL}; "
        f"planted fault (no delta) {json.dumps(planted)}; "
        f"times on {card} (median, ms): {json.dumps(rows)}")
    return {"rows": rows, "planted": planted}


# ----------------------------------------------------------------- phase 15
def load_script(name: str):
    """A trainer script of ``scripts/`` as a module (its ``main(argv)`` is
    the entry point a user runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def training_corpus(tmp: Path, seed: int) -> Path:
    """The golden vlm output plus synthetic captions, as a vlm_output."""
    from vidgraph_tpu_torch.models import instruct_data

    rng = random.Random(seed)
    results = json.loads((ROOT / "tests/golden/vlm_output_golden.json")
                         .read_text())["results"]
    results = results + [
        {"content": " ".join(instruct_data.synth_sentence(rng)
                             for _ in range(4))} for _ in range(10)]
    path = tmp / "train_corpus.json"
    path.write_text(json.dumps({"results": results}))
    return path


def leaf_grads(params, loss_of) -> tuple:
    """(loss, {leaf: gradient or None}) of ``loss_of()``, a training
    loss of ``params``."""
    from vidgraph_tpu_torch.models.checkpoint import tree_leaves

    for _, p in tree_leaves(params):
        p.grad = None
    loss = loss_of()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad for k, p in tree_leaves(params)}


def worst_leaf(got: dict, ref: dict) -> tuple:
    """(leaf, max |diff| / max |ref|) of the worst leaf; a missing
    gradient counts as zeros."""
    worst = ("", 0.0)
    for key, r in ref.items():
        g = got[key] if got[key] is not None else torch.zeros_like(r)
        rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        if rel > worst[1]:
            worst = (key, rel)
    return worst


def phase_train_instruct(seed: int, card: str, tmp: Path) -> dict:
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.services.llm_client import make_chat_client

    mod = load_script("train_torch_instruct_lm")
    out = tmp / "instruct_lm.npz"
    steps = 12
    fa.reset_counts()
    t0 = time.perf_counter()
    rec = mod.main([
        "--corpus", str(training_corpus(tmp, seed)), "--steps", str(steps),
        "--batch", "8", "--seq-len", "3072", "--flash", "--seed", str(seed),
        "--n-questions", "4", "--n-pre", "12", "--n-synth-answers", "6",
        "--n-instr", "4", "--n-consol", "4", "--n-copy", "4",
        "--eval-count", "4", "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(fa.LAUNCHES), fa.REF_CALLS
    layers = rec["layers"]
    fwd_want = layers * (steps + rec["held_evals"] * rec["held_buckets"]
                         + rec["held_examples"])
    assert rec["attention"] == "flash" and rec["remat"] is False, rec
    assert counts["flash_bwd_fused"] == counts["flash_bwd_dq_convert"] == \
        counts["flash_bwd_delta"] == layers * steps, counts
    assert counts["flash_fwd"] == fwd_want, (counts, fwd_want)
    assert plain == 0, f"the plain attention served {plain} calls"
    assert all(np.isfinite(rec["losses"])), rec["losses"]
    assert np.isfinite(rec["held_last"]) and \
        rec["held_last"] < rec["held_first"], \
        (rec["held_first"], rec["held_last"])
    assert [8, 3072] in rec["batch_shapes"], rec["batch_shapes"]

    # the first batch from the seed weights: kernels against einsum + remat
    cfg = CaptionerConfig.chat()
    params = init_params(cfg, seed, device=CUDA, requires_grad=True)
    toks, plens = (torch.as_tensor(a, device="cuda")
                   for a in rec["first_batch"])
    def loss_of(remat, flash):
        return lambda: mod.instruct_loss(params, cfg, toks, plens, remat,
                                         flash)
    loss_f, g_flash = leaf_grads(params, loss_of(False, True))
    assert abs(loss_f - rec["losses"][0]) < 1e-3, (loss_f, rec["losses"][0])
    loss_e, g_plain = leaf_grads(params, loss_of(True, False))
    leaf, rel = worst_leaf(g_flash, g_plain)
    assert abs(loss_f - loss_e) < 2e-2 and rel < TRAIN_GRAD_TOL, \
        f"gradients with the kernels: {leaf} differs by {rel} of its max"
    # planted fault: the attention output cut from the graph
    real = fa.FlashAttentionFn.apply
    fa.FlashAttentionFn.apply = staticmethod(
        lambda q, k, v, nv: fa._cuda_flash(q.detach(), k.detach(),
                                           v.detach(), nv)[0])
    try:
        _, g_cut = leaf_grads(params, loss_of(False, True))
    finally:
        fa.FlashAttentionFn.apply = real
    cut_leaf, cut_rel = worst_leaf(g_cut, g_plain)
    assert cut_rel > TRAIN_GRAD_TOL, \
        f"a gradient cut at the attention passes the check ({cut_rel})"
    del params, g_flash, g_plain, g_cut
    torch.cuda.empty_cache()

    # the trained checkpoint serves through backend.llm: tpu
    fa.reset_counts()
    client = make_chat_client("tpu", checkpoint_path=str(out))
    text = asyncio.run(client.complete(
        "TEXT TO ANALYSE:\nA red square moves left.\n\nTRIPLET LINES:\n",
        max_tokens=64))
    assert isinstance(text, str) and client.MAX_NEW == 1024
    assert fa.LAUNCHES["flash_fwd"] == layers and fa.REF_CALLS == 0
    del client
    torch.cuda.empty_cache()
    timed = rec["losses"]
    res = {"steps": steps, "wall_s": wall, "launches": counts,
           "flash_fwd_expected": fwd_want, "batch_shapes": rec["batch_shapes"],
           "first_loss": timed[0], "last_loss": timed[-1],
           "held_first": rec["held_first"], "held_last": rec["held_last"],
           "grad_check": {"loss_flash": loss_f, "loss_einsum_remat": loss_e,
                          "worst_leaf": leaf, "worst_rel": rel,
                          "planted_leaf": cut_leaf, "planted_rel": cut_rel,
                          "tol": TRAIN_GRAD_TOL},
           "served_chars": len(text), "eval": rec["eval"]}
    log(f"phase 15a: instruct trainer at CaptionerConfig.chat() width, "
        f"8 x 3072, flash, on {card}: {json.dumps(res)}")
    return res


def midscale_grad_check(mod, seed: int, corpus: str) -> dict:
    """Every leaf's gradient of the mid-scale loss at its full width (16
    heads x 1024) from the seed weights, on 4 packed windows of 1024: the
    kernels against the masked einsum with remat."""
    from vidgraph_tpu_torch.models.captioner import init_params

    cfg = mod.mid_config(1024)
    params = init_params(cfg, seed, device=CUDA, requires_grad=True)
    captions = [r["content"] for r in json.loads(Path(corpus).read_text())[
        "results"] if r.get("content")]
    toks = mod.pack_corpus(captions, 1024, random.Random(seed))
    batch = torch.as_tensor(toks[:4], device="cuda")
    loss_f, g_flash = leaf_grads(
        params, lambda: mod.lm_loss(params, cfg, batch, False, True))
    loss_e, g_plain = leaf_grads(
        params, lambda: mod.lm_loss(params, cfg, batch, True, False))
    leaf, rel = worst_leaf(g_flash, g_plain)
    assert abs(loss_f - loss_e) < 2e-2 and rel < TRAIN_GRAD_TOL, \
        f"mid-scale gradients with the kernels: {leaf} differs by {rel}"
    del params, g_flash, g_plain
    torch.cuda.empty_cache()
    return {"loss_flash": loss_f, "loss_einsum_remat": loss_e,
            "worst_leaf": leaf, "worst_rel": rel, "tol": TRAIN_GRAD_TOL}


def phase_train_midscale(seed: int, card: str, tmp: Path) -> dict:
    from vidgraph_tpu_torch.ops import flash_attention as fa

    mod = load_script("train_torch_midscale")
    corpus = str(training_corpus(tmp, seed))
    runs = {}
    steps = 12
    for name, argv in (("flash", ["--flash"]), ("einsum_remat", [])):
        fa.reset_counts()
        torch.cuda.empty_cache()
        rec = mod.main(["--corpus", corpus, "--steps", str(steps), "--seed",
                        str(seed), "--out", str(tmp / f"mid_{name}.npz"),
                        *argv])
        torch.cuda.synchronize()
        assert rec["bf16_roundtrip_exact"], rec
        assert all(np.isfinite(rec["losses"])), rec["losses"]
        assert rec["config"] == "16x1024" and rec["batch"] == 16 and \
            rec["seq_len"] == 1024, rec
        runs[name] = {**{k: rec[k] for k in (
            "attention", "remat", "params_m", "step_ms", "tokens_per_sec",
            "train_mfu", "mfu_peak", "peak_memory_gb", "first_loss",
            "last_loss", "bf16_roundtrip_exact", "decode_sample")},
            "losses": rec["losses"],
            "launches": dict(fa.LAUNCHES), "plain_calls": fa.REF_CALLS}
    fl, ein = runs["flash"], runs["einsum_remat"]
    assert fl["attention"] == "flash" and fl["remat"] is False, fl
    assert ein["attention"] == "einsum" and ein["remat"] is True, ein
    assert fl["last_loss"] < fl["first_loss"], fl
    # 16 layers x 12 steps, plus the decode sample's prefill
    assert fl["launches"]["flash_bwd_fused"] == fl["launches"][
        "flash_bwd_dq_convert"] == 16 * steps, fl["launches"]
    assert fl["launches"]["flash_fwd"] == 16 * steps + 16, fl["launches"]
    assert fl["plain_calls"] == 0 and ein["launches"]["flash_fwd"] == 0
    # the same seed gives both runs the same weights, batches and schedule
    gaps = [abs(a - b) for a, b in zip(fl["losses"][:4], ein["losses"][:4])]
    assert max(gaps) <= MIDSCALE_LOSS_TOL, \
        f"mid-scale flash and einsum + remat losses part: {gaps}"
    res = {"runs": runs, "loss_gaps_first4": gaps,
           "loss_tol": MIDSCALE_LOSS_TOL,
           "grad_check": midscale_grad_check(mod, seed, corpus)}
    log(f"phase 15b: mid-scale trainer, 204M, 16 x 1024, on {card}: "
        f"{json.dumps(res)}")
    return res


def phase_train_state(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig
    from vidgraph_tpu_torch.models.tokenizer import batch_encode
    from vidgraph_tpu_torch.models.train import TrainState
    from vidgraph_tpu_torch.models.vit import ViTConfig

    state = TrainState.create(
        ViTConfig.b32(), CaptionerConfig.base(), torch.device("cuda"),
        learning_rate=3e-4, seed=seed)
    rng = np.random.default_rng(seed + 15)
    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    tokens = batch_encode(["The scene shows a red object on a dark "
                           "background."] * 8, 96)
    batch = state.shard_batch(images, tokens)
    torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], time.perf_counter()
    for _ in range(3):
        state, loss = state.step(*batch)
        losses.append(loss)
    step_s = (time.perf_counter() - t0) / 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    res = {"losses": losses, "step_ms": step_s * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"phase 15c: TrainState, ViT-B/32 + CaptionerConfig.base(), B 8, "
        f"on {card}: {json.dumps(res)}")
    del state, batch
    torch.cuda.empty_cache()
    return res


def phase_training(seed: int, card: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        return {"instruct": phase_train_instruct(seed, card, tmp),
                "midscale": phase_train_midscale(seed, card, tmp),
                "train_state": phase_train_state(seed, card)}


# ----------------------------------------------------------------- phase 16
ACS_SIZES = (64, 96, 128, 256, 512, 926)
# tests/test_acs.py::test_xla_matches_networkx's tolerances
ACS_NAMED_TOL = {"global_efficiency": 1e-3, "avg_path_length": 1e-3,
                 "diameter_estimate": 0, "weakly_connected_components": 0,
                 "largest_wcc_size": 0, "pagerank_top10_percent": 0.5}


class GraphOf:
    """A graph store's view for ``ACSAutomata``: the nodes of an
    undirected networkx graph as entities, each edge as two relations."""

    def __init__(self, graph):
        self.entities = {f"n{i}": {} for i in graph.nodes}
        self.chunks = {}
        self.rels = [(f"n{a}", "r", f"n{b}") for a, b in graph.edges] + [
            (f"n{b}", "r", f"n{a}") for a, b in graph.edges]
        self.from_chunk = []


def acs_ms(acs, names, adj, backend: str, reps: int = 3) -> float:
    """Mean ms of a full metric pass (``_compute``) after one warm-up."""
    acs._compute(names, adj, backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        acs._compute(names, adj, backend)
    return (time.perf_counter() - t0) / reps * 1e3


def jax_draws() -> dict:
    """``tests/torch_jax_draws.json``: the JAX package's seeded draws,
    Louvain run and weight statistics (``tests/make_torch_jax_draws.py``)."""
    return json.loads((ROOT / "tests" / "torch_jax_draws.json").read_text())


def fixture_graph(rec: dict):
    """The fixture's graph, its nodes 0..n-1 in order (``networkx`` on the
    card may draw another Barabasi-Albert graph from the same seed)."""
    import networkx as nx

    graph = nx.Graph()
    graph.add_nodes_from(range(rec["nodes"]))
    graph.add_edges_from(map(tuple, rec["edges"]))
    return graph


def louvain_vs_jax(graph, rec: dict) -> dict:
    """``_louvain`` on the card, with the port's own masks, on the fixture's
    graph padded as the sweep pads it: labels and community count equal to
    JAX's, modularity within ``LOUVAIN_Q_TOL``."""
    import networkx as nx

    from vidgraph_tpu_torch.pipeline import acs as tacs

    adj = nx.to_numpy_array(graph, nodelist=range(rec["nodes"]))
    a, valid = tacs._padded(adj.astype(np.float32))
    assert a.shape[0] == rec["pad"], a.shape
    with tacs._full_f32():
        labels, q, k = tacs._louvain(a, valid)
    labels = labels.cpu().numpy()
    same = int((labels == np.asarray(rec["labels"])).sum())
    res = {"communities": int(k), "jax_communities": rec["communities"],
           "modularity": float(q), "jax_modularity": rec["modularity"],
           "q_gap": abs(float(q) - rec["modularity"]),
           "labels_equal": same, "nodes_padded": len(labels),
           "device": str(a.device)}
    assert same == len(labels), f"Louvain labels differ from JAX's: {res}"
    assert int(k) == rec["communities"], res
    assert res["q_gap"] <= LOUVAIN_Q_TOL, res
    return res


def phase_acs(card: str) -> dict:
    """The ACS device sweep on the card against exact NetworkX on
    bench.py's 926-node graph (taken from the fixture), Louvain against
    the JAX package's on it, then both backends' times by graph size."""
    import networkx as nx

    from vidgraph_tpu_torch.core.config import ACSConfig
    from vidgraph_tpu_torch.pipeline import acs as tacs

    ref = jax_draws()["louvain"]
    graph = fixture_graph(ref)
    louvain = louvain_vs_jax(graph, ref)
    store = GraphOf(graph)
    calls = []
    real = tacs._acs_fused

    def counted(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    tacs._acs_fused = counted
    try:
        dev = tacs.ACSAutomata(store, ACSConfig(backend="auto")) \
            .update_metrics()
    finally:
        tacs._acs_fused = real
    assert "error" not in dev and calls == [1024], (dev, calls)
    assert dev["louvain_communities"] == ref["communities"], dev
    assert dev["louvain_modularity"] == round(ref["modularity"], 4), dev
    exact = tacs.ACSAutomata(store, ACSConfig(
        backend="networkx", exact_efficiency_max_nodes=10 ** 6,
        betweenness_k=10 ** 6)).update_metrics()
    gaps = {}
    for key, want in exact.items():
        if key in ("computational_time", "louvain_communities",
                   "louvain_modularity"):
            continue
        tol = ACS_NAMED_TOL.get(key, ACS_OTHER_TOL)
        got = dev[key]
        if got is None or want is None:
            assert got == want, (key, got, want)
            continue
        gaps[key] = abs(got - want)
        assert gaps[key] <= tol, f"ACS {key}: device {got}, NetworkX {want}"
    times = {}
    for n in ACS_SIZES:
        g = graph if n == 926 else nx.barabasi_albert_graph(n, 2, seed=0)
        adj = nx.to_numpy_array(g).astype(np.float32)
        names = [f"n{i}" for i in range(n)]
        acs = tacs.ACSAutomata(GraphOf(g), ACSConfig())
        times[f"{n}n"] = {"device_ms": acs_ms(acs, names, adj, "xla"),
                          "networkx_ms": acs_ms(acs, names, adj,
                                                "networkx", reps=1)}
    res = {"metrics_device": dev, "metrics_networkx_exact": exact,
           "gaps": gaps, "louvain_vs_jax": louvain,
           "acs_full_metrics_ms_926n":
           times["926n"]["device_ms"], "times": times,
           "auto_min_nodes": tacs._AUTO_XLA_MIN_NODES}
    log(f"phase 16: ACS device sweep on {card} equals exact NetworkX on the "
        f"926-node graph (Louvain aside), and its Louvain the JAX package's "
        f"(labels, {louvain['communities']} communities, Q gap "
        f"{louvain['q_gap']:.3g}); ms by graph size: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 17
STREAM_SECONDS = 4.0
STREAM_K = 3
# the stream memories' row counts at which the top-k kernel is checked:
# empty, one row, k - 1 rows, several hundred (capacity 1024, d 512)
STREAM_STORE_ROWS = (0, 1, STREAM_K - 1, 300)
# phase 17: a greedy byte of a chunk's caption in the batch of 8 may
# differ from the chunk's own B = 1 caption only at a near-tie: at the
# first differing step, the B = 1 context's teacher-forced logits (bf16,
# steps of 0.0078 near 1) of the two bytes within this of each other
CAPTION_TIE_TOL = 0.05


def flash_pairs(t: int, nv: int) -> int:
    """Query-key pairs the prefix-causal mask lets through."""
    return sum(min(max(r, nv - 1), t - 1) + 1 for r in range(t))


def stream_kernels(tc, chunks: np.ndarray, seed: int) -> dict:
    """Kernels 2, 3a and 1 against their plain versions at the shapes the
    stream runtime gives them: preprocessing of 5, 40 and 80 frames of
    240 x 320 (fast and exact; a paced engine that fell behind batches two
    windows of 8 streams), the captioner's prefill (nv 8 + BOS, 8 heads x
    64, bf16) at B 1, 8 and 16, and the top-k of a stream's memory
    (capacity 1024 x 512) holding 0, 1, k - 1 and 300 rows; with their
    times and bounds."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.parallel.serving import make_embedding_store

    out = {"preprocess": {}, "flash": {}, "cosine": {}}
    frames = chunks.reshape(-1, *chunks.shape[2:])
    frames = np.concatenate([frames, frames[::-1]])
    for nf in (5, 40, 80):
        x = torch.from_numpy(np.ascontiguousarray(frames[:nf])).cuda()
        for fast in (True, False):
            got = pre.preprocess_frames(x, 224, fast)
            torch.cuda.synchronize()
            ref = pre.preprocess_ref(x, 224, fast)
            tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
            err = float((got.float() - ref.float()).abs().max())
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert bool(torch.isfinite(got).all()) and err <= tol, \
                f"preprocess {nf}x240x320 fast={fast}: {err} > {tol}"
            out_bytes = nf * 224 * 224 * 3 * got.element_size()
            out["preprocess"][f"b{nf}_240x320_"
                              f"{'fast' if fast else 'exact'}"] = {
                "max_abs_err": err, "tol": tol,
                "kernel_ms": graph_ms(
                    lambda: pre.preprocess_frames(x, 224, fast)),
                "plain_ms": graph_ms(lambda: pre.preprocess_ref(x, 224,
                                                                fast)),
                "library_ms": graph_ms(lambda: library_resize(x, 224)),
                **bound(x.numel() + out_bytes, 0.0, F32_FLOPS)}
    rng = np.random.default_rng(seed + 17)
    t, nv = 9, 8
    for b in (1, 8, 16):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, 8, 64), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        got = fa.flash_attention(q, k, v, nv)
        torch.cuda.synchronize()
        ref = fa.attention_ref(q, k, v, nv).to(torch.bfloat16).float()
        err = (got.float() - ref).abs()
        excess = float((err - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max())
        assert bool(torch.isfinite(got).all()) and excess <= 0, \
            f"flash prefill b={b}: max |err| {float(err.max())}"
        mask = fa.prefix_causal_mask(t, nv, q.device)
        out["flash"][f"b{b}_T{t}"] = {
            "max_abs_err": float(err.max()),
            "kernel_ms": graph_ms(lambda: fa.flash_attention(q, k, v, nv)),
            "plain_ms": graph_ms(lambda: fa.attention_ref(q, k, v, nv)),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask)),
            **bound(4 * b * t * 8 * 64 * 2, 4.0 * b * 8 * 64
                    * flash_pairs(t, nv), BF16_FLOPS)}
    host = rng.normal(size=(1024, DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    query = torch.from_numpy(rng.normal(size=(1, DIM)).astype(np.float32)
                             ).cuda()
    for rows in STREAM_STORE_ROWS:
        err = check_topk(tc, query, store, STREAM_K, rows)
        out["cosine"][f"rows{rows}"] = {"max_abs_err": err}
    past = torch.arange(1024, device="cuda") >= 300
    out["cosine"]["rows300"].update({
        "kernel_ms": cuda_ms(lambda: tc.cosine_topk(query, store, STREAM_K,
                                                    count=300)),
        "device_ms": graph_ms(lambda: tc.cosine_topk(query, store, STREAM_K,
                                                     count=300)),
        "plain_ms": cuda_ms(lambda: tc.cosine_topk_ref(query, store,
                                                       STREAM_K, count=300)),
        "library_ms": cuda_ms(lambda: library_topk(query, store, past,
                                                   STREAM_K)),
        # the 300 rows the count lets in, the query and the top-k out
        **bound(300 * DIM * 4 + DIM * 4 + STREAM_K * 8,
                2.0 * 300 * DIM, F32_FLOPS)})
    before = dict(tc.LAUNCHES)
    empty = make_embedding_store(dim=DIM)
    assert empty.search(host[:1], k=STREAM_K) == [[]]
    assert tc.LAUNCHES == before, "an empty memory launched a kernel"
    return out


def caption_tokens(vlm, chunks) -> tuple:
    """The tokens ``caption_batch_sync`` decodes for ``chunks`` in one
    batch, and the batch's vision prefixes."""
    from vidgraph_tpu_torch.models.captioner import generate

    emb = vlm.embed_frames(vlm.host_frames(chunks))
    vis = vlm.vision_prefixes(chunks, emb)
    return generate(vlm._serve_params, vlm.cap_cfg, vis,
                    max_new=vlm.max_new), vis


def caption_gap(vlm, vis, a: np.ndarray, b: np.ndarray):
    """None where the token rows ``a`` (``vlm``'s own, from the vision
    prefix ``vis`` [nv, d]) and ``b`` are equal; else the first step where
    they differ and the gap there between the two bytes' logits of ``a``'s
    context (teacher-forced ``forward`` on its own bytes)."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import forward

    diff = np.nonzero(a != b)[0]
    if not len(diff):
        return None
    s = int(diff[0])
    ctx = torch.from_numpy(np.concatenate(
        [[tokenizer.BOS_ID], a[:s]]).astype(np.int64))[None].to(vis.device)
    with torch.no_grad():
        logits = forward(vlm._serve_params, vlm.cap_cfg, vis[None], ctx)[0, -1]
    top2 = torch.topk(logits, 2).values
    return {"first_differing_step": s, "ref_byte": int(a[s]),
            "got_byte": int(b[s]),
            "logit_gap": float(logits[int(a[s])] - logits[int(b[s])]),
            "top2_gap": float(top2[0] - top2[1])}


def assert_near_tie(where: str, gap: dict) -> None:
    log(f"{where} differ first at step {gap['first_differing_step']}: "
        f"{json.dumps(gap)}")
    assert abs(gap["logit_gap"]) < CAPTION_TIE_TOL, \
        f"{where}: the bytes differ with a logit gap {gap['logit_gap']} " \
        f"(not a near-tie under {CAPTION_TIE_TOL})"


def batch_vs_single(vlm, chunks) -> dict:
    """The batch of 8 chunks' captions against each chunk's own B = 1
    caption: equal, or the first differing byte a near-tie of the B = 1
    context's logits (``ref_byte`` B = 1's, ``got_byte`` the batch's)."""
    toks8, _ = caption_tokens(vlm, chunks)
    rows = []
    for i, chunk in enumerate(chunks):
        toks1, vis1 = caption_tokens(vlm, [chunk])
        gap = caption_gap(vlm, vis1[0], toks1[0].cpu().numpy(),
                          toks8[i].cpu().numpy())
        if gap is None:
            rows.append({"equal": True})
            continue
        rows.append({"equal": False, **gap})
        assert_near_tie(f"phase 17: chunk {i}: the batch of 8 and B = 1",
                        gap)
    return {"chunks": len(chunks), "equal": sum(r["equal"] for r in rows),
            "differing": [r for r in rows if not r["equal"]]}


def phase_streams(tc, seed: int, card: str) -> dict:
    """The live multi-stream runtime at full width (``backend.vlm: tpu``,
    ViT-B/32 + ``base()`` from seed 0, the hash embed client), through
    ``scripts/measure_torch_stream_scaling.py``'s runs: 1 and 8 streams as
    fast as the card allows, 8 paced by the wall clock, ``STREAM_SECONDS``
    of 240 x 320 video at 30 fps each, queries every 0.5 s, a live KG on
    the local chat client behind the 8-stream run."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu_torch.services.llm_client import LocalChatClient
    from vidgraph_tpu_torch.streams import LiveKGIngestor

    mod = load_script("measure_torch_stream_scaling")
    vlm, embed = mod.serving_clients()
    banks = [mod.frame_bank(i, seed) for i in range(8)]
    offsets = np.linspace(0, int(mod.FPS * mod.CHUNK_SECONDS) - 1,
                          mod.FRAMES_PER_CHUNK).astype(int)
    chunks = np.stack([bank[offsets] for bank in banks])
    kernels = stream_kernels(tc, chunks, seed)
    log(f"phase 17: kernels 2, 3a and 1 agree with their plain versions at "
        f"the stream's shapes; times on {card} (ms; graph replay for "
        f"preprocessing and flash, CUDA events for the top-k): "
        f"{json.dumps(kernels)}")
    mod.run(8, vlm, embed, 1.0, realtime=False, seed=seed,
            with_queries=False, banks=banks)             # first calls

    reset_vision_counts()
    tc.reset_counts()
    cfg = PipelineConfig()
    cfg.backend.llm = "local"
    ingestor = LiveKGIngestor(
        cfg, LocalChatClient(), embed,
        store_factory=lambda sid: EmbeddedGraphStore(
            sid, persist_dir=None, persist=False, dim=embed.dim))
    runs, engines = {}, {}
    for name, n, realtime, kg in (("1_stream", 1, False, None),
                                  ("8_streams", 8, False, ingestor),
                                  ("8_streams_realtime", 8, True, None)):
        engines[name], runs[name] = mod.run(
            n, vlm, embed, STREAM_SECONDS, realtime=realtime, seed=seed,
            kg_extractor=kg, banks=banks[:n])
    asyncio.run(ingestor.flush())
    torch.cuda.synchronize()
    counts = {**vision_counts(), **{f"cosine_{k}": v
                                    for k, v in tc.LAUNCHES.items()}}
    counts["plain"] += tc.REF_CALLS
    batches = sum(r["batches"] for r in runs.values())
    log(f"phase 17: launches in the stream runs {json.dumps(counts)} for "
        f"{batches} caption batches")
    assert counts["preprocess"] >= batches, counts
    assert counts["flash"] == vlm.cap_cfg.layers * batches, counts
    assert counts["cosine_score_topk"] > 0, counts
    assert counts["cosine_select"] == 0, counts
    assert counts["plain"] == 0, f"a plain version served {counts}"

    for name, engine in engines.items():
        out = runs[name]
        for sid, st in out["streams"].items():
            assert st["chunks_done"] > 0, f"{name}: {sid} did no chunk"
        assert engine.answers, f"{name}: no query was answered"
        # each stream asked for one of its own captions: the hit is that
        # chunk (or one with the same caption), as every hit is its own
        for sid, caps in engine.captions.items():
            cap = next(iter(caps.values()))
            asyncio.run(engine.query(sid, cap["content"]))
            same = {c["id"] for c in caps.values()
                    if c["content"] == cap["content"]}
            top = engine.answers[-1]["chunks"]
            assert top and top[0]["id"] in same and \
                top[0]["score"] > 0.99, f"{name}: {sid}: {top}"
        for ans in engine.answers:
            assert all(c["id"].startswith(f"{ans['stream']}_")
                       for c in ans["chunks"]), f"{name}: {ans}"
        # unpaced, every window of every stream completes at once; paced,
        # an overloaded engine keeps up to max_lag_windows a stream
        most = len(out["streams"]) * (engine.max_lag_windows
                                      if name.endswith("realtime") else 1)
        assert max(engine.batch_sizes) <= most and (
            name.endswith("realtime")
            or set(engine.batch_sizes) == {len(out["streams"])}), \
            (name, engine.batch_sizes)
    graphs = {sid: {"nodes": s.get_node_count(),
                    "rels": s.get_relationship_count()}
              for sid, s in ingestor.stores.items()}
    assert len(graphs) == 8 and all(g["nodes"] > 0 for g in graphs.values()), \
        graphs
    ingestor.close()
    captions = batch_vs_single(vlm, [list(c) for c in chunks])
    profile = mod.profile_process_ready(8, vlm, embed, seed)
    keys = ("realtime_factor", "coverage", "total_shed_chunks",
            "total_dropped_frames", "chunk_latency_p50_ms",
            "query_under_load_p50_ms", "query_under_load_p95_ms",
            "query_p50_ms", "query_p95_ms", "queries_served", "batches",
            "chunks_per_batch",
            "chunks_done", "wall_seconds")
    res = {"runs": {name: {k: r[k] for k in keys} for name, r in
                    runs.items()},
           "video_seconds": STREAM_SECONDS, "live_kg": graphs,
           "counts": counts, "launches_per_process_ready": {
               "flash": counts["flash"] / batches,
               "preprocess": counts["preprocess"] / batches,
               "all_kernels_profiled": profile["launches"]},
           "device_busy_share": profile["device_busy_share"],
           "profile_process_ready": profile, "captions_b8_vs_b1": captions,
           "kernels": kernels}
    log(f"phase 17: streams on {card} (realtime_factor of the unpaced runs "
        f"is their throughput factor): {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 18
SERVE_STREAMS, SERVE_CHUNKS, SERVE_QUERIES = 4, 240, 24


async def _http(port: int, method: str, path: str, body=None):
    """One request to the server on localhost: (status, JSON, ms)."""
    t = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Type: application/json\r\nContent-Length: "
                 f"{len(payload)}\r\nConnection: close\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    ms = (time.perf_counter() - t) * 1e3
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), json.loads(data), ms


def serve_requests(seed: int, long_rows: int = 0) -> list:
    """The session's requests: ``SERVE_CHUNKS`` ingests over
    ``SERVE_STREAMS`` streams, ``SERVE_QUERIES`` queries, four retrieves
    on the bench graph, the stats; with ``long_rows``, before the
    retrieves, that many ingests into a stream ``cam_long`` and four
    queries of it."""
    import bench

    rng = random.Random(seed)
    reqs = []
    for i in range(SERVE_CHUNKS):
        sid = f"cam{i % SERVE_STREAMS}"
        reqs.append(("POST", "/v1/ingest", {
            "stream": sid, "chunk_id": f"{sid}_{i // SERVE_STREAMS}",
            "time": f"00:{i % 60:02d}-00:{(i + 4) % 60:02d}",
            "content": f"chunk {i}: the person {rng.choice(bench._VERBS)} a "
                       f"{rng.choice(bench._COLORS)} "
                       f"{rng.choice(bench._OBJECTS)} near the "
                       f"{rng.choice(bench._OBJECTS)}"}))
    for i in range(SERVE_QUERIES):
        reqs.append(("POST", "/v1/query", {
            "stream": f"cam{i % SERVE_STREAMS}", "k": 3,
            "query": f"where is the {rng.choice(bench._COLORS)} "
                     f"{rng.choice(bench._OBJECTS)}"}))
    for i in range(long_rows):
        reqs.append(("POST", "/v1/ingest", {
            "stream": "cam_long", "chunk_id": f"cam_long_{i}",
            "content": f"chunk {i}: a {rng.choice(bench._COLORS)} "
                       f"{rng.choice(bench._OBJECTS)}"}))
    for i in range(4 if long_rows else 0):
        reqs.append(("POST", "/v1/query", {
            "stream": "cam_long", "k": 3,
            "query": f"a {rng.choice(bench._COLORS)} "
                     f"{rng.choice(bench._OBJECTS)}"}))
    for i in range(4):
        reqs.append(("POST", "/v1/retrieve", {
            "graph_uuid": "bench", "query": f"What color is the "
            f"{rng.choice(bench._OBJECTS)} on the bench?"}))
    reqs.append(("GET", "/v1/stats", None))
    return reqs


def bench_graph_config(root: Path):
    """A config whose graph store holds the bench graph (built, exported
    and imported under uuid ``bench`` into ``root/gs``)."""
    import bench
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu_torch.graph.exporter import (GraphExporter,
                                                   GraphImporter)
    from vidgraph_tpu_torch.services.embed_client import make_embed_client

    src = EmbeddedGraphStore("bench_src", persist_dir=None, persist=False)
    bench._build_graph(src, make_embed_client("tpu", dim=512),
                       random.Random(42))
    export = GraphExporter(src).export_graph(str(root / "bench.json"))
    GraphImporter(lambda uuid: EmbeddedGraphStore(
        uuid, persist_dir=str(root / "gs"))).import_graph(export, "bench")
    cfg = PipelineConfig()
    cfg.graph_store.persist_dir = str(root / "gs")
    return cfg


def http_session(server, reqs) -> list:
    """Start ``server`` on its port, send ``reqs`` over HTTP in order,
    stop it; the responses."""
    async def run():
        await server.start()
        try:
            return [await _http(server.port, m, p, b) for m, p, b in reqs]
        finally:
            await server.stop()
    return asyncio.run(run())


def serve_session(device: str, seed: int, tmp: Path) -> list:
    """``VideoMemoryServer`` on ``device`` on an ephemeral port, with the
    bench graph built, exported and imported under uuid ``bench``; every
    request of ``serve_requests`` over HTTP, in order."""
    from vidgraph_tpu_torch.services.server import VideoMemoryServer

    os.environ["VIDGRAPH_TORCH_DEVICE"] = device
    try:
        cfg = bench_graph_config(tmp / device)
        return http_session(VideoMemoryServer(cfg, port=0),
                            serve_requests(seed))
    finally:
        os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"


def same_hits(got: list, ref: list) -> bool:
    """Query hits equal: ids, contents and times in order, scores within
    ``TOL``; hits whose scores tie within ``TOL`` in any order."""
    if len(got) != len(ref) or any(abs(g["score"] - r["score"]) > TOL
                                   for g, r in zip(got, ref)):
        return False
    def groups(hits):
        out, last = [], None
        for h in hits:
            if last is None or abs(h["score"] - last) > TOL:
                out.append(set())
            out[-1].add(h["id"])
            last = h["score"]
        return out
    return groups(got) == groups(ref)


def session_diffs(reqs, got, ref) -> list:
    """The routes of ``reqs`` whose responses in ``got`` differ from
    ``ref``'s: query hits by ``same_hits``, retrieved texts, the rest
    whole.  Every response of ``got`` must be a 200 with ``ok``, with the
    keys of ``ref``'s, and every hit its own stream's."""
    assert all(code == 200 for code, _, _ in got), \
        [c for c in got if c[0] != 200][:3]
    diffs = []
    for (_m, path, body), (_, g, _), (_, r, _) in zip(reqs, got, ref):
        assert g.get("ok") and set(g) == set(r), (path, g, r)
        if path == "/v1/query":
            ok = same_hits(g["chunks"], r["chunks"])
            assert all(c["id"].startswith(f"{body['stream']}_")
                       for c in g["chunks"]), g
        elif path == "/v1/retrieve":
            ok = g["retrieval"] == r["retrieval"]
            assert g["retrieval"].startswith("Found results"), g
        else:
            ok = g == r
        if not ok:
            diffs.append(path)
    return diffs


def phase_serve(tc, seed: int, card: str) -> dict:
    """The HTTP service on the card: ingest, query, retrieve and stats
    through ``VideoMemoryServer``, then the same session on the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tc.reset_counts()
        cuda = serve_session("cuda", seed, tmp)
        launches = launch_counts(tc)
        cpu = serve_session("cpu", seed, tmp)
    reqs = serve_requests(seed)
    diffs = session_diffs(reqs, cuda, cpu)
    assert not diffs, f"responses differ from the CPU run's: {diffs}"
    assert launches["score_topk"] >= SERVE_QUERIES and \
        launches["plain"] == 0, launches
    stats = cuda[-1][1]
    assert stats["streams"] == {f"cam{i}": SERVE_CHUNKS // SERVE_STREAMS
                                for i in range(SERVE_STREAMS)}, stats
    by_route = {}
    for (_, path, _), (_, _, ms) in zip(reqs, cuda):
        by_route.setdefault(path, []).append(ms)
    res = {"requests": len(reqs), "launches": launches,
           "request_p50_ms": {p: statistics.median(v)
                              for p, v in by_route.items()},
           "request_max_ms": {p: max(v) for p, v in by_route.items()},
           "all_p50_ms": statistics.median(ms for _, _, ms in cuda),
           "equal_to_cpu": True}
    log(f"phase 18: the HTTP server on {card}: every response's keys, hits "
        f"and retrieved texts equal the CPU run's: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 19
# the encoders on the card against the same module on the CPU with the
# same weights: the bfloat16 text embedder per component of its unit
# vectors, the float32 models max |diff| / max(1, max |cpu|)
ENC_BF16_TOL = 3e-3
ENC_F32_TOL = 1e-5
# the card times all of bench's queries after its warm-ups; the CPU runs
# the first few of them, unwarmed, for comparison only: ~1,250
# cross-encoder pairs a query, seconds a query on the card machine's 8
# cores
ENC_CPU_QUERIES = 2


def host_ms_of(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()``, which ends on the host."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def busy_share(fn, wall_ms: float) -> float:
    """The device's busy time in one profiled ``fn()`` over its
    unprofiled wall ``wall_ms``."""
    from vidgraph_tpu_torch.core.profiling import profile_device

    return profile_device(fn)["device_busy_ms"] / wall_ms


def encoder_texts(n: int, seed: int) -> list:
    import bench

    rng = random.Random(seed)
    return [f"Time: 00:{i % 60:02d} Content: the person "
            f"{rng.choice(bench._VERBS)} a {rng.choice(bench._COLORS)} "
            f"{rng.choice(bench._OBJECTS)} on the laboratory bench while a "
            f"{rng.choice(bench._COLORS)} {rng.choice(bench._OBJECTS)} sits "
            f"nearby ({i})" for i in range(n)]


def phase_encoders(seed: int, card: str) -> dict:
    """The trained encoders at their default widths with the port's
    seeded weights, on the card against the CPU: the text embedder
    (bf16, and float32 at B 8) at B 8/64/256, the cross-encoder at 8/16/32
    pairs, the answer selector on bench's retrieval contexts; then bench's
    retrieval under ``backend.reranker: trained`` and ``backend.embedder:
    transformer``."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.answer_selector import AnswerSelector
    from vidgraph_tpu_torch.models.reranker import (CrossEncoderReranker,
                                                    batch_encode_pairs,
                                                    score_tokens)
    from vidgraph_tpu_torch.models.text_embedder import \
        TransformerTextEmbedder

    gpu, cpu = torch.device("cuda"), torch.device("cpu")
    texts = encoder_texts(256, seed)
    res = {"embedder": {}, "reranker": {}, "selector": {}}
    for dtype, tol, sizes in ((torch.bfloat16, ENC_BF16_TOL, (8, 64, 256)),
                              (torch.float32, ENC_F32_TOL, (8,))):
        on_gpu = TransformerTextEmbedder(seed=seed, dtype=dtype, device=gpu)
        on_cpu = TransformerTextEmbedder(seed=seed, dtype=dtype, device=cpu)
        for b in sizes:
            toks = tokenizer.batch_encode(texts[:b], on_gpu.max_len)
            got, want = on_gpu._forward(toks), on_cpu._forward(toks)
            err = float(np.abs(got - want).max())
            assert np.isfinite(got).all() and err <= tol, \
                f"embedder {dtype} B={b}: {err} > {tol}"
            ms = host_ms_of(lambda: on_gpu._forward(toks))
            res["embedder"][f"{str(dtype)[6:]}_b{b}"] = {
                "max_abs_err": err, "tol": tol, "ms": ms,
                "device_busy_share": busy_share(
                    lambda: on_gpu._forward(toks), ms)}
    rr_gpu = CrossEncoderReranker(seed=seed, device=gpu)
    rr_cpu = CrossEncoderReranker(seed=seed, device=cpu)
    query = "what color is the beaker on the bench?"
    for n in (8, 16, 32):
        toks = batch_encode_pairs(query, texts[:n], rr_gpu.cfg)
        got = score_tokens(rr_gpu.params, rr_gpu.cfg, toks, gpu)
        want = score_tokens(rr_cpu.params, rr_cpu.cfg, toks, cpu)
        err = float(np.abs(got - want).max())
        limit = ENC_F32_TOL * max(1.0, float(np.abs(want).max()))
        assert np.isfinite(got).all() and err <= limit, \
            f"reranker {n} pairs: {err} > {limit}"
        ms = host_ms_of(lambda: score_tokens(rr_gpu.params, rr_gpu.cfg,
                                             toks, gpu))
        res["reranker"][f"pairs{n}"] = {
            "max_abs_err": err, "tol": limit, "ms": ms,
            "device_busy_share": busy_share(lambda: score_tokens(
                rr_gpu.params, rr_gpu.cfg, toks, gpu), ms)}
    del rr_gpu, rr_cpu

    retrieval = bench_retrieval("cuda", embedder="transformer",
                                reranker="trained")
    cpu_run = bench_retrieval("cpu", embedder="transformer",
                              reranker="trained", queries=ENC_CPU_QUERIES,
                              warmup=0)
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    assert all(retrieval["texts"]), "an empty retrieval text"
    res["retrieval"] = {
        "queries": len(retrieval["queries"]), "p50_ms": retrieval["p50_ms"],
        "p95_ms": retrieval["p95_ms"], "cpu_queries": ENC_CPU_QUERIES,
        "texts_equal_cpu": sum(a == b for a, b in zip(retrieval["texts"],
                                                      cpu_run["texts"])),
        "cpu_p50_ms": cpu_run["p50_ms"]}
    for mode in ("blend", "pure"):
        sel_gpu = AnswerSelector(seed=seed, mode=mode, device=gpu)
        sel_cpu = AnswerSelector(seed=seed, mode=mode, device=cpu)
        questions = retrieval["queries"][:4]
        contexts = retrieval["texts"][:4]
        got = [sel_gpu.answer(q, c) for q, c in zip(questions, contexts)]
        want = [sel_cpu.answer(q, c) for q, c in zip(questions, contexts)]
        assert all(got), got
        res["selector"][mode] = {
            "answers_equal_cpu": sum(a == b for a, b in zip(got, want)),
            "answers": len(got),
            "ms": host_ms_of(lambda: sel_gpu.answer(questions[0],
                                                    contexts[0]), reps=3)}
        assert got == want, f"selector {mode}: answers differ from the CPU"
    log(f"phase 19: the trained encoders on {card} agree with the CPU: "
        f"{json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 20
# the first step's loss of each encoder trainer, on the card and on the
# CPU from the same seed weights and batch (float32; TF32 off)
TRAINER_LOSS_TOL = 1e-4
# steps a trainer takes at full width on the card, and the loss must fall
# over them: the mean of the last quarter below the first quarter's
ENC_TRAIN_STEPS = {"reranker": 200, "answer_selector": 100,
                   "text_embedder": 100}


def falls(losses) -> bool:
    q = max(1, len(losses) // 4)
    return float(np.mean(losses[-q:])) < float(np.mean(losses[:q]))


def card_vs_cpu_loss(loss_at) -> dict:
    """``loss_at(device)`` (a float32 loss from seed weights and a fixed
    batch, built on ``device``) on the card and on the CPU."""
    card = loss_at(torch.device("cuda"))
    cpu = loss_at(torch.device("cpu"))
    assert math.isfinite(card) and abs(card - cpu) <= TRAINER_LOSS_TOL, \
        f"first-step loss on the card {card}, on the CPU {cpu}"
    return {"card": card, "cpu": cpu, "abs_diff": abs(card - cpu),
            "tol": TRAINER_LOSS_TOL}


def step_busy_share(params, loss_fn, **opt_kw) -> dict:
    """One training step as the trainer takes it (its own AdamW;
    ``loss_fn()`` builds the batch as the trainer's loop does and returns
    the loss on the card): its unprofiled ms (median of 5, ending in a
    synchronise) and the device's busy share of one profiled step over
    that."""
    from vidgraph_tpu_torch.models.train import AdamW

    opt = AdamW(params, 1e-5, **opt_kw)

    def step():
        opt.zero_grad()
        loss_fn().backward()
        opt.update()
        torch.cuda.synchronize()
    ms = host_ms_of(step)
    return {"step_ms": ms, "device_busy_share": busy_share(step, ms)}


def trainer_record(name: str, rec: dict, wall: float, **extra) -> dict:
    losses = rec["losses"]
    assert all(np.isfinite(losses)), f"{name}: a loss is not finite"
    assert falls(losses), f"{name}: the loss did not fall: {losses}"
    q = max(1, len(losses) // 4)
    return {"steps": len(losses), "wall_s": wall,
            "first_quarter_loss": float(np.mean(losses[:q])),
            "last_quarter_loss": float(np.mean(losses[-q:])),
            "step_ms": rec["step_ms"],
            "peak_memory_gb": rec["peak_memory_gb"], **extra}


def phase_encoder_trainers(seed: int, card: str) -> dict:
    """The three encoder trainers through their ``main`` at the JAX
    scripts' default widths on ``training_corpus``: the loss falls, the
    first step's loss equals the CPU's, the checkpoint serves through the
    port's classes; ms a step, busy share, peak memory."""
    from vidgraph_tpu_torch.models import instruct_data
    from vidgraph_tpu_torch.models.answer_selector import AnswerSelector
    from vidgraph_tpu_torch.models.captioner import trainable
    from vidgraph_tpu_torch.models.reranker import (CrossEncoderReranker,
                                                    RerankerConfig,
                                                    batch_encode_pairs,
                                                    init_reranker_params)
    from vidgraph_tpu_torch.models.text_embedder import (init_encoder_params,
                                                         needed_columns)
    from vidgraph_tpu_torch.services.embed_client import make_embed_client

    gpu = torch.device("cuda")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        corpus = str(training_corpus(tmp, seed))

        # (a) the cross-encoder reranker, RerankerConfig(): 8 groups x 12
        mod = load_script("train_torch_reranker")
        out = tmp / "reranker.npz"
        t0 = time.perf_counter()
        rec = mod.main(["--corpus", corpus, "--steps",
                        str(ENC_TRAIN_STEPS["reranker"]),
                        "--synth-groups", "400",
                        "--heldout", "24", "--seed", str(seed),
                        "--out", str(out)])
        wall = time.perf_counter() - t0
        cfg = RerankerConfig()
        hash_embed = make_embed_client("tpu", dim=512)
        # a batch as the trainer draws them: most hold a corpus group of
        # long chunks (T up to 512) beside short synthetic ones
        chunks = list(dict.fromkeys(
            r["content"] for r in json.loads(Path(corpus).read_text())
            ["results"] if r.get("content")))
        groups = (mod.build_groups(chunks, random.Random(seed))[:4]
                  + mod.synthetic_groups(random.Random(seed), 4))
        toks = np.stack([batch_encode_pairs(q, d, cfg) for q, d, _ in groups])
        toks = toks[..., :int(needed_columns(toks).max())]
        pos = np.array([p for _, _, p in groups], np.int64)
        sims = mod.cosine_prior(groups, hash_embed)

        def rr_batch(dev):
            return [torch.as_tensor(a, device=dev) for a in (toks, pos, sims)]

        def rr_loss(dev):
            with torch.no_grad():
                return mod.reranker_loss(init_reranker_params(cfg, seed, dev),
                                         cfg, *rr_batch(dev), 8.0,
                                         0.02).item()
        params = trainable(init_reranker_params(cfg, seed, gpu))
        busy = step_busy_share(params, lambda: mod.reranker_loss(
            params, cfg, *rr_batch(gpu), 8.0, 0.02), weight_decay=0.01,
            max_norm=1.0)
        served = CrossEncoderReranker(checkpoint_path=str(out),
                                      embed_client=hash_embed)
        scores = served.score(groups[0][0], groups[0][1])
        assert served.cosine_lambda == 8.0 and scores.shape == (12,) and \
            np.isfinite(scores).all(), scores
        res["reranker"] = trainer_record(
            "reranker", rec, wall, first_step_loss=card_vs_cpu_loss(rr_loss),
            one_step=busy, heldout=rec["heldout"],
            groups=rec["groups"],
            shape="RerankerConfig() (256 x 4 layers, 4 heads, max_len "
                  "512), 8 groups x 12 documents a step, its default lr")
        del params, served

        # (b) the answer selector, RerankerConfig(max_len=256): 8 x K 64
        mod = load_script("train_torch_answer_selector")
        out = tmp / "answer_selector.npz"
        t0 = time.perf_counter()
        rec = mod.main(["--corpus", corpus, "--steps",
                        str(ENC_TRAIN_STEPS["answer_selector"]),
                        "--n-synth", "300", "--n-questions", "40",
                        "--eval-count", "24", "--seed", str(seed),
                        "--out", str(out)])
        wall = time.perf_counter() - t0
        cfg = RerankerConfig(max_len=256)
        rng = random.Random(seed)
        sents = [instruct_data.synth_sentence(rng) for _ in range(60)]
        pairs = instruct_data.synthetic_answer_pairs(sents, rng, 16)
        examples = mod.build_examples(pairs, cfg, 64, rng)[:8]
        arrays = [np.stack([e[i] for e in examples]) for i in range(3)]
        arrays[0] = arrays[0][..., :int(needed_columns(arrays[0]).max())
                              ].astype(np.int16)

        def sel_batch(dev):
            return [torch.as_tensor(a, device=dev) for a in arrays]

        def sel_loss(dev):
            with torch.no_grad():
                return mod.selector_loss(init_reranker_params(cfg, seed, dev),
                                         cfg, *sel_batch(dev), 1.0).item()
        params = trainable(init_reranker_params(cfg, seed, gpu))
        busy = step_busy_share(params, lambda: mod.selector_loss(
            params, cfg, *sel_batch(gpu), 1.0), weight_decay=0.01,
            max_norm=1.0)
        served = AnswerSelector(checkpoint_path=str(out))
        answer = served.answer(pairs[0][0], pairs[0][1])
        assert served.cfg.max_len == 256 and isinstance(answer, str) and \
            answer, answer
        res["answer_selector"] = trainer_record(
            "answer_selector", rec, wall,
            first_step_loss=card_vs_cpu_loss(sel_loss),
            one_step=busy, held_losses=rec["held_losses"],
            eval=rec["eval"], train_examples=rec["train_examples"],
            shape="RerankerConfig(max_len=256) (256 x 4 layers, 4 heads), "
                  "8 lists x K 64 candidates a step")
        del params, served

        # (c) the text embedder: 256 x 4 layers, dim 512, bf16 compute,
        # 128 documents (384) + 128 query views (96) a step
        mod = load_script("train_torch_text_embedder")
        out = tmp / "text_embedder.npz"
        t0 = time.perf_counter()
        rec = mod.main(["--corpus", corpus, "--steps",
                        str(ENC_TRAIN_STEPS["text_embedder"]), "--seed",
                        str(seed), "--out", str(out)])
        wall = time.perf_counter() - t0
        docs = mod.load_sentences(corpus)
        docs = [docs[i % len(docs)] for i in range(128)]
        queries = [mod.augment(s, np.random.default_rng(seed)) for s in docs]
        teacher = mod.HashedNGramEmbedder(dim=512)

        def te_batch(dev):
            # the trainer's host work a step: tokens and the teacher
            t_emb = teacher.embed(docs)
            return (mod.tokens(queries, 96, dev), mod.tokens(docs, 384, dev),
                    torch.as_tensor(t_emb @ t_emb.T, device=dev))

        def te_loss(dev, dtype=torch.float32):
            cfg = mod.encoder_config(256, 4, 4, 384, dtype)
            with torch.no_grad():
                return mod.embedder_loss(
                    init_encoder_params(cfg, 512, seed, dev), cfg,
                    *te_batch(dev), 0.05, 4.0)[0].item()
        cfg = mod.encoder_config(256, 4, 4, 384)
        params = trainable(init_encoder_params(cfg, 512, seed, gpu))
        busy = step_busy_share(params, lambda: mod.embedder_loss(
            params, cfg, *te_batch(gpu), 0.05, 4.0)[0], weight_decay=1e-4)
        client = make_embed_client("transformer", checkpoint_path=str(out))
        vecs = client.embed(docs[:5])
        assert vecs.shape == (5, 512) and np.allclose(
            np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3), vecs.shape
        res["text_embedder"] = trainer_record(
            "text_embedder", rec, wall,
            first_step_loss=card_vs_cpu_loss(te_loss),
            one_step=busy, recalls=rec["recalls"],
            hash_recall_at_1=rec["hash_recall_at_1"],
            shape="256 x 4 layers, 4 heads, dim 512, bf16 compute, 128 "
                  "documents (max_len 384) + 128 query views (96) a step")
        del params, client
        torch.cuda.empty_cache()
    log(f"phase 20: the encoder trainers at the JAX defaults' widths on "
        f"{card}: {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 21
# the sweep's workload at the reference's size (docs/EVAL.md: 215 chunks
# of 5 s, 72 kg batches of 3, a 30-question groundtruth set): synthetic
# lab captions of this many sentences, questions grounded in one of them
SWEEP_CHUNKS, SWEEP_SENTENCES, SWEEP_QUESTIONS = 215, 8, 30


def sweep_workload(tmp: Path, seed: int) -> tuple:
    """A vlm output of ``SWEEP_CHUNKS`` captions and ``SWEEP_QUESTIONS``
    distinct questions, each with the sentence it asks about as its
    groundtruth."""
    from vidgraph_tpu_torch.models import instruct_data

    rng = random.Random(seed)
    results, questions = [], []
    for i in range(SWEEP_CHUNKS):
        t = i * 5
        results.append({
            "time": f"{t // 60:02d}:{t % 60:02d}-{(t + 5) // 60:02d}:"
                    f"{(t + 5) % 60:02d}", "chunk_idx": i,
            "content": " ".join(instruct_data.synth_sentence(rng)
                                for _ in range(SWEEP_SENTENCES))})
    seen = set()      # the judge agreement keys its records by question
    for r in rng.sample(results, len(results)):
        sent = rng.choice(instruct_data.sentences_of([r["content"]]))
        query = instruct_data.synth_questions([sent], rng, 1)[0]
        if query not in seen and len(seen) < SWEEP_QUESTIONS:
            seen.add(query)
            questions.append({"query": query, "groundtruth": sent})
    assert len(questions) == SWEEP_QUESTIONS, len(questions)
    vlm, queries = tmp / "sweep_vlm_output.json", tmp / "sweep_queries.json"
    vlm.write_text(json.dumps({"results": results}))
    queries.write_text(json.dumps(questions))
    return vlm, queries


def counted_cli(self, *cli_args: str, timeout: float):
    """``EpochRunner._cli`` of ``scripts/run_torch_parameter_sweep.py``
    with each stage run as ``chip_smoke.py --cli COUNTS.json``: the same
    CLI ``main``, which writes its kernel launches at exit."""
    counts = self.out_dir / f"counts_{len(list(self.out_dir.glob('counts_*')))}.json"
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--cli", str(counts),
           *cli_args]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else []))}
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=str(self.out_dir), env=env)
        return proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired:
        return -1, "TIMEOUT"


def vit_b160_kernels(seed: int) -> dict:
    """Kernels 2 and 5 at ``profile_torch_vit.py``'s B = 160 shapes
    against their plain versions: its 720p frames (the same seed) ->
    224, and the first block's attention of the fused tower on them
    (strided views of one qkv product, as ``models/vit.py`` passes
    them); device times per call from a CUDA graph."""
    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.models.vit import ViTConfig, init_vision_tower
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    b, h, w = 160, 720, 1280
    x = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 256, size=(b, h, w, 3), dtype=np.uint8), device="cuda")
    got = pre.preprocess_frames(x, 224, True)
    torch.cuda.synchronize()
    ref = pre.preprocess_ref(x, 224, True)
    err = float((got.float() - ref.float()).abs().max())
    assert got.dtype == ref.dtype and err <= pre.TOL_FAST, \
        f"preprocess 160 x 720 x 1280: max |err| {err} > {pre.TOL_FAST}"
    rows = {"preprocess": {
        "max_abs_err": err, "tol": pre.TOL_FAST,
        "kernel_ms": graph_ms(lambda: pre.preprocess_frames(x, 224, True)),
        "plain_ms": graph_ms(lambda: pre.preprocess_ref(x, 224, True)),
        "library_ms": graph_ms(lambda: library_resize(x, 224)),
        **bound(x.numel() + got.numel() * 2, 0.0, F32_FLOPS),
        "timed": "160 frames 720x1280 uint8 -> 224 bf16 (fast)"}}
    del ref
    cfg = dataclasses.replace(ViTConfig.b32(), attn_impl="fused")
    tower = init_vision_tower(cfg, seed, device=CUDA).eval()
    seen = {}
    hook = tower.block_0.attn.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0]))
    with torch.no_grad():
        tower(got)
    hook.remove()
    heads, hd = cfg.heads, cfg.width // cfg.heads
    with torch.no_grad():
        qkv = tower.block_0.attn.qkv(seen["x"])
    n = qkv.shape[1]
    q, k, v = (z.reshape(b, n, heads, hd).transpose(1, 2)
               for z in qkv.split(cfg.width, dim=-1))
    out = sa.fused_short_attention(q, k, v)
    torch.cuda.synchronize()
    ref = sa.short_attention_ref(q, k, v).float()
    aerr = (out.float() - ref).abs()
    excess = float((aerr - sa.TOL_ABS - sa.TOL_REL * ref.abs()).max())
    assert bool(torch.isfinite(out).all()) and excess <= 0, \
        f"short attention at B 160: max |err| {float(aerr.max())}"
    rows["short_attention"] = {
        "max_abs_err": float(aerr.max()),
        "kernel_ms": graph_ms(lambda: sa.fused_short_attention(q, k, v)),
        "plain_ms": graph_ms(lambda: sa.short_attention_ref(q, k, v)),
        "library_ms": graph_ms(
            lambda: F.scaled_dot_product_attention(q, k, v)),
        **bound(4 * b * heads * n * hd * 2, 4.0 * b * heads * n * n * hd,
                BF16_FLOPS),
        "timed": f"B=160 x {heads} heads, N={n}, hd={hd}, bf16, the first "
                 "block's qkv views"}
    del x, got, tower, qkv, q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows


def phase_tooling(seed: int, card: str) -> dict:
    """The tooling on the card: ``profile_torch_vit.py`` at B = 160 (with
    its attention rows) between a reset and a read of kernels 2 and 5,
    which are then held to their plain versions at its shapes; one sweep
    epoch (``run_torch_parameter_sweep.py``) through the CLI on a
    workload of the reference's size (``sweep_workload``), which launches
    kernel 1; the judge agreement
    (``run_torch_judge_agreement.py``) on that epoch's retrieval results
    with the chat LM on the card from seed weights, which launches kernel
    3a."""
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    res = {}
    # (a) the ViT roofline at B = 160
    mod = load_script("profile_torch_vit")
    pre.reset_counts()
    sa.reset_counts()
    t0 = time.perf_counter()
    prof = mod.main(["--attn", "--seed", str(seed)])
    torch.cuda.synchronize()
    counts = {"preprocess": pre.LAUNCHES["preprocess"],
              "preprocess_plain": pre.REF_CALLS,
              "short_attention": sa.LAUNCHES["short_attention"],
              "short_attention_plain": sa.REF_CALLS}
    # the fused impl's row: a warm-up, 10 timed calls and one more for
    # the drift, 12 layers each
    assert counts["short_attention"] == 12 * 12, counts
    assert counts["preprocess"] >= 12 * 4 + 11 and \
        counts["preprocess_plain"] == counts["short_attention_plain"] == 0, \
        counts
    drift = {r["impl"]: r["max_abs_drift_vs_einsum"]
             for r in prof["attn_impls"]}
    assert drift["fused"] < 2e-2, drift
    res["vit_b160"] = {"wall_s": time.perf_counter() - t0,
                       "launches": counts, "profile": prof,
                       "kernels": vit_b160_kernels(seed)}

    # (b) one sweep epoch through the CLI on the card
    sweep = load_script("run_torch_parameter_sweep")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "block").mkdir()
        (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
        vlm_output, queries = sweep_workload(tmp, seed)
        real_cli = sweep.EpochRunner._cli
        sweep.EpochRunner._cli = counted_cli
        old_path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [str(tmp / "block")] + ([old_path] if old_path else []))
        t0 = time.perf_counter()
        try:
            # the recall profile: its retrieval searches the chunks'
            # vectors (the shipped base config's entity-first retrieval
            # does not), and its kg scores them densely
            sweep.main(["--base-config",
                        str(ROOT / "config/high_recall_config.yaml"),
                        "--vlm-output", str(vlm_output), "--queries", str(queries), "--output-dir",
                        str(tmp / "sweep"), "--epochs", "1", "--seed",
                        str(seed)])
        finally:
            sweep.EpochRunner._cli = real_cli
            if old_path is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = old_path
        wall = time.perf_counter() - t0
        summary = json.loads((tmp / "sweep" / "sweep_summary.json")
                             .read_text())
        epoch = summary["epochs"][0]
        assert epoch["status"] == "ok" and epoch["accuracy"] is not None, \
            {k: v for k, v in epoch.items() if k != "benchmark_stats"}
        stage_counts = [json.loads(p.read_text()) for p in
                        sorted((tmp / "sweep").glob("counts_*.json"))]
        assert len(stage_counts) == 3 and all(c["rc"] == 0
                                              for c in stage_counts)
        topk = {key: sum(c["topk"][key] for c in stage_counts)
                for key in stage_counts[0]["topk"]}
        assert topk["score_topk"] >= SWEEP_QUESTIONS and \
            topk["score_dense"] >= 1 and topk["plain"] == 0, topk
        batches = json.loads((tmp / "sweep" / "epoch_000_batch_metrics.json")
                             .read_text())
        res["sweep_epoch"] = {
            "chunks": SWEEP_CHUNKS, "questions": SWEEP_QUESTIONS,
            "kg_batches": len(batches),
            "wall_s": wall, "epoch_s": epoch["elapsed_s"],
            "stage_s": [c["seconds"] for c in stage_counts],
            "accuracy": epoch["accuracy"], "params": epoch["params"],
            "avg_retrieval_time": epoch["avg_retrieval_time"],
            "topk_launches": topk}

        # (b2) the repro script on that epoch's config: the same statistics
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["bash", str(ROOT / "scripts" / "repro_torch_best_config.sh"),
             str(tmp / "repro"), epoch["config_path"], str(vlm_output),
             str(queries)], capture_output=True, text=True, timeout=900,
            env={**os.environ, "VIDGRAPH_TORCH_DEVICE": "cuda",
                 "PYTHONPATH": os.pathsep.join(
                     [str(tmp / "block")] + ([os.environ["PYTHONPATH"]]
                                             if os.environ.get("PYTHONPATH")
                                             else []))})
        assert proc.returncode == 0, (proc.stdout[-2000:]
                                      + proc.stderr[-2000:])
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("REPRO RESULT:")][-1]
        repro = json.loads(line.split(":", 1)[1])
        assert repro == epoch["benchmark_stats"], \
            (repro, epoch["benchmark_stats"])
        res["repro"] = {"wall_s": time.perf_counter() - t0,
                        "statistics": repro}

        # (c) the judge agreement on that epoch's retrieval results
        cfg = CaptionerConfig.chat()
        ckpt = tmp / "instruct_lm.npz"
        save_params(init_params(cfg, seed, device=CUDA), str(ckpt))
        judge_cfg = chat_config(tmp, "judge_tpu_config.yaml", ckpt)
        agree = load_script("run_torch_judge_agreement")
        fa.reset_counts()
        t0 = time.perf_counter()
        summary = agree.main([
            "--input", str(tmp / "sweep" / "epoch_000_retrieval.json"),
            "--config", str(judge_cfg), "--outdir", str(tmp / "judge")])
        torch.cuda.synchronize()
        flash, plain = fa.LAUNCHES["flash_fwd"], fa.REF_CALLS
        assert summary["n"] == SWEEP_QUESTIONS and \
            json.loads((tmp / "judge" / "judge_agreement.json")
                       .read_text()) == summary, summary
        assert flash >= cfg.layers * summary["n"] and plain == 0, \
            (flash, plain)
        res["judge_agreement"] = {
            "wall_s": time.perf_counter() - t0, "flash_launches": flash,
            **{k: v for k, v in summary.items() if k != "flips"}}
    log(f"phase 21: the tooling on {card}: {json.dumps(res)}")
    return res


def mesh_store_rows(seed: int) -> tuple:
    """Phase 2's 200,000 x 512 store (the same draw) and 16 queries."""
    rng = np.random.default_rng(seed)
    host = rng.normal(size=(STORE_ROWS, DIM)).astype(np.float32)
    queries = rng.normal(size=(16, DIM)).astype(np.float32)
    return host, queries


def filled_store(store, host: np.ndarray):
    step = 50_000
    for i in range(0, len(host), step):
        store.add([f"c{j}" for j in range(i, i + step)], host[i:i + step])
    return store


def hit_ids(hits) -> list:
    return [[rid for rid, _ in row] for row in hits]


def search_ms(store, q: np.ndarray, reps: int = 20) -> float:
    """Host-clock median of a top-5 search whose results end on the
    host."""
    store.search(q, k=5)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        store.search(q, k=5)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def mesh_rank(seed: int) -> dict:
    """One rank of phase 22's gloo world (4 ranks on ``cuda:0``): the
    200,000 x 512 store split 4 ways, the chat decode at ``chat()`` width
    over ``model_axis=2``, ``base()`` blocks over 2 pipeline stages, the
    MoE at the dry-run's sizes.  Rank 0 also runs the one-card
    references."""
    import torch.distributed as dist

    from vidgraph_tpu_torch.core import prng
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig, _block,
                                                     init_params)
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import topk_cosine as tc
    from vidgraph_tpu_torch.parallel import mesh as pm
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.dryrun import RAGGED_PROMPTS
    from vidgraph_tpu_torch.parallel.moe import (init_moe_params, moe_ffn,
                                                 place_experts)
    from vidgraph_tpu_torch.parallel.pipeline import (captioner_block_fn,
                                                      pipeline_forward,
                                                      stack_block_params)
    from vidgraph_tpu_torch.parallel.sharded_search import \
        ShardedEmbeddingStore
    from vidgraph_tpu_torch.services.llm_client import TPUChatClient

    sys.modules["tiktoken"] = None
    assert dist.get_backend() == "gloo"
    lead = dist.get_rank() == 0
    out = {"rank": dist.get_rank(), "device": str(torch.cuda.current_device())}
    # (a) the store, 4 shards of 65,536 rows
    host, queries = mesh_store_rows(seed)
    mesh = pm.build_mesh(model_axis=1)
    sharded = filled_store(ShardedEmbeddingStore(mesh, dim=DIM,
                                                 capacity=STORE_ROWS), host)
    assert sharded._device_store().device.type == "cuda"
    sharded.search(queries[:1], k=5)
    torch.cuda.synchronize()
    tc.reset_counts()
    got = {b: hit_ids(sharded.search(queries[:b], k=5)) for b in (1, 16)}
    torch.cuda.synchronize()
    out["store_counts"] = {**tc.LAUNCHES, "plain": tc.REF_CALLS}
    out["store_ms"] = {f"b{b}": search_ms(sharded, queries[:b])
                       for b in (1, 16)}
    out["shard_rows"] = sharded.shard_rows()
    if lead:
        plain = filled_store(EmbeddingStore(dim=DIM, capacity=STORE_ROWS),
                             host)
        out["store_equal"] = all(
            hit_ids(plain.search(queries[:b], k=5)) == got[b]
            for b in (1, 16))
        del plain
    del sharded, host
    torch.cuda.empty_cache()
    # (b) the chat decode at chat() width over model_axis=2
    cfg = CaptionerConfig.chat()
    params = init_params(cfg, seed, device=torch.device("cuda:0"))
    serving.configure(enabled=True, model_axis=2)
    client = TPUChatClient(cfg=cfg, params=params, max_new=16, max_batch=4)
    assert pm.axis_size(client._mesh, "model") == 2
    assert client.params["blocks"][0]["qkv_w"].shape[1] == 3 * cfg.width // 2
    fa.reset_counts()
    t0 = time.perf_counter()
    texts, rows = chat_rows(client, RAGGED_PROMPTS, 16)
    torch.cuda.synchronize()
    out["chat_ms"] = (time.perf_counter() - t0) * 1e3
    out["chat_counts"] = {"flash": fa.LAUNCHES["flash_fwd"],
                          "plain": fa.REF_CALLS}
    serving.configure(enabled=False)
    if lead:
        one = TPUChatClient(cfg=cfg, params=params, max_new=16, max_batch=4)
        one_texts, one_rows = chat_rows(one, RAGGED_PROMPTS, 16)
        out["chat_equal"] = one_texts == texts
        out["chat_ties"] = [
            {"row": r, **gap} for r, prompt in enumerate(RAGGED_PROMPTS)
            if (gap := chat_gap(one, prompt, 16, one_rows[r], rows[r]))]
    out["chat_texts"] = texts
    del client, params
    torch.cuda.empty_cache()
    # (c) base() blocks over 2 pipeline stages, B 8, T 128, bf16
    base = CaptionerConfig.base()
    bp = init_params(base, seed + 1, device=torch.device("cuda:0"))
    x = prng.normal(prng.PRNGKey(seed + 2), (8, 128, base.width),
                    device=torch.device("cuda:0"))
    idx = torch.arange(128, device="cuda")
    mask = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    pipe = pm.mesh_of(torch.arange(MESH_RANKS).reshape(-1, 2),
                      ("rep", "pipe"))
    with torch.no_grad():
        ref = x
        for blk in bp["blocks"]:
            ref = _block(blk, base, ref, mask=mask)[0]
        t0 = time.perf_counter()
        got = pipeline_forward(captioner_block_fn(base, mask),
                               stack_block_params(bp["blocks"]), x, pipe,
                               n_microbatches=4)
        torch.cuda.synchronize()
        out["pipeline_ms"] = (time.perf_counter() - t0) * 1e3
    out["pipeline_err"] = float((got - ref).abs().max())
    del bp, x, ref, got
    # (d) the MoE at the dry-run's sizes, 4 experts over 4 ranks
    ep = pm.mesh_of(torch.arange(MESH_RANKS).reshape(1, -1),
                    ("rep", "expert"))
    moe = init_moe_params(prng.PRNGKey(seed), 32, 64, MESH_RANKS,
                          device=torch.device("cuda:0"))
    xe = prng.normal(prng.PRNGKey(seed + 3), (2, 8, 32),
                     device=torch.device("cuda:0"))
    with torch.no_grad():
        whole = moe_ffn(moe, xe)
        with pm.use_mesh(ep):
            split = moe_ffn(place_experts(moe, ep), xe)
    out["moe_err"] = float((split - whole).abs().max())
    return out


def phase_mesh(tc, seed: int, card: str) -> dict:
    """Phase 22: the multi-device layer on the one card."""
    import torch.distributed as dist

    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig, \
        init_params
    from vidgraph_tpu_torch.models.tokenizer import batch_encode
    from vidgraph_tpu_torch.models.train import TrainState
    from vidgraph_tpu_torch.models.vit import ViTConfig
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.parallel import mesh as pm
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    res = {}
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    # ---- (1) NCCL, a world of one, mesh.enabled: true --------------------
    serving.configure(enabled=True, model_axis=1)
    mesh = serving.serving_mesh()
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1, \
        (dist.get_backend(), dist.get_world_size())
    assert tuple(mesh.shape) == (1, 1)
    host, queries = mesh_store_rows(seed)
    sharded = filled_store(serving.make_embedding_store(
        dim=DIM, capacity=STORE_ROWS), host)
    assert type(sharded).__name__ == "ShardedEmbeddingStore"
    plain = filled_store(EmbeddingStore(dim=DIM, capacity=STORE_ROWS), host)
    want = {b: hit_ids(plain.search(queries[:b], k=5)) for b in (1, 16)}
    torch.cuda.synchronize()
    tc.reset_counts()
    got = {b: hit_ids(sharded.search(queries[:b], k=5)) for b in (1, 16)}
    torch.cuda.synchronize()
    counts = launch_counts(tc)
    assert got == want, "world-1 sharded search differs from one card"
    assert counts["score_topk"] >= 2 and counts["select"] == 0 and \
        counts["plain"] == 0, counts
    res["store"] = {"launches": counts, "ms": {
        f"b{b}": {"sharded": search_ms(sharded, queries[:b]),
                  "one_card": search_ms(plain, queries[:b])}
        for b in (1, 16)}}
    del sharded, plain, host
    torch.cuda.empty_cache()
    # hybrid retrieval on bench.py's graph: through the mesh and on one card
    tc.reset_counts()
    mesh_run = bench_retrieval("cuda")
    torch.cuda.synchronize()
    counts = launch_counts(tc)
    assert counts["score_topk"] >= len(mesh_run["queries"]) and \
        counts["plain"] == 0, counts
    serving.configure(enabled=False)
    one_run = bench_retrieval("cuda")
    assert mesh_run["texts"] == one_run["texts"], \
        "mesh-routed retrieval differs from one card"
    res["retrieval"] = {"launches": counts, "p50_ms": mesh_run["p50_ms"],
                        "one_card_p50_ms": one_run["p50_ms"]}
    # the chat LM at chat() width, 64 new bytes, one dispatch
    cfg = CaptionerConfig.chat()
    params = init_params(cfg, seed, device=CUDA)
    one = chat_texts(cfg, params, enabled=False)
    fa.reset_counts()
    on_mesh = chat_texts(cfg, params, enabled=True)
    torch.cuda.synchronize()
    flash = {"flash": fa.LAUNCHES["flash_fwd"], "plain": fa.REF_CALLS}
    assert on_mesh == one, "world-1 mesh chat decode differs from one card"
    assert flash == {"flash": cfg.layers, "plain": 0}, flash
    res["chat"] = {"launches": flash, "bytes": [len(t) for t in on_mesh]}
    del params
    torch.cuda.empty_cache()
    # TrainState at ViT-B/32 + base(): one step over the mesh and without
    rng = np.random.default_rng(seed + 22)
    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    tokens = batch_encode(["The scene shows a red object on a dark "
                           "background."] * 8, 96)
    losses = {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        state = TrainState.create(
            ViTConfig.b32(), CaptionerConfig.base(), torch.device("cuda"),
            learning_rate=3e-4, seed=seed, mesh=m)
        losses[name] = state.step(*state.shard_batch(images, tokens))[1]
        del state
        torch.cuda.empty_cache()
    assert abs(losses["mesh"] - losses["one_device"]) < 1e-5, losses
    res["train_state"] = losses
    serving.configure(enabled="auto", model_axis=1)
    pm.shutdown()
    # ---- (2) gloo, 4 ranks, each computing on cuda:0 ---------------------
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:mesh_rank", MESH_RANKS, (seed,),
                      backend="gloo", device="cuda:0", timeout_s=300.0,
                      deadline_s=600.0, threads=2)
    wall = time.perf_counter() - t0
    lead = ranks[0]
    assert lead["store_equal"], lead["store_equal"]
    # the tensor-parallel decode sums each block's products in two halves:
    # a byte may differ from one card's only at a near-tie
    for tie in lead["chat_ties"]:
        assert_near_tie(f"phase 22: chat row {tie['row']} over "
                        f"model_axis=2 and one card", tie)
    assert lead["chat_equal"] or lead["chat_ties"], lead["chat_texts"]
    for r in ranks:
        c = r["store_counts"]
        assert c["score_topk"] >= 2 and c["select"] == 0 and \
            c["plain"] == 0, (r["rank"], c)
        assert r["chat_counts"]["flash"] == cfg.layers and \
            r["chat_counts"]["plain"] == 0, (r["rank"], r["chat_counts"])
        assert r["chat_texts"] == lead["chat_texts"]
        assert r["pipeline_err"] < PIPE_TOL, (r["rank"], r["pipeline_err"])
        assert r["moe_err"] < 1e-5, (r["rank"], r["moe_err"])
    res["gloo_4_ranks_on_one_card"] = {
        "note": "one card, not a multi-card number",
        "wall_s": wall, "shard_rows": lead["shard_rows"],
        "store_launches": [r["store_counts"] for r in ranks],
        "store_ms": [r["store_ms"] for r in ranks],
        "chat_launches": [r["chat_counts"] for r in ranks],
        "chat_ms": [r["chat_ms"] for r in ranks],
        "pipeline_ms": [r["pipeline_ms"] for r in ranks],
        "pipeline_err": max(r["pipeline_err"] for r in ranks),
        "moe_err": max(r["moe_err"] for r in ranks)}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 22: the multi-device layer on {card} (NCCL world 1; gloo "
        f"{MESH_RANKS} ranks on one card, not a multi-card number): "
        f"{json.dumps(res)}")
    return res


def chat_rows(client, prompts, max_tokens: int) -> tuple:
    """``complete_batch_sync``'s texts for ``prompts``, and the token rows
    its decode emitted (``generate_from_tokens`` recorded)."""
    from vidgraph_tpu_torch.models import captioner

    real, seen = captioner.generate_from_tokens, []

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(out.cpu().numpy())
        return out

    captioner.generate_from_tokens = recording
    try:
        texts = client.complete_batch_sync(prompts, max_tokens=max_tokens)
    finally:
        captioner.generate_from_tokens = real
    return texts, seen[-1][:len(prompts)]


def chat_gap(client, prompt: str, max_tokens: int, a: np.ndarray,
             b: np.ndarray):
    """None where the token rows ``a`` (``client``'s own for ``prompt``)
    and ``b`` are equal; else the first step where they differ and the gap
    there between the two bytes' logits of ``a``'s context, teacher-forced
    through ``prefill_logits`` (``caption_gap``'s record)."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import prefill_logits

    diff = np.nonzero(a != b)[0]
    if not len(diff):
        return None
    s = int(diff[0])
    cfg = client.cfg
    cap = cfg.max_len - cfg.num_vision_tokens - \
        client._decode_budget(max_tokens)
    ids = tokenizer.encode(client._fit_prompt(prompt), add_bos=True,
                           add_eos=False)[:min(cap,
                                               client.max_prompt_bytes + 1)]
    ctx = torch.tensor([list(ids) + [int(t) for t in a[:s]]],
                       device=client.device)
    with torch.no_grad():
        logits, _ = prefill_logits(client._serve_params, cfg, ctx, 1)
    row = logits[0, cfg.num_vision_tokens + ctx.shape[1] - 1]
    top2 = torch.topk(row, 2).values
    return {"first_differing_step": s, "ref_byte": int(a[s]),
            "got_byte": int(b[s]),
            "logit_gap": float(row[int(a[s])] - row[int(b[s])]),
            "top2_gap": float(top2[0] - top2[1])}


def chat_texts(cfg, params, enabled: bool) -> list:
    """One dispatch of ``RAGGED_PROMPTS`` through ``TPUChatClient``, 64 new
    bytes, with the serving mesh on (a world of one) or off."""
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.dryrun import RAGGED_PROMPTS
    from vidgraph_tpu_torch.services.llm_client import TPUChatClient

    serving.configure(enabled=enabled, model_axis=1)
    client = TPUChatClient(cfg=cfg, params=params, max_new=64, max_batch=4)
    assert (client._mesh is not None) == enabled
    return client.complete_batch_sync(RAGGED_PROMPTS, max_tokens=64)


# ----------------------------------------------------------------- phase 23
LEADER_RANKS = 4
LEADER_STREAMS = 4
# phase 23's captions are 32 new bytes, not the client's 256: four gloo
# ranks share the card and stage each of a decode step's 16 all-reduces
# over "model" through the host, ~9 ms each in phase 22, so 256
# bytes would take ~37 s a batch
LEADER_NEW_BYTES = 32
LEADER_PACED_SECONDS = 2.0
# a server stream grown past the first of its memory's two data shards
# (capacity 1024, 512 rows a shard): its queries launch kernel 1 on every
# rank, where the other memories' rows all lie in the first shard
LEADER_LONG_ROWS = 520
# the broadcast timed alone: an 8-stream step, 8 chunks of 5 frames
LEADER_STEP_CHUNKS = 8


def record_captions(vlm) -> list:
    """``vlm.caption_batch_sync`` wrapped to keep each batch's tokens
    (numpy) and vision prefixes; returns the list they go to."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import generate
    from vidgraph_tpu_torch.parallel.serving import maybe_mesh

    batches = []

    def caption_batch_sync(chunks):
        emb = vlm.embed_frames(vlm.host_frames(chunks))
        vis = vlm.vision_prefixes(chunks, emb)
        with maybe_mesh(vlm._mesh):
            toks = generate(vlm._serve_params, vlm.cap_cfg, vis,
                            max_new=vlm.max_new).cpu().numpy()
        batches.append({"tokens": toks, "vis": vis})
        return [tokenizer.decode(t) for t in toks]
    vlm.caption_batch_sync = caption_batch_sync
    return batches


def leader_clients(mod):
    """Phase 17's clients (``backend.vlm: tpu``, ViT-B/32 + ``base()``
    from seed 0; the hash embed client) under the serving policy as it is
    configured, captions cut to ``LEADER_NEW_BYTES``; and the list of
    their caption batches."""
    vlm, embed = mod.serving_clients()
    vlm.max_new = LEADER_NEW_BYTES
    return vlm, embed, record_captions(vlm)


def leader_stream(mod, vlm, embed, banks, seed: int, channel,
                  seconds: float, realtime: bool):
    """``mod.run`` of a ``RankedEngine`` over ``len(banks)`` streams:
    rank 0 leads a session and returns (engine, summary); a follower
    follows it and returns (engine, None)."""
    from vidgraph_tpu_torch.parallel.leader import (RankedEngine,
                                                    follow_stream, session)

    if channel.leader:
        with session(channel):
            return mod.run(len(banks), vlm, embed, seconds,
                           realtime=realtime, seed=seed, banks=banks,
                           engine_cls=RankedEngine, channel=channel)
    engine = mod.make_engine(len(banks), vlm, embed,
                             engine_cls=RankedEngine, channel=channel)
    asyncio.run(follow_stream(engine))
    return engine, None


def leader_serve(channel, cfg, reqs):
    """``reqs`` through a ``RankedServer``: rank 0 serves them over HTTP
    and returns the responses; a follower follows and returns None."""
    from vidgraph_tpu_torch.parallel.leader import (RankedServer,
                                                    follow_server)

    server = RankedServer(cfg, port=0, channel=channel)
    if channel.leader:
        return http_session(server, reqs)
    asyncio.run(follow_server(server))
    return None


def held(engine) -> dict:
    """Each stream's captions and memory ids."""
    return {"captions": {sid: {cid: c["content"] for cid, c in caps.items()}
                         for sid, caps in engine.captions.items()},
            "memory": {sid: m.ids() for sid, m in engine.memories.items()}}


def stream_launches(tc) -> dict:
    counts = {**vision_counts(),
              **{f"cosine_{k}": v for k, v in tc.LAUNCHES.items()}}
    counts["plain"] += tc.REF_CALLS
    return counts


TABLE_KEYS = ("chunks_done", "queries_served", "total_shed_chunks",
              "total_dropped_frames", "batches")


def leader_table(out: dict, engine) -> dict:
    """A stream run's numbers that must not move between worlds, its
    timings, and its answers' hits (stream, query, chunks)."""
    return {"table": {k: out[k] for k in TABLE_KEYS},
            "timings": {k: out[k] for k in (
                "query_under_load_p50_ms", "query_under_load_p95_ms",
                "query_p50_ms", "query_p95_ms", "chunk_latency_p50_ms",
                "wall_seconds", "realtime_factor")},
            "answers": [(a["stream"], a["query"], a["chunks"])
                        for a in engine.answers]}


def step_broadcast_ms(channel, banks, reps: int = 5) -> dict:
    """An 8-stream step's frames (``LEADER_STEP_CHUNKS`` chunks of 5
    frames of 240 x 320) sent by ``ControlChannel.send`` and received by
    ``recv`` on every follower, as a heartbeat (no step runs): the median
    ms of ``reps`` after one, on each rank."""
    from vidgraph_tpu_torch.parallel.leader import HEARTBEAT

    offsets = np.linspace(0, 29, 5).astype(int)
    frames = [np.ascontiguousarray(banks[i % len(banks)][offsets])
              for i in range(LEADER_STEP_CHUNKS)]
    times = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        if channel.leader:
            channel.send(HEARTBEAT, {}, frames)
        else:
            _, _, got = channel.recv()
            assert len(got) == LEADER_STEP_CHUNKS
        times.append((time.perf_counter() - t) * 1e3)
    return {"bytes": sum(f.nbytes for f in frames),
            "ms": statistics.median(times[1:])}


def leader_rank(seed: int, graph_dir: str) -> dict:
    """One rank of phase 23's gloo world (4 ranks on ``cuda:0``, a (2
    data, 2 model) serving mesh): a first call, the 4-stream run, the
    paced run, the server session, each led by rank 0 on a control
    channel of its own; then a step's broadcast timed alone."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.ops import topk_cosine as tc
    from vidgraph_tpu_torch.parallel import mesh as pm
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.leader import ControlChannel

    sys.modules["tiktoken"] = None
    serving.configure(enabled=True, model_axis=2)
    mod = load_script("measure_torch_stream_scaling")
    vlm, embed, batches = leader_clients(mod)
    shape = {a: pm.axis_size(vlm._mesh, a) for a in ("data", "model")}
    assert shape == {"data": 2, "model": 2}, shape
    banks = [mod.frame_bank(i, seed) for i in range(LEADER_STREAMS)]
    out = {"mesh": shape}
    t = time.perf_counter()
    leader_stream(mod, vlm, embed, banks, seed, ControlChannel(), 1.0,
                  False)                                    # first calls
    out["first_call_s"] = time.perf_counter() - t
    batches.clear()
    torch.cuda.synchronize()
    reset_vision_counts()
    tc.reset_counts()
    channel = ControlChannel()
    out["rank"], lead = channel.rank, channel.leader
    engine, summary = leader_stream(mod, vlm, embed, banks, seed, channel,
                                    STREAM_SECONDS, False)
    torch.cuda.synchronize()
    out.update(stream_counts=stream_launches(tc), stream=held(engine),
               stream_channel=channel.summary(),
               batch_sizes=engine.batch_sizes)
    if lead:
        out.update(leader_table(summary, engine),
                   tokens=[b["tokens"] for b in batches])
    channel = ControlChannel()
    engine, summary = leader_stream(mod, vlm, embed, banks, seed, channel,
                                    LEADER_PACED_SECONDS, True)
    out["paced"] = {"held": held(engine), "channel": channel.summary(),
                    **(leader_table(summary, engine) if lead else {})}
    cfg = PipelineConfig()
    cfg.graph_store.persist_dir = graph_dir
    tc.reset_counts()
    channel = ControlChannel()
    t = time.perf_counter()
    session = leader_serve(channel, cfg, serve_requests(seed,
                                                        LEADER_LONG_ROWS))
    out.update(serve_s=time.perf_counter() - t,
               serve_counts=launch_counts(tc),
               serve_channel=channel.summary(),
               **({"session": session} if lead else {}))
    out["step_broadcast"] = step_broadcast_ms(channel, banks)
    return out


def caption_ties(where: str, ref_vlm, ref_batches, got_tokens) -> list:
    """Every caption row of ``got_tokens`` (a run's batches) against the
    one-card reference's batches: equal, or a near-tie of the reference's
    logits (printed, asserted under ``CAPTION_TIE_TOL``)."""
    assert len(got_tokens) == len(ref_batches), \
        (where, len(got_tokens), len(ref_batches))
    ties = []
    for k, (ref, got) in enumerate(zip(ref_batches, got_tokens)):
        assert got.shape == ref["tokens"].shape, (where, k, got.shape)
        for i in range(len(got)):
            gap = caption_gap(ref_vlm, ref["vis"][i], ref["tokens"][i],
                              got[i])
            if gap is not None:
                assert_near_tie(f"{where}: batch {k} row {i} and one card",
                                gap)
                ties.append({"batch": k, "row": i, **gap})
    return ties


def same_answers(got: list, ref: list) -> bool:
    """Query answers equal: stream, query and hits (``same_hits``)."""
    return len(got) == len(ref) and all(
        gs == rs and gq == rq and same_hits(gh, rh)
        for (gs, gq, gh), (rs, rq, rh) in zip(got, ref))


def check_stream_launches(where: str, counts: dict, batches: int,
                          layers: int, topk: bool = True) -> None:
    """Kernel 2 at least once a caption batch, 3a once a layer a batch,
    kernel 1 for the queries (``topk``), no plain version."""
    assert counts["preprocess"] >= batches, (where, counts)
    assert counts["flash"] == layers * batches, (where, counts)
    assert not topk or counts["cosine_score_topk"] > 0, (where, counts)
    assert counts["cosine_select"] == 0, (where, counts)
    assert counts["plain"] == 0, f"{where}: a plain version served {counts}"


def phase_leader(tc, seed: int, card: str) -> dict:
    """Phase 23: ``stream`` and ``serve`` under the rank-0 leader on the
    one card, against one card's engine and server."""
    import torch.distributed as dist

    from vidgraph_tpu_torch.parallel import mesh as pm
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.launch import run_ranks
    from vidgraph_tpu_torch.parallel.leader import ControlChannel
    from vidgraph_tpu_torch.services.server import VideoMemoryServer

    t_phase = time.perf_counter()
    mod = load_script("measure_torch_stream_scaling")
    banks = [mod.frame_bank(i, seed) for i in range(LEADER_STREAMS)]
    reqs = serve_requests(seed, LEADER_LONG_ROWS)
    res = {"new_bytes": LEADER_NEW_BYTES, "requests": len(reqs)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- one card: phase 17's engine, phase 18's server (+ cam_long)
        serving.configure(enabled=False)
        cfg = bench_graph_config(tmp)
        ref_vlm, embed, ref_batches = leader_clients(mod)
        mod.run(LEADER_STREAMS, ref_vlm, embed, 1.0, realtime=False,
                seed=seed, with_queries=False, banks=banks)  # first calls
        ref_batches.clear()
        ref_engine, ref_out = mod.run(LEADER_STREAMS, ref_vlm, embed,
                                      STREAM_SECONDS, realtime=False,
                                      seed=seed, banks=banks)
        ref = {**leader_table(ref_out, ref_engine), **held(ref_engine)}
        ref_session = http_session(VideoMemoryServer(cfg, port=0), reqs)
        # ---- (1) NCCL, a world of one, mesh.enabled: true ---------------
        serving.configure(enabled=True, model_axis=1)
        serving.serving_mesh()
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        vlm, embed1, batches = leader_clients(mod)
        assert vlm._mesh is not None
        leader_stream(mod, vlm, embed1, banks, seed, ControlChannel(), 1.0,
                      False)                                # first calls
        batches.clear()
        torch.cuda.synchronize()
        reset_vision_counts()
        tc.reset_counts()
        channel = ControlChannel()
        engine, out = leader_stream(mod, vlm, embed1, banks, seed, channel,
                                    STREAM_SECONDS, False)
        torch.cuda.synchronize()
        counts = stream_launches(tc)
        one = {**leader_table(out, engine), **held(engine)}
        n_batches = one["table"]["batches"]
        check_stream_launches("phase 23 (1)", counts, n_batches,
                              vlm.cap_cfg.layers)
        assert one["table"] == ref["table"], (one["table"], ref["table"])
        ties = caption_ties("phase 23 (1)", ref_vlm, ref_batches,
                            [b["tokens"] for b in batches])
        assert ties or (one["captions"] == ref["captions"]
                        and same_answers(one["answers"], ref["answers"]))
        assert one["memory"] == ref["memory"]
        tc.reset_counts()
        server_channel = ControlChannel()
        session1 = leader_serve(server_channel, cfg, reqs)
        serve_counts = launch_counts(tc)
        diffs = session_diffs(reqs, session1, ref_session)
        assert not diffs, f"the ranked server differs from one card: {diffs}"
        assert serve_counts["score_topk"] >= SERVE_QUERIES and \
            serve_counts["plain"] == 0, serve_counts
        res["nccl_world_1"] = {
            "launches": counts, "serve_launches": serve_counts,
            "table": one["table"], "timings": one["timings"],
            "one_card_timings": ref["timings"], "ties": ties,
            "channel": channel.summary(),
            "serve_channel": server_channel.summary(),
            "request_p50_ms": route_p50(reqs, session1),
            "one_card_request_p50_ms": route_p50(reqs, ref_session)}
        log(f"phase 23 (1): NCCL world 1 on {card}: {json.dumps(res)}")
        serving.configure(enabled="auto", model_axis=1)
        pm.shutdown()
        # ---- (2) gloo, 4 ranks on cuda:0, (2 data, 2 model) ---------------
        t0 = time.perf_counter()
        ranks = run_ranks("chip_smoke:leader_rank", LEADER_RANKS,
                          (seed, cfg.graph_store.persist_dir),
                          backend="gloo", device="cuda:0", timeout_s=300.0,
                          deadline_s=600.0, threads=2)
        wall = time.perf_counter() - t0
    lead = ranks[0]
    assert lead["rank"] == 0
    assert lead["table"] == one["table"], (lead["table"], one["table"])
    gloo_ties = caption_ties("phase 23 (2)", ref_vlm, ref_batches,
                             lead["tokens"])
    assert gloo_ties or (lead["stream"]["captions"] == one["captions"]
                         and same_answers(lead["answers"], one["answers"]))
    assert lead["stream"]["memory"] == one["memory"]
    diffs = session_diffs(reqs, lead["session"], session1)
    assert not diffs, f"the 4-rank server differs from world 1's: {diffs}"
    assert lead["paced"]["table"]["chunks_done"] > 0, lead["paced"]
    for r in ranks:
        # every follower ran every step: what the leader holds, it holds
        assert r["stream"] == lead["stream"], r["rank"]
        assert r["paced"]["held"] == lead["paced"]["held"], r["rank"]
        check_stream_launches(f"phase 23 (2) rank {r['rank']}",
                              r["stream_counts"], n_batches,
                              vlm.cap_cfg.layers, topk=False)
        c = r["serve_counts"]
        assert c["score_topk"] > 0 and c["plain"] == 0, (r["rank"], c)
    res["gloo_4_ranks_on_one_card"] = {
        "note": "one card, not a multi-card number", "wall_s": wall,
        "table": lead["table"], "timings": lead["timings"],
        "paced": {k: lead["paced"][k] for k in ("table", "timings")},
        "ties": gloo_ties, "first_call_s": lead["first_call_s"],
        "stream_launches": [r["stream_counts"] for r in ranks],
        "serve_launches": [r["serve_counts"] for r in ranks],
        "stream_channel": [r["stream_channel"] for r in ranks],
        "paced_channel": [r["paced"]["channel"] for r in ranks],
        "serve_channel": [r["serve_channel"] for r in ranks],
        "serve_s": lead["serve_s"],
        "request_p50_ms": route_p50(reqs, lead["session"]),
        "step_broadcast": [r["step_broadcast"] for r in ranks]}
    res["launches"] = {
        "preprocess": counts["preprocess"] + sum(
            r["stream_counts"]["preprocess"] for r in ranks),
        "flash": counts["flash"] + sum(r["stream_counts"]["flash"]
                                       for r in ranks),
        **{k: counts[f"cosine_{k}"] + serve_counts[k] + sum(
            r["stream_counts"][f"cosine_{k}"] + r["serve_counts"][k]
            for r in ranks) for k in ("score_topk", "select")}}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 23: stream and serve under the rank-0 leader on {card} "
        f"(NCCL world 1; gloo {LEADER_RANKS} ranks on one card, not a "
        f"multi-card number): {json.dumps(res)}")
    return res


def route_p50(reqs, session) -> dict:
    """Median request ms by route."""
    by_route = {}
    for (_, path, _), (_, _, ms) in zip(reqs, session):
        by_route.setdefault(path, []).append(ms)
    return {path: statistics.median(v) for path, v in by_route.items()}


# ----------------------------------------------------------------- phase 24
# phase 24: draws on the card against the JAX package's on the CPU (the
# fixture's): normals and tree leaves within this many ulp
SEEDED_ULP = 2
SEEDED_CHUNKS = 3


def ulp_gaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 distance in units in the last place (ordered int view)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def f32_b64(text: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(text), np.float32)


def check_normals(name: str, got: torch.Tensor, want: np.ndarray) -> dict:
    got = got.cpu().numpy()
    gaps = ulp_gaps(got, want)
    res = {"n": int(got.size), "max_ulp": int(gaps.max()),
           "bit_equal_share": float(np.mean(got == want))}
    assert got.shape == want.shape and res["max_ulp"] <= SEEDED_ULP, \
        f"{name} on the card vs JAX: {res}"
    return res


def check_leaf(key: str, leaf: torch.Tensor, want: dict) -> bool:
    """One leaf against the fixture: shape, float64 sum and sum of squares
    (within what moving each value by ``SEEDED_ULP`` could change), the
    first 16 values within ``SEEDED_ULP``; True when its bytes hash the
    same (bit-equal)."""
    a = leaf.detach().float()
    assert list(a.shape) == want["shape"], (key, a.shape, want["shape"])
    flat = a.reshape(-1).double()
    total, sq = float(flat.sum()), float((flat * flat).sum())
    n = flat.numel()
    rel = SEEDED_ULP * 2.0 ** -23
    assert abs(total - want["sum"]) <= rel * math.sqrt(n * want["sumsq"]) \
        + 1e-9, (key, total, want["sum"])
    assert abs(sq - want["sumsq"]) <= 2 * rel * want["sumsq"] + 1e-12, \
        (key, sq, want["sumsq"])
    head = a.reshape(-1)[:len(want["head"])].cpu().numpy()
    assert int(ulp_gaps(head, np.asarray(want["head"], np.float32))
               .max(initial=0)) <= SEEDED_ULP, (key, head, want["head"])
    data = a.cpu().numpy().tobytes()
    return hashlib.sha1(data).hexdigest() == want["sha1"]


def seeded_trees(seed: int) -> dict:
    """ViT-B/32 and ``CaptionerConfig.base()`` drawn on the card from
    ``seed``, as the fixture's keys (``vit/...``, ``cap/...``) -> leaf."""
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import tree_leaves
    from vidgraph_tpu_torch.models.vit import ViTConfig, init_vision_tower

    tower = init_vision_tower(ViTConfig.b32(), seed, device=CUDA)
    cap = init_params(CaptionerConfig.base(), seed, device=CUDA)
    leaves = {"vit/" + k.replace(".", "/"): v
              for k, v in tower.state_dict().items()}
    leaves.update({"cap/" + k: v for k, v in tree_leaves(cap)})
    return leaves


def host_randn_ms(shapes) -> float:
    """The draw the port made before it drew JAX's stream: ``torch.randn``
    on the host, each leaf then moved to the card (a yardstick only;
    nothing in the port draws so now)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for shape in shapes:
        torch.randn(shape).to(CUDA)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def seeded_vlm_cli(tmp: Path) -> dict:
    """The CLI's ``vlm`` at the shipped config (``backend.vlm: tpu``, no
    checkpoint: weights from seed 0) on ``synthetic_chunks``' frames,
    between a reset and a read of the launch counts."""
    from vidgraph_tpu_torch.cli.main import main as cli_main
    from vidgraph_tpu_torch.pipeline import vlm_extractor

    vlm_extractor.iter_chunk_frames = (
        lambda path, secs, per_chunk, *a: synthetic_chunks(
            SEEDED_CHUNKS, per_chunk, secs))
    vlm_extractor.count_chunks = lambda path, secs: SEEDED_CHUNKS
    reset_vision_counts()
    t0 = time.perf_counter()
    rc = cli_main(["vlm", "--config", str(ROOT / "config/base_config.yaml"),
                   "--video", "synthetic_405x720.mp4", "--output",
                   str(tmp / "vlm_seeded.json")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = vision_counts()
    assert rc == 0, f"the seeded vlm exited {rc}"
    data = json.loads((tmp / "vlm_seeded.json").read_text())
    assert data["metadata"]["config"]["backend"]["vlm"] == "tpu"
    assert not data["metadata"]["config"]["vlm"].get("checkpoint_path")
    texts = [r["content"] for r in data["results"]]
    assert len(texts) == SEEDED_CHUNKS and all(
        isinstance(t, str) for t in texts)
    layers = 8
    assert counts["preprocess"] >= SEEDED_CHUNKS, counts
    assert counts["flash"] >= layers * SEEDED_CHUNKS, counts
    assert counts["plain"] == 0, counts
    return {"counts": counts, "wall_s": wall, "texts": texts}


def caption_agreement(ref: dict, texts: list) -> dict:
    """The card's seeded captions against the JAX package's on the CPU
    (the fixture's): equal rows, and for each other row the logit gap at
    its first differing byte, from a client built as the CLI builds it.
    Reported, not gated: with random weights near-ties are common, and the
    card's bf16 products round otherwise than the CPU's."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm = TPUVLMClient(seed=0, max_new=ref["max_new"])
    chunks = [c for _, _, c in synthetic_chunks(
        ref["chunks"], ref["frames_per_chunk"], 5.0)]
    rows = []
    for i, (chunk, want) in enumerate(zip(chunks, ref["rows"])):
        toks, vis = caption_tokens(vlm, [chunk])
        own = toks[0].cpu().numpy().astype(np.int64)
        jax_toks = np.asarray(want["tokens"], np.int64)
        gap = caption_gap(vlm, vis[0], own, jax_toks)
        if gap is not None:  # caption_gap's ref is the card's, got JAX's
            gap["card_byte"] = gap.pop("ref_byte")
            gap["jax_byte"] = gap.pop("got_byte")
        rows.append({"chunk": i, "equal_tokens": gap is None,
                     "cli_text_is_own": tokenizer.decode(own) == texts[i],
                     "text_equal_to_jax": texts[i] == want["text"],
                     "gap": gap})
    equal = sum(r["equal_tokens"] for r in rows)
    return {"rows": rows, "equal_rows": equal,
            "equal_share": equal / len(rows), "gated": False}


def phase_seeded(seed: int, card: str) -> dict:
    """Phase 24: JAX's seeded draws on the card (``core/prng.py``) against
    the JAX package's on the CPU (``tests/torch_jax_draws.json``), then the
    seeded ``vlm`` with its captions beside JAX's."""
    from vidgraph_tpu_torch.core import prng

    ref = jax_draws()
    draws = ref["draws"]
    key = prng.PRNGKey(draws["seed"])
    bits = prng.bits(key, (len(draws["bits"]),), device=CUDA).cpu().numpy()
    assert np.array_equal(bits, np.asarray(draws["bits"], np.int64)), \
        "threefry bits on the card differ from JAX's"
    bern = prng.bernoulli(key, 0.5, (draws["bernoulli_n"],), device=CUDA)
    assert np.packbits(bern.cpu().numpy()).tobytes().hex() == \
        draws["bernoulli_packed"], "bernoulli on the card differs from JAX's"
    want_n = f32_b64(draws["normal_f32"])
    want_t = f32_b64(draws["truncated_f32"])
    res = {"bits_equal": True, "bernoulli_equal": True,
           "normal": check_normals("normal", prng.normal(
               prng.PRNGKey(draws["normal_seed"]), want_n.shape,
               device=CUDA), want_n),
           "truncated_normal": check_normals(
               "truncated_normal", prng.truncated_normal(
                   prng.PRNGKey(draws["truncated_seed"]),
                   *draws["truncated_bounds"], want_t.shape, device=CUDA),
               want_t)}

    # the seed-0 trees of the shipped vlm: drawn on the card, cold, then
    # again warm, and the host torch.randn draw they replace
    want = ref["trees"]["leaves"]
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        leaves = seeded_trees(ref["trees"]["seed"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    assert set(leaves) == set(want), sorted(set(leaves) ^ set(want))
    bit_equal = sum(check_leaf(k, v, want[k]) for k, v in leaves.items())
    n_values = sum(v.numel() for v in leaves.values())
    shapes = [tuple(v.shape) for v in leaves.values()]
    del leaves
    torch.cuda.empty_cache()
    res["trees"] = {"leaves": len(want), "values": n_values,
                    "bit_equal_leaves": bit_equal,
                    "draw_ms_cold": times[0], "draw_ms_warm": times[1],
                    "host_randn_ms": host_randn_ms(shapes)}
    log(f"phase 24: JAX's draws on {card}: bits and bernoulli equal, "
        f"normals {json.dumps(res['normal'])}, truncated "
        f"{json.dumps(res['truncated_normal'])}; ViT-B/32 + base() trees "
        f"{json.dumps(res['trees'])}")

    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            cli = seeded_vlm_cli(tmp)
        finally:
            os.chdir(old_cwd)
    res["vlm_cli"] = {k: v for k, v in cli.items() if k != "texts"}
    res["captions"] = caption_agreement(ref["captions"], cli["texts"])
    log(f"phase 24: seeded vlm through the CLI on {card}: "
        f"{json.dumps(res['vlm_cli'])}; captions against JAX's on the CPU "
        f"(reported, not gated): {json.dumps(res['captions'])}")
    return res


# ----------------------------------------------------------------- phase 25
DOMAIN_K = (65, 100, 256, 1000)
DOMAIN_DIMS = (1000, 2560, 4096)
DOMAIN_FRAMES = [(2160, 3840), (3840, 2160), (4320, 7680), (1081, 1921)]
DOMAIN_QUERIES = 2


def topk_bound(n: int, d: int, elem: int, b: int, k: int) -> dict:
    """The top-k's least time: the store's ``n`` counted rows, the queries
    and the [B, k] results moved once; 2 B n d float32 operations."""
    return bound(n * d * elem + b * d * 4 + b * k * 8, 2.0 * b * n * d,
                 F32_FLOPS)


def domain_topk(tc, q, store, k: int, count: int, device_ms: bool) -> dict:
    """One top-k shape: held to the plain version, then CUDA-event medians
    of the kernel, the plain version and the library yardstick
    (``torch.topk`` of ``F.normalize(q) @ S.float().T``), the device's
    time from CUDA-graph replay where asked, and the bound."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms

    n, d = store.shape
    past = torch.arange(n, device="cuda") >= count
    row = {"max_abs_err": check_topk(tc, q, store, k, count),
           "ms": cuda_ms(lambda: tc.cosine_topk(q, store, k, count=count)),
           "plain_ms": cuda_ms(
               lambda: tc.cosine_topk_ref(q, store, k, count=count)),
           "library_ms": cuda_ms(lambda: library_topk(q, store, past, k)),
           **topk_bound(min(count, n), d, store.element_size(), q.shape[0],
                        k)}
    if device_ms:
        row["device_ms"] = graph_ms(
            lambda: tc.cosine_topk(q, store, k, count=count))
    return row


def assert_select_exact(tc, scores, k: int) -> None:
    """``cosine_select`` against ``select_ref`` on the same dense scores:
    values and columns equal, bit for bit."""
    got = tc.select_topk(scores, k)
    torch.cuda.synchronize()
    ref = tc.select_ref(scores, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
        f"selection B={scores.shape[0]} k={k} differs from select_ref"


def mirror_bytes(host: np.ndarray, dtype) -> tuple:
    """An ``EmbeddingStore`` of ``host``'s rows with a ``dtype`` mirror on
    the card: (the store, the bytes its mirror holds on the card)."""
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore

    store = EmbeddingStore(dim=host.shape[1], capacity=host.shape[0],
                           dtype=dtype)
    store.add([f"c{i}" for i in range(host.shape[0])], host)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mirror = store._device_store()
    torch.cuda.synchronize()
    assert mirror.dtype == dtype
    return store, torch.cuda.memory_allocated() - before


def hits_match(got: list, ref: list) -> bool:
    """``EmbeddingStore.search`` results against a reference's: scores
    within ``TOL`` rank by rank, ids equal wherever the reference's scores
    on both sides of the rank are more than ``TOL`` apart."""
    if len(got) != len(ref):
        return False
    for g, r in zip(got, ref):
        gs = np.array([x for _, x in g])
        rs = np.array([x for _, x in r])
        if len(g) != len(r) or np.abs(gs - rs).max(initial=0.0) > TOL:
            return False
        pad = np.concatenate([[np.inf], rs, [-np.inf]])
        apart = (pad[:-2] - pad[1:-1] > TOL) & (pad[1:-1] - pad[2:] > TOL)
        if any(g[j][0] != r[j][0] for j in np.flatnonzero(apart)):
            return False
    return True


def domain_retrieval(tc) -> dict:
    """bench's retrieval with ``rerank_pool: 100`` and the trained
    reranker (phase 19's client): on the card bench's 30 queries after its
    warm-up queries, timed one by one, between a reset and a read of the
    counts; then the first ``DOMAIN_QUERIES`` on the CPU: texts equal, or
    where not, the query's 100-chunk pool equal on both (its hits by
    ``hits_match``), so that the texts differ by the reranker's near-ties
    only."""
    import bench

    async def serve(retriever, asked):
        texts, times = [], []
        for q in asked:
            t = time.perf_counter()
            texts.append((await retriever.perform_hybrid_retrieval(q))[0])
            times.append((time.perf_counter() - t) * 1e3)
        return texts, times

    def pools(retriever, store, asked):
        q = np.stack([retriever.embed.embed_query(x) for x in asked])
        return store._chunk_emb.search(q, 100)

    retriever, store, queries = bench_retriever("cuda", "tpu", "trained",
                                                rerank_pool=100)
    asyncio.run(serve(retriever, queries[:bench.WARMUP]))
    tc.reset_counts()
    texts, times = asyncio.run(serve(retriever, queries))
    counts = launch_counts(tc)
    sample = queries[:DOMAIN_QUERIES]
    gpu_pools = pools(retriever, store, sample)
    retriever, store, _ = bench_retriever("cpu", "tpu", "trained",
                                          rerank_pool=100)
    cpu_texts, _ = asyncio.run(serve(retriever, sample))
    cpu_pools = pools(retriever, store, sample)
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    assert all(texts), "an empty retrieval text"
    assert counts["score_dense"] >= len(texts) and \
        counts["select"] >= len(texts) and counts["plain"] == 0, counts
    equal = [a == b for a, b in zip(texts, cpu_texts)]
    for i, same in enumerate(equal):
        assert len(gpu_pools[i]) == 100
        assert same or hits_match(gpu_pools[i:i + 1], cpu_pools[i:i + 1]), \
            f"rerank_pool 100: query {i} differs from the CPU's"
    times.sort()
    return {"queries": len(texts), "p50_ms": statistics.median(times),
            "p95_ms": times[int(0.95 * (len(times) - 1))],
            "cpu_sample": len(equal), "texts_equal_cpu": sum(equal),
            "launches": counts}


def domain_vlm(seed: int) -> dict:
    """``TPUVLMClient(preprocess="device")`` captions one chunk of five
    2160 x 3840 frames between a reset and a read of the counts: kernel 2
    once, no plain version."""
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm = TPUVLMClient(seed=0, max_new=32, preprocess="device")
    frames = list(np.random.default_rng(seed + 25).integers(
        0, 256, (5, 2160, 3840, 3), dtype=np.uint8))
    reset_vision_counts()
    t0 = time.perf_counter()
    caption = vlm.caption_batch_sync([frames])[0]
    counts = {**vision_counts(), "preprocess_plain": pre.REF_CALLS}
    assert counts["preprocess"] == 1 and counts["preprocess_plain"] == 0, \
        counts
    assert isinstance(caption, str)
    return {"s": time.perf_counter() - t0, "launches": counts,
            "caption_bytes": len(caption.encode())}


def phase_domains(tc, seed: int, card: str) -> dict:
    """Kernels 1 and 2 at the inputs their TPU kernels take and the port
    once refused: k past the kernel's lists, widths past 2048, 16-bit
    stores, 4K and 8K frames; the paths that reach them."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore
    from vidgraph_tpu_torch.ops import preprocess as pre

    rng = np.random.default_rng(seed + 25)
    host = rng.normal(size=(STORE_ROWS, DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    seg = tc.segment_rows(STORE_ROWS, store.device)
    dup = sorted({10, 255, 256, 257, seg - 1, seg, seg + 1, 2 * seg + 100,
                  STORE_ROWS - 1000})
    store[dup] = store[dup[0]].clone()
    q = torch.from_numpy(rng.normal(size=(16, DIM)).astype(np.float32)).cuda()
    q[0] = store[dup[0]] * 2.0
    res = {"large_k": {}, "wide_d": {}, "mirror": {}, "frames": {}}
    timed, searched = {}, {}
    tc.reset_counts()
    scores = tc.cosine_scores(q, store, count=STORE_COUNT)
    for k in DOMAIN_K:
        for b in (1, 16):
            res["large_k"][f"b{b}_k{k}"] = domain_topk(tc, q[:b], store, k,
                                                       STORE_COUNT, False)
            assert_select_exact(tc, scores[:b], k)
        ids = tc.cosine_topk(q[:1], store, k, count=STORE_COUNT)[1]
        assert ids[0, :len(dup)].tolist() == dup, "ties out of row order"
    del scores
    for d in DOMAIN_DIMS:
        wide = F.normalize(torch.from_numpy(rng.normal(
            size=(20_000, d)).astype(np.float32)).cuda(), dim=-1)
        qd = torch.from_numpy(rng.normal(size=(16, d)).astype(
            np.float32)).cuda()
        for b in (1, 16):
            res["wide_d"][f"d{d}_b{b}"] = domain_topk(tc, qd[:b], wide, 5,
                                                      19_000, True)
        dense = tc.cosine_scores(qd, wide, count=19_000)
        torch.cuda.synchronize()
        err = float((dense - tc.cosine_scores_ref(qd, wide, 19_000))
                    .abs().max())
        assert err <= TOL, f"d={d} dense error {err}"
        res["wide_d"][f"d{d}_dense_b16"] = {"max_abs_err": err}
        del wide
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16),
                        ("float16", torch.float16)):
        st, nbytes = mirror_bytes(host, dtype)
        mirror = st._device_store()
        row = {"mirror_bytes": nbytes, "rows": st.capacity}
        if dtype != torch.float32:
            for b in (1, 16):
                row[f"b{b}_k5"] = domain_topk(tc, q[:b], mirror, 5,
                                              STORE_ROWS, True)
            row["b16_k100"] = domain_topk(tc, q, mirror, 100, STORE_ROWS,
                                          False)
            assert_select_exact(tc, tc.cosine_scores(q, mirror), 100)
        take_counts(tc, timed)
        row["search_k100"] = st.search(q.cpu().numpy(), 100)
        take_counts(tc, searched)
        res["mirror"][name] = row
        del st, mirror
    f32 = res["mirror"]["float32"]["mirror_bytes"]
    assert res["mirror"]["bfloat16"]["mirror_bytes"] * 2 == f32
    assert res["mirror"]["float16"]["mirror_bytes"] * 2 == f32
    res["kernel1_timing_calls"] = timed
    res["store_search_launches"] = searched
    assert timed["plain"] == 0 and searched["plain"] == 0, (timed, searched)
    assert searched["score_dense"] >= 3 and searched["select"] >= 3, \
        searched
    del store
    # after the read: each store's search(k=100) against a CPU store's
    for name, row in res["mirror"].items():
        cpu = EmbeddingStore(dim=DIM, capacity=STORE_ROWS,
                             dtype=getattr(torch, name),
                             device=torch.device("cpu"))
        cpu.add([f"c{i}" for i in range(STORE_ROWS)], host)
        ref = cpu.search(q.cpu().numpy(), 100)
        got = row.pop("search_k100")
        assert hits_match(got, ref), \
            f"{name} store: search(k=100) differs from the CPU's"
        row["search_k100_equal_cpu"] = True
        del cpu

    pre.reset_counts()
    for h, w in DOMAIN_FRAMES:
        x = torch.from_numpy(rng.integers(0, 256, (5, h, w, 3),
                                          dtype=np.uint8)).cuda()
        for fast in (True, False):
            got = pre.preprocess_frames(x, 224, fast)
            torch.cuda.synchronize()
            ref = pre.preprocess_ref(x, 224, fast)
            tol = pre.TOL_FAST if fast else pre.TOL_F32
            err = float((got.float() - ref.float()).abs().max())
            assert got.shape == ref.shape and bool(torch.isfinite(got).all()) \
                and err <= tol, f"preprocess 5x{h}x{w} fast={fast}: {err}"
            plan = pre.plan(h, w, 224, fast, 5)
            res["frames"][f"b5_{h}x{w}_{'fast' if fast else 'exact'}"] = {
                "max_abs_err": err, "tol": tol,
                "ms": graph_ms(lambda: pre.preprocess_frames(x, 224, fast)),
                "plain_ms": cuda_ms(lambda: pre.preprocess_ref(x, 224, fast)),
                "library_ms": cuda_ms(lambda: library_resize(x, 224)),
                "plan": {"rows": plan.rows, "cols": plan.cols,
                         "source_rows": int(plan.count.max()),
                         "smem": plan.smem},
                **bound(x.numel() + got.numel() * got.element_size(), 0.0,
                        F32_FLOPS)}
            del got, ref
        del x
    res["kernel2_timing_calls"] = {**pre.LAUNCHES, "plain": pre.REF_CALLS}
    assert res["kernel2_timing_calls"]["plain"] == 0
    res["retrieval_rerank_pool_100"] = domain_retrieval(tc)
    res["vlm_4k"] = domain_vlm(seed)
    log(f"phase 25: kernels 1 and 2 at their full domains on {card} (ms, "
        f"CUDA-event medians; device_ms and the frames' ms from CUDA-graph "
        f"replay): {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 26
# the general kernels' timed shapes: (B, T, h, hd), f32 and bf16, nv 8
ATTN_DOMAIN_FLASH = [(2, 1033, 8, 32), (2, 1033, 8, 80)]
# B x h = 65,600 at T 9: past the 65,535 of a grid's y dimension
ATTN_DOMAIN_WIDE = (8200, 9, 8)
# kernel 5's new inputs: (name, B, h, N, hd, dtype): the tiny64 tower's
# heads (4 x 32, N 5, float32), ViT-B/32 at a 512 input (N 257), N 1025,
# hd 80
ATTN_DOMAIN_SHORT = [("b12_h4_n5_hd32_f32", 12, 4, 5, 32, torch.float32),
                     ("b5_h12_n257_hd64_bf16", 5, 12, 257, 64,
                      torch.bfloat16),
                     ("b1_h12_n1025_hd64_bf16", 1, 12, 1025, 64,
                      torch.bfloat16),
                     ("b5_h8_n50_hd80_bf16", 5, 8, 50, 80, torch.bfloat16)]
ATTN_DOMAIN_Q8 = (2048, 8192, (65, 200))
# the tiny64 caption: 4 chunks of 3 frames of 64 x 64 (the tower's input:
# normalised, not resized), from this seed; tests/test_torch_attention_
# domains.py holds the port's CPU caption of the same frames to the JAX
# package's
TINY64_SEED, TINY64_SHAPE = 26, (4, 3, 64, 64, 3)
# teacher-forced logits, card against CPU (float32, another summation
# order), and the logit gap under which a differing byte is a near-tie
TINY64_LOGIT_TOL, TINY64_TIE = 1e-4, 1e-3
# the instruct trainer's smoke: steps, and its first loss against the
# einsum path's
SMOKE_TRAIN_STEPS, SMOKE_LOSS_TOL = 3, 1e-3


def tiny64_chunks() -> list:
    return [list(c) for c in np.random.default_rng(TINY64_SEED).integers(
        0, 256, TINY64_SHAPE, dtype=np.uint8)]


def tiny64_caption() -> dict:
    """``TPUVLMClient(preset="tiny64", seed=0)`` captions 4 chunks on the
    card between a reset and a read of the counts (the general forward
    once a layer, no plain version); its tokens against ``generate(...,
    flash=False)`` on the card (equal) and against the port's CPU
    caption of the same frames (the JAX package's, by the CPU test): a
    differing row's teacher-forced logits within ``TINY64_LOGIT_TOL`` of
    the CPU's and its first differing byte a near-tie."""
    from vidgraph_tpu_torch.core.platform import DEVICE_ENV
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import forward, generate
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm = TPUVLMClient(preset="tiny64", seed=0)
    chunks = tiny64_chunks()
    fa.reset_counts()
    t0 = time.perf_counter()
    texts = vlm.caption_batch_sync(chunks)
    wall = time.perf_counter() - t0
    counts = {**fa.LAUNCHES, "plain": fa.REF_CALLS}
    layers = vlm.cap_cfg.layers
    assert counts["flash_fwd_general"] == layers and counts["flash_fwd"] \
        == 0 and counts["plain"] == 0, counts
    toks, vis = caption_tokens(vlm, chunks)
    plain = generate(vlm._serve_params, vlm.cap_cfg, vis,
                     max_new=vlm.max_new, flash=False)
    assert torch.equal(toks, plain), "tiny64: flash and plain tokens differ"
    assert [tokenizer.decode(r) for r in toks.cpu().numpy()] == texts
    os.environ[DEVICE_ENV] = "cpu"
    try:
        cpu = TPUVLMClient(preset="tiny64", seed=0)
        cpu_toks, cpu_vis = caption_tokens(cpu, chunks)
    finally:
        os.environ[DEVICE_ENV] = "cuda"
    card, host = toks.cpu().numpy(), cpu_toks.numpy()
    rows = []
    for i in range(len(chunks)):
        gap = caption_gap(cpu, cpu_vis[i], host[i].astype(np.int64),
                          card[i].astype(np.int64))
        row = {"chunk": i, "equal_tokens": gap is None}
        if gap is not None:
            s = gap["first_differing_step"]
            ctx = torch.from_numpy(np.concatenate(
                [[tokenizer.BOS_ID], host[i][:s]]).astype(np.int64))[None]
            with torch.no_grad():
                want = forward(cpu._serve_params, cpu.cap_cfg,
                               cpu_vis[i][None], ctx)
                got = forward(vlm._serve_params, vlm.cap_cfg, vis[i][None],
                              ctx.cuda(), flash=True).cpu()
            gap["logit_err"] = float((got - want).abs().max())
            assert gap["logit_err"] <= TINY64_LOGIT_TOL, (i, gap)
            assert abs(gap["logit_gap"]) <= TINY64_TIE, (i, gap)
            row["gap"] = gap
        rows.append(row)
    return {"wall_s": wall, "launches": counts, "chunks": len(chunks),
            "equal_flash_false": True, "rows": rows,
            "equal_rows_cpu": sum(r["equal_tokens"] for r in rows),
            "caption_bytes": [len(t.encode()) for t in texts]}


def tiny64_fused_tower() -> dict:
    """The tiny64 tower with ``attn_impl='fused'`` on the card, between a
    reset and a read of the counts: kernel 5's general route once a
    layer, within 1e-5 of the einsum tower (float32)."""
    from vidgraph_tpu_torch.models import vit as tvit
    from vidgraph_tpu_torch.ops import short_attention as sa
    from vidgraph_tpu_torch.services.vlm_client import _TPU_VLM_PRESETS

    cfg = tvit.ViTConfig(dtype=torch.float32, **_TPU_VLM_PRESETS["tiny64"][0])
    einsum = tvit.init_vision_tower(cfg, 0, device=CUDA).eval()
    fused = tvit.init_vision_tower(dataclasses.replace(
        cfg, attn_impl="fused"), 0, device=CUDA).eval()
    stack = np.concatenate(tiny64_chunks())
    x = torch.from_numpy(stack).cuda().float() / 255.0
    sa.reset_counts()
    with torch.no_grad():
        got = fused(x)
        torch.cuda.synchronize()
        counts = {**sa.LAUNCHES, "plain": sa.REF_CALLS}
        want = einsum(x)
    err = float((got - want).abs().max())
    assert counts["short_attention_general"] == cfg.layers and \
        counts["short_attention"] == 0 and counts["plain"] == 0, counts
    assert err <= 1e-5, f"tiny64 fused tower: {err}"
    return {"launches": counts, "max_abs_err": err}


def train_smoke_flash(seed: int, tmp: Path) -> dict:
    """``train_torch_instruct_lm.py --smoke --flash`` (width 64, 2 heads of
    32, bf16: the general kernels, forward and backward) for
    ``SMOKE_TRAIN_STEPS`` steps between a reset and a read of the counts;
    its first loss against the einsum path's from the same seed weights."""
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.ops import flash_attention as fa

    mod = load_script("train_torch_instruct_lm")
    seq = 768
    fa.reset_counts()
    t0 = time.perf_counter()
    rec = mod.main(["--corpus", str(training_corpus(tmp, seed)),
                    "--steps", str(SMOKE_TRAIN_STEPS), "--smoke", "--flash",
                    "--seq-len", str(seq), "--max-new", "160",
                    "--seed", str(seed), "--out", str(tmp / "smoke_lm.npz")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**fa.LAUNCHES, "plain": fa.REF_CALLS}
    layers = rec["layers"]
    fwd_want = layers * (SMOKE_TRAIN_STEPS + rec["held_evals"]
                         * rec["held_buckets"] + rec["held_examples"])
    assert rec["attention"] == "flash" and counts["plain"] == 0, counts
    assert counts["flash_bwd_general"] == counts["flash_bwd_general_delta"] \
        == counts["flash_bwd_general_dq_convert"] \
        == layers * SMOKE_TRAIN_STEPS, counts
    assert counts["flash_fwd_general"] == fwd_want, (counts, fwd_want)
    assert counts["flash_fwd"] == counts["flash_bwd_fused"] == 0, counts
    assert all(np.isfinite(rec["losses"])), rec["losses"]
    cfg = CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                          num_vision_tokens=2, max_len=seq + 512)
    params = init_params(cfg, seed, device=CUDA, requires_grad=True)
    toks, plens = (torch.as_tensor(a, device="cuda")
                   for a in rec["first_batch"])
    with torch.no_grad():
        loss_e = float(mod.instruct_loss(params, cfg, toks, plens, True,
                                         False))
    assert abs(loss_e - rec["losses"][0]) <= SMOKE_LOSS_TOL, \
        (loss_e, rec["losses"][0])
    return {"wall_s": wall, "steps": SMOKE_TRAIN_STEPS,
            "losses": rec["losses"], "first_loss_einsum": loss_e,
            "launches": counts, "flash_fwd_expected": fwd_want}


def general_flash_row(fa, b, t, h, hd, dtype, rng) -> dict:
    """Kernels 3a and 3b/3c general at [b, t, h, hd] of ``dtype``, nv 8:
    the forward, its log-sum-exp and the three gradients against the
    plain versions (``fa.tolerance``; float32 gradients within
    ``BWD_TOL_F32``); then the times of the kernels, the plain versions
    and SDPA, with bounds."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms

    nv = 8
    route = fa.flash_route(dtype, hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, t, h, hd), dtype=np.float32)).to("cuda", dtype)
        for _ in range(4))
    out, lse = fa._cuda_flash(q, k, v, nv, with_lse=True)
    grads = fa._cuda_flash_bwd(q, k, v, out, lse, do, nv)
    torch.cuda.synchronize()
    tol_abs, tol_rel = fa.tolerance(dtype)
    ref = fa.attention_ref(q, k, v, nv).to(dtype).float()
    err = (out.float() - ref).abs()
    assert bool(torch.isfinite(out).all()) and float(
        (err - tol_abs - tol_rel * ref.abs()).max()) <= 0, \
        f"general forward {b}x{t}x{h}x{hd} {dtype}: {float(err.max())}"
    lse_err = float((lse - fa.lse_ref(q, k, nv)).abs().max())
    assert lse_err <= (1e-5 if dtype == torch.float32 else 2e-3), lse_err
    if dtype == torch.float32:
        g_abs, g_rel = fa.BWD_TOL_F32_ABS, fa.BWD_TOL_F32_REL
    else:
        g_abs, g_rel = tol_abs, tol_rel
    refs = fa.attention_bwd_ref(q, k, v, out, lse, do, nv)
    g_err = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        want = want.to(dtype).float()
        diff = (got.float() - want).abs()
        assert got.dtype == dtype and float(
            (diff - g_abs - g_rel * want.abs()).max()) <= 0, \
            f"general backward {name} {b}x{t}x{h}x{hd} {dtype}: " \
            f"{float(diff.max())}"
        g_err = max(g_err, float(diff.max()))
    row = {"route": route, "max_abs_err": float(err.max()),
           "lse_err": lse_err, "bwd_max_abs_err": g_err}
    del ref, refs, err
    pairs = visible_pairs(t, nv)
    elem = torch.finfo(dtype).bits // 8
    tensor, vec = b * t * h * hd * elem, b * h * t * 4
    product = 2.0 * b * h * hd * pairs
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    mask = fa.prefix_causal_mask(t, nv, q.device)
    row.update({
        "kernel_ms": cuda_ms(lambda: fa._cuda_flash(q, k, v, nv)),
        "kernel_lse_ms": cuda_ms(lambda: fa._cuda_flash(q, k, v, nv,
                                                        with_lse=True)),
        # device time alone (CUDA-graph replay): CUDA events around one
        # call also time the wrapper's host launch
        "kernel_device_ms": graph_ms(lambda: fa._cuda_flash(q, k, v, nv)),
        "bwd_device_ms": graph_ms(lambda: fa._cuda_flash_bwd(
            q, k, v, out, lse, do, nv)),
        "plain_ms": cuda_ms(lambda: fa.attention_ref(q, k, v, nv),
                            reps=5),
        **library_sdpa(q, k, v, mask),
        **bound(4 * tensor, 2 * product, peak),
        "bwd_ms": cuda_ms(lambda: fa._cuda_flash_bwd(
            q, k, v, out, lse, do, nv), reps=10),
        "plain_bwd_ms": cuda_ms(lambda: fa.attention_bwd_ref(
            q, k, v, out, lse, do, nv), reps=3, warmup=1),
        # q, k, v, o, dO, L in, dq, dk, dv out, 5 products
        "bwd_bound": bound(8 * tensor + vec, 5 * product, peak)})
    delta, acc = fa._cuda_general_delta(out, do)
    scale = 1.0 / math.sqrt(hd)
    # the two small stages' device times from CUDA-graph replay:
    # CUDA events around one call time its host launch
    row["stages"] = {
        "delta": {
            "ms": graph_ms(lambda: fa._cuda_general_delta(out, do)),
            "plain_ms": graph_ms(
                lambda: (do.float() * out.float()).sum(-1)
                .transpose(1, 2).contiguous()),
            # o and dO in, delta out, the accumulator zeroed
            **bound(2 * tensor + vec + b * t * h * hd * 4,
                    2.0 * b * t * h * hd, F32_FLOPS)},
        "bwd": {
            "ms": cuda_ms(lambda: fa._cuda_general_bwd(
                q, k, v, do, lse, delta, acc, nv), reps=10),
            # q, k, v, dO, L, delta in; dk, dv, the accumulator out
            **bound(6 * tensor + 2 * vec + b * t * h * hd * 4,
                    5 * product, peak)},
        "dq_convert": {
            "ms": graph_ms(lambda: fa._cuda_general_dq_convert(
                acc, dtype)),
            "plain_ms": graph_ms(lambda: (acc * scale).to(dtype)),
            **bound(b * t * h * hd * 4 + tensor, 0.0, F32_FLOPS)}}
    del delta, acc
    sdpa = library_sdpa_train(q, k, v, do, mask)
    row.update({"library_bwd_ms": sdpa["library_bwd_ms"],
                "library_fwd_bwd_ms": sdpa["library_fwd_bwd_ms"]})
    del q, k, v, do, out, lse, grads
    torch.cuda.empty_cache()
    return row


def general_short_row(sa, b, h, n, hd, dtype, rng) -> dict:
    """Kernel 5's general route (two passes) at [b, h, n, hd] of
    ``dtype``: held to the plain version (``sa.tolerance``), then the
    device times (CUDA-graph replay) of the kernel, the plain version and
    SDPA, with the bound."""
    from vidgraph_tpu_torch.core.profiling import graph_ms

    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, h, n, hd), dtype=np.float32)).to("cuda", dtype)
        for _ in range(3))
    assert sa.short_route(dtype, hd, n) == "general", (b, h, n, hd, dtype)
    got = sa.fused_short_attention(q, k, v)
    torch.cuda.synchronize()
    ref = sa.short_attention_ref(q, k, v).float()
    tol_abs, tol_rel = sa.tolerance(dtype)
    err = (got.float() - ref).abs()
    assert bool(torch.isfinite(got).all()) and float(
        (err - tol_abs - tol_rel * ref.abs()).max()) <= 0, \
        f"short attention {b}x{h}x{n}x{hd} {dtype}: {float(err.max())}"
    elem = torch.finfo(dtype).bits // 8
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    return {"max_abs_err": float(err.max()),
            "kernel_ms": graph_ms(lambda: sa.fused_short_attention(q, k, v)),
            "plain_ms": graph_ms(lambda: sa.short_attention_ref(q, k, v)),
            "library_ms": graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            **bound(4 * b * h * n * hd * elem, 4.0 * b * h * n * n * hd,
                    peak)}


def wide_heads_row(fa, b, t, h, hd, dtype, rng) -> dict:
    """Kernels 3a and 3b/3c at B x h past 65,535 (the grid's y limit):
    the forward within ``fa.tolerance`` of the plain version; the output
    and the gradients bit for bit those of the two half batches (no fold;
    at T <= 64 one key tile adds into each dq element once); the
    gradients' Frobenius error within ``BWD_REL_FRO`` of the plain norm."""
    nv = 8
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, t, h, hd), dtype=np.float32)).to("cuda", dtype)
        for _ in range(4))

    def run(s):
        out, lse = fa._cuda_flash(q[s], k[s], v[s], nv, with_lse=True)
        return (out, lse, *fa._cuda_flash_bwd(q[s], k[s], v[s], out, lse,
                                              do[s], nv))

    whole = run(slice(None))
    halves = [run(slice(0, b // 2)), run(slice(b // 2, b))]
    torch.cuda.synchronize()
    same = all(torch.equal(x, torch.cat([hv[i] for hv in halves]))
               for i, x in enumerate(whole))
    assert same, f"{b} x {h} heads: the folded grid differs from halves"
    out, lse, *grads = whole
    tol_abs, tol_rel = fa.tolerance(dtype)
    ref = fa.attention_ref(q, k, v, nv).to(dtype).float()
    err = (out.float() - ref).abs()
    fwd_err = float(err.max())
    assert float((err - tol_abs - tol_rel * ref.abs()).max()) <= 0, \
        f"{b} x {h} heads forward: {fwd_err}"
    fro = 0.0
    for got, want in zip(grads, fa.attention_bwd_ref(q, k, v, out, lse, do,
                                                     nv)):
        want = want.to(dtype).float()
        fro = max(fro, float((got.float() - want).norm())
                  / float(want.norm()))
    assert fro <= BWD_REL_FRO, f"{b} x {h} heads backward: {fro}"
    del q, k, v, do, whole, halves, ref, err
    torch.cuda.empty_cache()
    return {"route": fa.flash_route(dtype, hd), "heads": b * h,
            "max_abs_err": fwd_err, "equal_to_halves": same,
            "bwd_rel_fro": fro}


def phase_attention_domains(seed: int, card: str) -> dict:
    """Kernels 3, 4 and 5 at the inputs their TPU kernels take and the
    port once refused: the paths that reach them (the tiny64 caption, the
    instruct trainer's smoke with ``--flash``, the tiny64 tower fused),
    each between a reset and a read of the counts, then every new input
    against its plain version, timed beside its bound, the plain version
    and the library call."""
    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.models import quant8
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import q8_matmul as q8
    from vidgraph_tpu_torch.ops import short_attention as sa

    rng = np.random.default_rng(seed + 26)
    res = {"tiny64_caption": tiny64_caption(),
           "tiny64_fused_tower": tiny64_fused_tower()}
    with tempfile.TemporaryDirectory() as tmp:
        res["train_smoke_flash"] = train_smoke_flash(seed, Path(tmp))

    fa.reset_counts()
    flash = {}
    for b, t, h, hd in ATTN_DOMAIN_FLASH:
        for dtype in (torch.float32, torch.bfloat16):
            name = f"b{b}_T{t}_h{h}x{hd}_{str(dtype)[6:]}"
            flash[name] = general_flash_row(fa, b, t, h, hd, dtype, rng)
    b, t, h = ATTN_DOMAIN_WIDE
    for hd, dtype in ((64, torch.bfloat16), (32, torch.float32)):
        name = f"b{b}_T{t}_h{h}x{hd}_{str(dtype)[6:]}"
        flash[name] = wide_heads_row(fa, b, t, h, hd, dtype, rng)
    res["flash"] = flash
    res["flash_timing_calls"] = {**fa.LAUNCHES, "plain": fa.REF_CALLS}
    assert fa.REF_CALLS == 0

    sa.reset_counts()
    short = {name: general_short_row(sa, b, h, n, hd, dtype, rng)
             for name, b, h, n, hd, dtype in ATTN_DOMAIN_SHORT}
    res["short"] = short
    res["short_timing_calls"] = {**sa.LAUNCHES, "plain": sa.REF_CALLS}
    assert sa.REF_CALLS == 0

    k, n, ms = ATTN_DOMAIN_Q8
    w = torch.from_numpy(rng.standard_normal(
        (k, n), dtype=np.float32) * 0.02).cuda()
    wq = quant8.quantize_matrix(w)
    qs = [wq.q.clone() for _ in range(Q8_COPIES)]
    ws = [w.to(torch.bfloat16) for _ in range(Q8_COPIES)]
    q8rows = {}
    for m in ms:
        x = torch.from_numpy(rng.standard_normal(
            (m, k), dtype=np.float32)).to("cuda", torch.bfloat16)
        q8.reset_counts()
        err, top = check_q8(q8, x, wq.q, wq.s)
        assert q8.LAUNCHES["q8_matmul"] == 2 * len(q8.slabs(m)), q8.LAUNCHES
        q8rows[f"K{k}_N{n}_M{m}"] = {
            "max_abs_err": err, "max_rel_err": err / top,
            "launches_a_call": len(q8.slabs(m)),
            "kernel_ms": graph_ms(rotating(
                lambda qq: q8.q8_matmul(x, qq, wq.s), qs)),
            "plain_ms": graph_ms(rotating(
                lambda qq: q8.q8_matmul_ref(x, qq, wq.s), qs)),
            "cublas_bf16_ms": graph_ms(rotating(lambda vv: x @ vv, ws)),
            **bound(k * n + 2 * m * k + 4 * n + 4 * m * n, 2.0 * m * k * n,
                    BF16_FLOPS)}
    res["q8"] = q8rows
    res["q8_timing_calls"] = {**q8.LAUNCHES, "plain": q8.REF_CALLS}
    del w, wq, qs, ws
    torch.cuda.empty_cache()
    log(f"phase 26: kernels 3, 4 and 5 at their full domains on {card} "
        f"(ms; flash rows CUDA-event medians, short and q8 rows device "
        f"time from CUDA-graph replay): {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 27
DECODE_NEW = 48
# (name, B, local heads, hd, cache slots, live keys): the large()
# captioner's step at B 1 over every slot (the ingest cell) and the chat
# LM's at B 1 over 4,096 positions
DECODE_CASES = (("large_b1_h16_s265_hd128", 1, 16, 128, 265, 265),
                ("chat_b1_h8_s4096_hd64", 1, 8, 64, 4096, 4096))


def decode_case(da, fa, b, h, hd, max_t, live, seed) -> dict:
    """Kernel D against ``decode_attention_ref`` on card tensors (bf16, the
    decode loop's ragged mask): the cache writes bit-equal, ``o`` within
    the dtype's tolerance (summation order only); then the device times
    (CUDA-graph replay) of the kernel, the plain chain and SDPA at
    q-length 1 with a boolean mask (the library yardstick, which the port
    never calls), the host's microseconds a call of kernel and chain, and
    the bound: the live K and V, q and o over 3.35 TB/s."""
    import torch.nn.functional as F

    from vidgraph_tpu_torch.core.profiling import graph_ms

    dt, slot = torch.bfloat16, live - 1
    g = torch.Generator(device=CUDA).manual_seed(seed)
    qkv = torch.randn(b, 1, 3 * h * hd, generator=g, device=CUDA).to(dt)
    q, k, v = (z.reshape(b, 1, h, hd) for z in qkv.split(h * hd, -1))
    qkv_b = torch.randn(3 * h * hd, generator=g, device=CUDA).to(dt)
    kc, vc = (torch.randn(b, h, max_t, hd, generator=g, device=CUDA)
              for _ in range(2))
    start = torch.randint(0, slot // 2 + 1, (b,), generator=g, device=CUDA)
    key = torch.arange(max_t, device=CUDA)
    masked = (key[None, :] >= start[:, None])[:, None, None, :].clone()
    masked[..., slot // 2:slot + 1] = False
    kc2, vc2 = kc.clone(), vc.clone()
    want = da.decode_attention_ref(q, k, v, qkv_b, kc2, vc2, slot, masked,
                                   dt)
    got = da.decode_attention(q, k, v, qkv_b, kc, vc, slot, masked, dt)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2), \
        "decode_attention: the cache writes differ from the plain version's"
    tol_abs, tol_rel = fa.tolerance(dt)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol_abs + tol_rel * want.float().abs()).all()), \
        f"decode_attention: max |err| {float(err.max())}"
    qf = (q.float() + qkv_b[:h * hd].float().view(1, 1, h, hd)) \
        .transpose(1, 2)

    def kernel():
        return da.decode_attention(q, k, v, qkv_b, kc, vc, slot, masked, dt)

    def plain():
        return da.decode_attention_ref(q, k, v, qkv_b, kc2, vc2, slot,
                                       masked, dt)

    def sdpa():
        return F.scaled_dot_product_attention(qf, kc, vc, attn_mask=~masked)
    row = {"route": list(da.plan(b * h, live, hd)),
           "max_abs_err": float(err.max()),
           "kernel_ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
           "library_ms": graph_ms(sdpa),
           "kernel_host_us": host_us(kernel), "plain_host_us": host_us(plain),
           **bound((2 * live * hd * 4 + 2 * hd * 2) * b * h, 4.0 * b * h
                   * live * hd, F32_FLOPS)}
    del kc, vc, kc2, vc2
    return row


def phase_decode_attention(seed: int, card: str) -> dict:
    """Kernel D on the decode paths, then at the decode's shapes.  Each
    path between a reset and a read of the counts: ``generate`` of the
    ``large()`` captioner at B 1 (the ingest cell's decode) and
    ``generate_from_tokens`` of the chat LM at B 1 over a 4,000-token
    prompt, each under the profiling spans: the kernel's launches and the
    ``captioner.decode`` span's ``attn_kernel_calls`` both layers x
    steps, the plain version never called.  Then ``DECODE_CASES`` through
    ``decode_case``."""
    from vidgraph_tpu_torch.core import profiling
    from vidgraph_tpu_torch.models import captioner as cap
    from vidgraph_tpu_torch.ops import decode_attention as da
    from vidgraph_tpu_torch.ops import flash_attention as fa

    paths = {}
    for name, cfg in (("large_b1", cap.CaptionerConfig.large()),
                      ("chat_b1", cap.CaptionerConfig.chat())):
        params = cap.serving_params(cap.init_params(
            cfg, seed, param_dtype=torch.bfloat16, device=CUDA), cfg)
        g = torch.Generator(device=CUDA).manual_seed(seed + 27)
        if name == "large_b1":
            vis = torch.randn(1, cfg.num_vision_tokens, cfg.vision_dim,
                              generator=g, device=CUDA)

            def decode():
                return cap.generate(params, cfg, vis, max_new=DECODE_NEW)
        else:
            t = 4000
            tokens = torch.randint(0, 256, (1, t), generator=g, device=CUDA,
                                   dtype=torch.int32)
            lens = torch.tensor([t], device=CUDA)

            def decode():
                return cap.generate_from_tokens(params, cfg, tokens, lens,
                                                max_new=DECODE_NEW)
        da.LAUNCHES["decode_attention"], da.REF_CALLS = 0, 0
        profiling.enable()
        try:
            toks = decode()
            torch.cuda.synchronize()
            (span,) = [r for r in profiling.drain()
                       if r["name"] == "captioner.decode"]
        finally:
            profiling.disable()
        steps = cap.decode_steps(toks, DECODE_NEW)
        launches = da.LAUNCHES["decode_attention"]
        assert launches == span["counts"]["attn_kernel_calls"] \
            == cfg.layers * steps and da.REF_CALLS == 0, \
            (name, launches, span["counts"], cfg.layers, steps)
        paths[name] = {"launches": launches, "layers": cfg.layers,
                       "steps": steps, "plain_calls": da.REF_CALLS}
        del params
        torch.cuda.empty_cache()
    rows = {name: decode_case(da, fa, b, h, hd, max_t, live, seed + i)
            for i, (name, b, h, hd, max_t, live) in enumerate(DECODE_CASES)}
    torch.cuda.empty_cache()
    log(f"phase 27: kernel D on the decode paths (launches = layers x "
        f"steps, no plain call): {json.dumps(paths)}; against the plain "
        f"version (caches bit-equal) and timed on {card} (ms, device time "
        f"from CUDA-graph replay; host_us a call enqueued): "
        f"{json.dumps(rows)}")
    return {"paths": paths, "rows": rows}


def kernel_record(kern, main_path, flash, chat, pre, short, vision, q8k,
                  quant, bwd, training, streams, tooling, mesh,
                  leader, domains, attn, decode) -> dict:
    """The ``kernels`` record: every kernel of the port, its launches on
    the main paths, its error against its plain version, its times and
    its bound at the shape it was timed at."""
    src = "vidgraph_tpu_torch/csrc/topk_cosine.cu"
    replaces = "vidgraph_tpu/ops/topk_cosine.py:39"
    launches = main_path["launches"]
    stages, lib = kern["stages"], kern["library"]
    dense = kern["times"]["dense_b16"]
    tile, sel = stages["score_topk_b16_k5"], stages["select_b16_k100"]
    store_bytes = STORE_ROWS * DIM * 4
    score_ops = 2.0 * 16 * STORE_ROWS * DIM
    t, nv, b32 = 2056, 8, flash["b32_T2056"]
    pairs = flash_pairs(t, nv)
    vision_counts = [vision["counts"][m] for m in ("einsum", "fused")]
    vision_counts.append(streams["counts"])
    sk = streams["kernels"]
    vit160, sweep = tooling["vit_b160"], tooling["sweep_epoch"]
    judge = tooling["judge_agreement"]
    # phase 22's paths: the world-1 mesh's store, retrieval and chat, and
    # the 4 gloo ranks' store and chat
    gloo = mesh["gloo_4_ranks_on_one_card"]
    mesh_topk = {key: (mesh["store"]["launches"][key]
                       + mesh["retrieval"]["launches"][key]
                       + sum(c[key] for c in gloo["store_launches"]))
                 for key in ("score_topk", "select")}
    mesh_flash = (mesh["chat"]["launches"]["flash"]
                  + sum(c["flash"] for c in gloo["chat_launches"]))
    # phase 23's: the streams and servers under the rank-0 leader, NCCL
    # world 1 and every gloo rank
    led = leader["launches"]
    # phase 25's paths (not its timed calls): the three stores'
    # search(k=100) and the retrieval with rerank_pool 100; the 4K caption
    dom1 = {key: (domains["store_search_launches"][key]
                  + domains["retrieval_rerank_pool_100"]["launches"][key])
            for key in ("score_topk", "select", "score_dense")}
    dom2 = domains["vlm_4k"]["launches"]["preprocess"]
    big_k = domains["large_k"]["b16_k1000"]
    bf16 = domains["mirror"]["bfloat16"]
    wide = domains["wide_d"]["d4096_b16"]
    frame8k = domains["frames"]["b5_4320x7680_fast"]
    pre5 = pre["b5_405x720_fast"]
    short5 = short["b5"]
    q8row = q8k["rows"]["K2048_N8192_M32"]
    inst = training["instruct"]["launches"]
    mid = training["midscale"]["runs"]["flash"]["launches"]
    bwd_rows = bwd["rows"]
    brow = bwd_rows["b8_T3080_h8x64_nv8"]
    bwd_src = "vidgraph_tpu_torch/csrc/flash_attention_bwd.cu"
    # the call whose custom_vjp runs the TPU backward kernels, and their
    # lines in JAX's own source
    bwd_site = "vidgraph_tpu/models/captioner.py:191"
    jax_flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    bwd_timed = ("B=8, T=3080, 8 heads x 64, bf16, nv=8 (the instruct "
                 "trainer's long bucket)")
    # phase 26's paths: the tiny64 caption and the instruct smoke (the
    # general flash kernels), the tiny64 tower fused (kernel 5's general
    # route); kernel 4's slabs are reached by direct calls only
    gen_src = "vidgraph_tpu_torch/csrc/attention_general.cu"
    gen_bwd_src = "vidgraph_tpu_torch/csrc/attention_general_bwd.cu"
    # float32 inputs take the CUDA-core kernels of this file
    gen_f32 = {"source_float32": "vidgraph_tpu_torch/csrc/"
                                 "attention_general_f32.cu"}
    cap64 = attn["tiny64_caption"]["launches"]
    smoke = attn["train_smoke_flash"]["launches"]
    grow = attn["flash"]["b2_T1033_h8x32_float32"]
    gen_timed = "B=2, T=1033, 8 heads x 32, float32, nv=8"
    gen_rows = [r for r in attn["flash"].values() if r["route"] == "general"]
    gen_err = max(r["max_abs_err"] for r in gen_rows)
    gen_bwd_err = max(r["bwd_max_abs_err"] for r in gen_rows
                      if "bwd_max_abs_err" in r)
    srow = attn["short"]["b5_h12_n257_hd64_bf16"]
    q8wide = attn["q8"]["K2048_N8192_M200"]
    drow = decode["rows"]["large_b1_h16_s265_hd128"]

    def stage(name):
        return {key: grow["stages"][name][key]
                for key in ("ms", "bound_ms", "bound_by")}
    general = [
        {"name": "attn_general_fwd (flash route)", "route": "cuda",
         "source": gen_src, **gen_f32,
         "replaces": "vidgraph_tpu/models/captioner.py:191",
         "launches": cap64["flash_fwd_general"]
                     + smoke["flash_fwd_general"],
         "tiny64_caption_launches": cap64["flash_fwd_general"],
         "train_smoke_launches": smoke["flash_fwd_general"],
         "max_abs_err": gen_err, "ms": grow["kernel_ms"],
         "device_ms": grow["kernel_device_ms"],
         "plain_ms": grow["plain_ms"], "library_ms": grow["library_ms"],
         "library_kernels": grow["library_kernels"],
         "bound_ms": grow["bound_ms"], "bound_by": grow["bound_by"],
         "timed": gen_timed},
        {"name": "attn_general_bwd_delta", "route": "cuda",
         "source": gen_bwd_src,
         "replaces": bwd_site, "replaces_in_jax": jax_flash + ":273",
         "launches": smoke["flash_bwd_general_delta"],
         "max_abs_err": gen_bwd_err,
         "plain_ms": grow["stages"]["delta"]["plain_ms"],
         "library_ms": None, **stage("delta"),
         "timed": gen_timed + "; device time from CUDA-graph replay"},
        {"name": "attn_general_bwd", "route": "cuda", "source": gen_bwd_src,
         **gen_f32, "replaces": bwd_site,
         "replaces_in_jax": jax_flash + ":1121 and :1456",
         "launches": smoke["flash_bwd_general"],
         "max_abs_err": gen_bwd_err, "plain_ms": grow["plain_bwd_ms"],
         "library_ms": grow["library_bwd_ms"], **stage("bwd"),
         "backward_ms": grow["bwd_ms"],
         "backward_device_ms": grow["bwd_device_ms"],
         "timed": gen_timed + "; plain_ms and library_ms are of the whole "
                  "backward (attention_bwd_ref; SDPA's forward + backward "
                  "less its forward)"},
        {"name": "attn_general_dq_convert", "route": "cuda",
         "source": gen_bwd_src, "replaces": bwd_site,
         "replaces_in_jax": jax_flash + ":1456",
         "launches": smoke["flash_bwd_general_dq_convert"],
         "max_abs_err": gen_bwd_err,
         "plain_ms": grow["stages"]["dq_convert"]["plain_ms"],
         "library_ms": None, **stage("dq_convert"),
         "timed": gen_timed + "; device time from CUDA-graph replay"},
        {"name": "attn_general_fwd (short-attention route, two passes)",
         "route": "cuda", "source": gen_src, **gen_f32,
         "replaces": "vidgraph_tpu/ops/short_attention.py:119",
         "launches": attn["tiny64_fused_tower"]["launches"][
             "short_attention_general"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in attn["short"].values()),
         "ms": srow["kernel_ms"], "plain_ms": srow["plain_ms"],
         "library_ms": srow["library_ms"], "bound_ms": srow["bound_ms"],
         "bound_by": srow["bound_by"],
         "timed": "B=5 x 12 heads, N=257, hd=64, bf16 (device time, CUDA "
                  "graph)"}]
    return {"kernels": [
        {"name": "cosine_score_tile (top-k mode, merge folded)",
         "route": "cuda", "source": src, "replaces": replaces,
         "launches": (launches["score_topk"]
                      + sweep["topk_launches"]["score_topk"]
                      + mesh_topk["score_topk"] + led["score_topk"]
                      + dom1["score_topk"]),
         "domain_launches": dom1["score_topk"],
         "bf16_store": {"timed": "top-5, B=16, 200000x512 bf16 mirror",
                        "mirror_bytes": bf16["mirror_bytes"],
                        "float32_mirror_bytes":
                            domains["mirror"]["float32"]["mirror_bytes"],
                        **bf16["b16_k5"]},
         "wide_store": {"timed": "top-5, B=16, 20000x4096 f32", **wide},
         "sweep_epoch_launches": sweep["topk_launches"]["score_topk"],
         "mesh_launches": mesh_topk["score_topk"],
         "leader_launches": led["score_topk"],
         "max_abs_err": tile["max_abs_err"],
         "partial_max_abs_err": tile["partial_max_abs_err"],
         "ms": tile["kernel_ms"], "device_ms": tile["device_ms"],
         "plain_ms": tile["plain_ms"],
         "library_ms": stages["library_topk_b16_k5"],
         "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
         "topk_device_ms": {key: kern["times"][key]["device_ms"]
                            for key in ("topk_b1_k5", "topk_b16_k5")},
         "stream_memory": {"timed": "cosine_topk, B=1, k=3, 300 of 1024 "
                                    "rows x 512 f32 (a stream's memory)",
                           "launches": streams["counts"]["cosine_score_topk"],
                           **sk["cosine"]},
         "timed": "top-5, B=16, 200000x512 f32, one launch (tile pass and "
                  "the last block's merge); device_ms from CUDA-graph "
                  "replay"},
        {"name": "cosine_select", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/topk_select.cu",
         "replaces": replaces,
         "replaces_in_jax": "vidgraph_tpu/ops/topk_cosine.py:132 "
                            "(_masked_topk's lax.top_k)",
         "launches": (launches["select"] + sweep["topk_launches"]["select"]
                      + mesh_topk["select"] + led["select"] + dom1["select"]),
         "domain_launches": dom1["select"],
         "max_abs_err": sel["max_abs_err"], "ms": sel["kernel_ms"],
         "device_ms": sel["device_ms"], "plain_ms": sel["plain_ms"],
         "library_ms": sel["library_ms"], "bound_ms": sel["bound_ms"],
         "bound_by": sel["bound_by"], "k1000": stages["select_b16_k1000"],
         "timed": "top-100 of the dense scores [16, 199937], bit-equal to "
                  "select_ref (the stable sort); device_ms from CUDA-graph "
                  "replay; library torch.topk"},
        {"name": "cosine_score_tile (dense mode)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": launches["score_dense"] + dom1["score_dense"],
         "domain_launches": dom1["score_dense"],
         "large_k": {"timed": "top-1000, B=16, 200000x512 f32: the dense "
                              "scores and the selection", **big_k},
         "max_abs_err": kern["score_err"], "ms": dense["kernel_ms"],
         "plain_ms": dense["plain_ms"], "library_ms": lib["dense_b16"],
         "device_ms": dense["device_ms"],
         **bound(store_bytes + 16 * STORE_ROWS * 4, score_ops, F32_FLOPS),
         "timed": "dense scores, B=16, 200000x512 f32"},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vidgraph_tpu/models/captioner.py:165",
         "launches": (chat["kg"]["flash"] + chat["benchmark"]["flash"]
                      + sum(c["flash"] for c in vision_counts)
                      + inst["flash_fwd"] + mid["flash_fwd"]
                      + judge["flash_launches"] + mesh_flash
                      + led["flash"]),
         "judge_agreement_launches": judge["flash_launches"],
         "mesh_launches": mesh_flash,
         "leader_launches": led["flash"],
         "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
         "lse_max_abs_err": max(r["lse_err"] for r in bwd_rows.values()),
         "train_ms": brow["fwd_lse_ms"],
         "train_bound_ms": brow["bound"]["fwd"]["bound_ms"],
         "train_timed": "with the log-sum-exp written; " + bwd_timed,
         "ms": b32["kernel_ms"], "plain_ms": b32["plain_ms"],
         "library_ms": b32["library_ms"],
         "library_backends": b32["library_backends"],
         "library_kernels": b32["library_kernels"],
         **bound(4 * 32 * t * 8 * 64 * 2, 4.0 * 32 * 8 * 64 * pairs,
                 BF16_FLOPS),
         "stream_prefill": {"launches": streams["counts"]["flash"],
                            **sk["flash"]},
         "timed": "b=32, T=2056, 8 heads x 64, bf16, nv=8"},
        {"name": "preprocess_frames", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/preprocess.cu",
         "replaces": "vidgraph_tpu/ops/preprocess.py:30",
         "redesigned": "a block a band of up to 8 output rows, its "
                       "source rows staged once by bulk copies, the height "
                       "pass in fp16 mma.sync, the width pass on "
                       "neighbouring outputs, two blocks an SM",
         "b160_ms": pre["b160_405x720_fast"]["kernel_ms"],
         "b160_bound_ms": pre["b160_405x720_fast"]["bound_ms"],
         "stream_240x320": {"launches": streams["counts"]["preprocess"],
                            **sk["preprocess"]},
         "vit_b160_720p": {
             "launches": vit160["launches"]["preprocess"],
             **vit160["kernels"]["preprocess"]},
         "launches": (sum(c["preprocess"] for c in vision_counts)
                      + vit160["launches"]["preprocess"]
                      + led["preprocess"] + dom2),
         "domain_launches": dom2,
         "frames_8k": {"timed": "5 frames 4320x7680 uint8 -> 224 bf16, "
                                "strips of output columns", **frame8k},
         "leader_launches": led["preprocess"],
         "max_abs_err": max(r["max_abs_err"] for r in pre.values()),
         "ms": pre5["kernel_ms"], "plain_ms": pre5["plain_ms"],
         "library_ms": pre5["library_ms"], "call_ms": pre5["call_ms"],
         "bound_ms": pre5["bound_ms"], "bound_by": pre5["bound_by"],
         "timed": "5 frames 405x720 uint8 -> 224 bf16 (fast)"},
        {"name": "short_attention", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/short_attention.cu",
         "replaces": "vidgraph_tpu/ops/short_attention.py:83",
         "launches": (vision["counts"]["fused"]["short_attention"]
                      + vit160["launches"]["short_attention"]),
         "vit_b160": {"launches": vit160["launches"]["short_attention"],
                      **vit160["kernels"]["short_attention"]},
         "max_abs_err": max(r["max_abs_err"] for r in short.values()),
         "ms": short5["kernel_ms"], "plain_ms": short5["plain_ms"],
         "library_ms": short5["library_ms"],
         "library_kernels": short5["library_kernels"],
         "call_ms": short5["call_ms"],
         "bound_ms": short5["bound_ms"], "bound_by": short5["bound_by"],
         "b160_ms": short["b160"]["kernel_ms"],
         "b160_library_ms": short["b160"]["library_ms"],
         "b160_bound_ms": short["b160"]["bound_ms"],
         "timed": "B=5 x 12 heads, N=50, hd=64, bf16"},
        {"name": "q8_matmul", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "vidgraph_tpu/ops/q8_matmul.py:62",
         "redesigned": "weights and x by TMA on mbarriers, wgmma with the "
                       "int8 tile as A from registers, K split over a "
                       "cluster reduced through distributed shared "
                       "memory, one launch a product",
         "launches": sum(r["kernel"] for r in quant["launches"].values()),
         "a16p_launches_per_step": quant["a16p_launches_per_step"],
         "host_us": q8row["host_us"],
         "bf16_out_ms": q8row["kernel_bf16_out_ms"],
         "max_abs_err": q8k["max_abs_err"],
         "max_rel_err": q8k["max_rel_err"],
         "ms": q8row["kernel_ms"], "plain_ms": q8row["plain_ms"],
         "library_ms": q8row["int8pack_ms"],
         "library": "torch._weight_int8pack_mm",
         "a16_ms": q8row["a16_ms"],
         "cublas_bf16_ms": q8row["cublas_bf16_ms"],
         "bound_ms": q8row["bound_ms"], "bound_by": q8row["bound_by"],
         "rows_past_64": {"timed": "M=200 (4 slabs of at most 64 rows), "
                                   "K=2048, N=8192, direct calls",
                          "timing_launches":
                              attn["q8_timing_calls"]["q8_matmul"],
                          **q8wide},
         "timed": "M=32, K=2048, N=8192 (fc1 of CaptionerConfig.large()), "
                  "20 copies of the weights in turn"},
        {"name": "flash_bwd_delta", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site, "replaces_in_jax": jax_flash + ":273",
         "launches": inst["flash_bwd_delta"] + mid["flash_bwd_delta"],
         "max_abs_err": max(r["delta_err"] for r in bwd_rows.values()),
         "ms": brow["delta_ms"], "plain_ms": brow["plain_delta_ms"],
         "library_ms": None, **brow["bound"]["delta"], "timed": bwd_timed},
        {"name": "flash_bwd_fused", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site,
         "replaces_in_jax": jax_flash + ":1121 and :1456",
         "launches": inst["flash_bwd_fused"] + mid["flash_bwd_fused"],
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
         "max_rel_fro": max(r["rel_fro"] for r in bwd_rows.values()),
         "ms": brow["fused_ms"], "plain_ms": brow["plain_bwd_ms"],
         "library_ms": brow["library_bwd_ms"],
         "library_kernels": brow["library_kernels"],
         **brow["bound"]["fused"],
         "backward_ms": brow["bwd_ms"],
         "backward_bound_ms": brow["bound"]["bwd"]["bound_ms"],
         "timed": bwd_timed + "; dk, dv and dq (added into a float32 "
                  "accumulator) in one pass of 5 products; plain_ms and "
                  "library_ms are of the whole backward: attention_bwd_ref, "
                  "and SDPA's forward + backward less its forward; "
                  "backward_ms is delta + fused + convert"},
        {"name": "flash_bwd_dq_convert", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site, "replaces_in_jax": jax_flash + ":1456",
         "launches": (inst["flash_bwd_dq_convert"]
                      + mid["flash_bwd_dq_convert"]),
         "max_abs_err": max(r["convert_err"] for r in bwd_rows.values()),
         "ms": brow["convert_ms"], "plain_ms": brow["plain_convert_ms"],
         "library_ms": None, **brow["bound"]["convert"],
         "timed": bwd_timed + "; dq = bf16(accumulator / sqrt(hd))"},
        *general,
        {"name": "decode_attention", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/decode_attention.cu",
         "replaces": "vidgraph_tpu/models/captioner.py:326-339 (no TPU "
                     "kernel: XLA fuses the cache update and the einsums)",
         "launches": sum(p["launches"] for p in decode["paths"].values()),
         "path_launches": decode["paths"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in decode["rows"].values()),
         **{key: drow[key] for key in ("route", "kernel_host_us",
                                       "plain_host_us", "bound_ms",
                                       "bound_by")},
         "ms": drow["kernel_ms"], "plain_ms": drow["plain_ms"],
         "library_ms": drow["library_ms"], "library": "SDPA, q-length 1",
         "chat_b1_4096": decode["rows"]["chat_b1_h8_s4096_hd64"],
         "timed": "large() B 1 x 16 heads x 265 live keys x 128, bf16 "
                  "(device time, CUDA graph); chat_b1_4096: B 1 x 8 heads "
                  "x 4,096 x 64"},
    ]}


def main() -> int:
    if sys.argv[1:2] == ["--cli"]:
        return cli_with_counts(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="development: run only these of phases 14-27 "
                         "(prints no kernels record and no ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.modules["tiktoken"] = None
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    from vidgraph_tpu_torch.core.platform import describe_device, device

    card = nvidia_smi()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {json.dumps(describe_device(device()))}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({_build.library_path.name})")
    for line in _build.build_log().splitlines():
        if "entry function" in line:
            log("  ptxas:", line.split("'")[1][:160])
        elif "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    only = ({int(x) for x in args.phases.split(",")} if args.phases
            else None)
    late = {14: lambda: phase_flash_backward(args.seed, card),
            15: lambda: phase_training(args.seed, card),
            16: lambda: phase_acs(card),
            17: lambda: phase_streams(tc, args.seed, card),
            18: lambda: phase_serve(tc, args.seed, card),
            19: lambda: phase_encoders(args.seed, card),
            20: lambda: phase_encoder_trainers(args.seed, card),
            21: lambda: phase_tooling(args.seed, card),
            22: lambda: phase_mesh(tc, args.seed, card),
            23: lambda: phase_leader(tc, args.seed, card),
            24: lambda: phase_seeded(args.seed, card),
            25: lambda: phase_domains(tc, args.seed, card),
            26: lambda: phase_attention_domains(args.seed, card),
            27: lambda: phase_decode_attention(args.seed, card)}
    if only is not None and not only <= set(late):
        ap.error("--phases takes 14 to 27")
    if only is not None:
        # a partial run, for development: no kernels record, no ok line
        for number in sorted(only):
            late[number]()
        assert "jax" not in sys.modules, "the port's run imported jax"
        log(f"phases {sorted(only)} done at {time.perf_counter() - t0:.1f} s "
            f"(partial run)")
        return 0
    kern = phase_kernels(tc, args.seed, card)
    main_path = phase_main_path(tc, args.seed)
    phase_cli()
    flash = phase_flash(args.seed, card)
    chat = phase_chat_lm(args.seed)
    logits = phase_prefill_logits(args.seed)
    log(f"phases 1-8 done at {time.perf_counter() - t0:.1f} s")
    pre = phase_preprocess(args.seed, card)
    short = phase_short_attention(args.seed, card)
    vision = phase_vision(args.seed, card)
    log(f"phases 1-11 done at {time.perf_counter() - t0:.1f} s")
    q8k = phase_q8_matmul(args.seed, card)
    quant = phase_quantized(args.seed, card)
    log(f"phases 1-13 done at {time.perf_counter() - t0:.1f} s")
    bwd = late[14]()
    training = late[15]()
    acs = late[16]()
    log(f"phases 1-16 done at {time.perf_counter() - t0:.1f} s")
    streams = late[17]()
    serve = late[18]()
    encoders = late[19]()
    log(f"phases 1-19 done at {time.perf_counter() - t0:.1f} s")
    trainers = late[20]()
    tooling = late[21]()
    log(f"phases 1-21 done at {time.perf_counter() - t0:.1f} s")
    mesh = late[22]()
    log(f"phases 1-22 done at {time.perf_counter() - t0:.1f} s")
    leader = late[23]()
    log(f"phases 1-23 done at {time.perf_counter() - t0:.1f} s")
    seeded = late[24]()
    log(f"phases 1-24 done at {time.perf_counter() - t0:.1f} s")
    domains = late[25]()
    log(f"phases 1-25 done at {time.perf_counter() - t0:.1f} s")
    attn = late[26]()
    log(f"phases 1-26 done at {time.perf_counter() - t0:.1f} s")
    decode = late[27]()
    log(f"phases 1-27 done at {time.perf_counter() - t0:.1f} s")
    assert "jax" not in sys.modules, "the port's run imported jax"
    record = kernel_record(kern, main_path, flash, chat, pre, short, vision,
                           q8k, quant, bwd, training, streams, tooling,
                           mesh, leader, domains, attn, decode)
    record.update({
        "topk_b16_k5_ms": kern["times"]["topk_b16_k5"],
        "retrieval_p50_ms": main_path["p50_ms"],
        "retrieval_p95_ms": main_path["p95_ms"],
        "flash_ms": flash, "chat_lm": chat, "prefill_logits": logits,
        "preprocess_ms": pre, "short_attention_ms": short,
        "vision": vision, "q8_matmul_ms": q8k, "quantized": quant,
        "flash_backward": bwd, "training": training, "acs": acs,
        "streams": streams, "serve": serve, "encoders": encoders,
        "encoder_trainers": trainers,
        "tooling": {k: v for k, v in tooling.items() if k != "vit_b160"},
        "vit_b160": {k: v for k, v in tooling["vit_b160"].items()
                     if k != "profile"},
        "mesh": mesh, "leader": leader, "seeded": seeded,
        "domains": domains, "attention_domains": attn,
        "decode_attention": decode,
        "seconds": time.perf_counter() - t0})
    print(json.dumps(record))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
