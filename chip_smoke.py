#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skypilot_tpu_torch``) on one NVIDIA GPU.

Phases, one JSON line each; any failure exits non-zero:

1. device  — CUDA must be present; the card's name and power limit as
   ``nvidia-smi`` reports them.
2. build   — compile every CUDA kernel of the port from the sources in
   this checkout (one ``nvcc`` per source, all at once); count the
   tensor-core (HMMA) instructions of each flash kernel in its SASS
   (``cuobjdump``): the twelve bf16 bodies (K4, K3, K5a, K5b at d 64,
   128 and 256) must have them, no CUDA-core flash body is compiled for
   bf16, and no flash kernel spills registers (``ptxas -v``).
3. kernel_check — each kernel against its plain PyTorch version on the
   card, at the main paths' geometries (llama2-7b, GQA 32/8, d 64,
   d 256, gemma-2b's 8/1 heads at d 256, qwen2-7b's 28/4 heads at
   d 128, a group of 7, and llama3-70b's 64/8 heads at d 128), with the
   tolerance stated: K1
   (``paged_decode``) on bf16/fp32 pools and on int8 and int4 code
   pools, K2 (``paged_decode_fused``) on all four with ring_len 0, 1
   and H read from device memory; K4 (``flash_fwd``) causal at sq 64, 256 and 2048 and full
   attention, K3 (``flash_fwd_chunk``) at sq 64 and 256 against 64, 512
   and 1792 cache rows with cache lengths 0, mid and full, then again
   with the cache rows past each cache length poisoned (1e4); K5a
   (``flash_bwd_dkv``) and K5b (``flash_bwd_dq``) at d 64, 128 and 256,
   groups 1, 4 and 8, causal at sq 100 and 300 and full at 100 x 300,
   bf16 and fp32, and bf16 at the gemma-2b and qwen2-7b geometries.
   bf16 flash kernels run on the tensor cores, fp32 on the CUDA cores
   (``impl`` on each line); each K4/K5 line also carries
   ``sdpa_err``, the same error measure for
   ``scaled_dot_product_attention`` (forward, or its backward) against
   the same plain version, as the yardstick of what a library kernel
   gives. autograd_check — ``attention(impl='flash')`` backward (K4,
   K5a, K5b) against autograd through the plain forward at the
   llama3-1b training shape.
4. kernel_time — K1/K2 at llama2-7b decode (batch 8, context 1024), K4
   and K3 at the 7B prefill shapes the slot engine serves and at a long
   shape, K4, K5a and K5b at the llama3-1b training shape (batch 8, seq
   2048, 32/8 heads, d 64) and at the 7B shape (1 x 2048, 32/32, d 128),
   each beside its bound (bytes over the memory rate, operations over
   the peak for their operands' type), the plain version's time and one
   PyTorch library call's time (K5: the backward of
   ``scaled_dot_product_attention``). A kernel's ``ms`` is CUDA events
   around back-to-back wrapper calls, the larger of the wrapper's host
   time and the device time; ``device_ms`` is the kernel's own device
   time a launch from ``torch.profiler`` (CUDA events where the profiler
   shows none, ``device_ms_source``); ``host_us`` is the wrapper's host
   time a call (a host clock around the calls, no synchronise). weight_path — one decode step's
   weight matmuls at batch 8 with bf16 weights and with int8 codes
   (which ``qeinsum`` widens to bf16 per call), in turns.
   kv_probe — K6 (``paged_decode_all_layers``), the KV bandwidth probe:
   all 32 layers' cache partials of llama2-7b's pool at the serve shape
   (8 slots at context 1024) in one launch, for bf16, int8 and int4
   pools in turn (each freed before the next); K6 against its plain
   version and bit for bit against 32 K1 launches, and timed beside its
   bound, the 32 K1 launches, the plain version and one SDPA call over
   all layers' gathered bf16 rows. w8a8_check — the W8A8 prefill
   products at llama2-7b's widths (wq 4096 x 4096, w1 4096 x 11008, w2
   11008 x 4096), int8 codes column-major and per-channel int4, bf16
   activations at 5, 16, 17 and 2048 rows: ``int8_matmul``
   (``torch._int_mm``) equal to the int32 product, ``qeinsum`` inside
   ``w8a8_region`` equal bit for bit to the plain version (fp32 and
   bf16 outputs), the relative error against W8A16 stated, W8A16 decode
   rows on row- and column-major codes compared; at 2048 rows the
   product's time beside W8A16, row-major codes, the bare int8 GEMM, the
   row quantizer and one bf16 ``torch.matmul``.
5. serve   — ``ModelServer('llama2-7b')`` (bf16 random weights from a
   seed, full width) answering concurrent ``/v1/completions`` and
   ``/generate`` requests; K1 launches, TTFT, TPOT, tok/s, peak memory;
   the kernel path's layer attention against the plain path's.
6. serve_slot — the same weights and requests through
   ``ModelServer(kv_cache='slot')``: chunked prefill on K4 (first
   chunks) and K3 (chunks against the cache), no paged kernel.
7. serve_int8 — ``quantize='int8'``: int8 weights quantized on the
   card, int8 paged KV, K1 on int8 codes.
8. decode_variants — two engines over the same int8 weights: int4 KV
   through K1, and int8 KV through K2 (``decode_impl='cross_layer'``).
   serve_w8a8 — the ``serve_int8`` weights and requests behind a paged
   server with ``prefill_w8a8`` (K1 decode, the int8 GEMM 7 x 32 times
   a prefill call): TTFT, TPOT and tok/s beside ``serve_int8``'s, one
   served prefill call's device time with the region off and on in
   turns, and the share of tokens equal to ``serve_int8``'s (not
   asserted). w8a8_slot — the same weights behind the slot server with
   ``prefill_w8a8`` and a bf16 cache: K4 and K3 under the region, TTFT
   beside ``serve_slot``'s.
   decode_graphs — the compiled decode program (every decode step of
   every engine is a CUDA graph replay): on llama2-7b at full width
   with the 8 requests prefilled, the engine's graph replay against an
   eager call of the module's step function from the same state
   (tokens, ring rows and pool bytes equal bit for bit) at horizons 1,
   8 and 32 for K1 on bf16, at 1 and 8 for K1 on int8 and int4 pools,
   K2 on int8 and the gather path on bf16 (``reduced``: the time
   limit); for K1 bf16 at horizons 1 and 8, one decode
   call's ms a step eager and replayed with the device's idle share of
   each (torch.profiler),
   capture seconds a key and the graphs' pool. serve_pinned — the
   ``serve`` requests through ``ModelServer(decode_steps_per_call=4)``.
   decode_audit — ``audit_multistep(4)`` and the engine audit of both
   engines at llama2-7b's width, depth cut to 2, under the sync debug
   mode: no unsanctioned sync, no capture in steady state, two
   dispatches a round at horizon 4. Every serve line carries the
   engine's ``decode_calls``, ``graph_captures``, ``graph_replays``,
   ``graph_capture_s`` and ``graph_pool_gb``.
   serve_spec, serve_spec_fused, serve_slot_spec — speculative decoding
   (``speculate_k=4``; fused: 4 rounds a call; slot: the slot engine,
   whose verify rounds run K3 at sq = 5) on the ``serve`` weights at
   CUT_LAYERS of the 32 layers (for the time limit), the
   8 requests with spec prompts (each a random 16-token segment
   repeated to its length), then the same requests at
   ``speculate_k=0`` in the same phase to compare against: TTFT, TPOT,
   tok/s, accept rate, tokens a round, captures, replays, graph pool,
   the share of ``/generate`` tokens equal to the vanilla stream
   (bf16: no identity is asserted), and a replayed call's ms and
   device idle share beside the vanilla replayed decode call's.
   spec_check — at llama2-7b's width, depth 2 (``reduced``): the fp32
   greedy speculative stream equals the vanilla one on both engines,
   single and fused; a replayed verify call equals the eager round bit
   for bit on bf16, int8 and int4 paged pools and a bf16 slot cache;
   K3 at sq = 5 against its plain version. spec_audit —
   ``audit_engine(speculate_k=4)`` on both engines and
   ``audit_spec_multistep(4, 4)`` at the same width and depth: no
   unsanctioned sync, no steady-state capture, one sanctioned sync a
   dispatch, one fused dispatch per 4 rounds.
   kv_handoff — KV handoff on llama2-7b at full width (the ``serve``
   weights), paged, 64-page pools: bf16, int8 and int4 on K1 and int8
   on K2. One engine serves the 8 prompts uninterrupted; a second seats
   them, decodes 4 tokens, exports every request (one sanctioned
   readback each), sends it through the SKKV codec and cancels it; the
   first, idle again, ingests them and runs them out: each stream equal
   to its uninterrupted one bit for bit, no graph captured, K1/K2 once
   per layer per decode step; export ms, wire bytes and ingest ms a
   request. kv_handoff_slot — the same on the slot engine (max_seq
   1024; K4/K3 in the source's prefill). kv_checkpoint — server A
   serves 8 prompts sharing a 512-token prefix one by one, writes its
   checkpoint through ``POST /checkpoint {"path"}`` and stops; server B
   warm-boots from the file and serves them again: prefix hits on every
   prompt, streams equal to A's, cold against warm TTFT. kv_audit —
   ``audit_handoff`` at 7B width, depth 2: the decode after an ingest or
   a warm-up replays the warm-up's graphs with no unsanctioned sync.
   The serving front, on the ``serve`` weights, each server on a fresh
   process registry: serve_sched — the SLO scheduler on the paged
   engine (K1): 8 throughput-tier requests (512-1024-token prompts,
   128 new tokens) at once, then 4 latency-tier requests (32-64 tokens,
   16 new) at 0.25 s intervals into the backlog, all streamed (half of
   SCHED_TP and SCHED_LAT: ``reduced``); per tier
   TTFT p50/p90, queue wait and TPOT from ``/metrics?format=json`` and
   per kind the client TTFT and TPOT, beside the same requests with
   every one in the throughput tier; every request brings its count and
   the latency tier admits all of its own. serve_sched_slot — the same
   at a quarter of the counts on the slot engine (K4/K3 prefill), at
   CUT_LAYERS (8) of the 32 layers, for the time limit.
   sched_shed — ``max_queue_tokens=2048`` and 28 requests of 128 work
   tokens at once (both halved: ``reduced``): every refusal a 429 with an integer ``Retry-After`` >= 1,
   ``skytpu_sched_shed_total`` in the Prometheus text equal to the
   429s, every refused request completing when sent again after its
   ``Retry-After``. sched_drain — 8 streamed requests in flight, then
   ``POST /drain``: all finish, a new submit gets 503 + ``Retry-After``,
   ``/readiness`` says ``draining``, the checkpoint lands in
   ``checkpoint_path``, and a server warm-booted from it hits the shared
   prefix on every prompt. disagg_relay — a decode-role and a
   prefill-role server on the one card: the 8 prompts one by one through
   the prefill server (non-streamed ``/v1/completions`` and streamed
   ``/generate``) equal the decode server's own streams bit for bit,
   ``sent == completed == 8``, and with the decode server stopped a
   request falls back to local decoding (``fallback_local``).
   telemetry_audit — ``audit_telemetry_parity`` on both engines at 7B
   width, depth 2 (0 unsanctioned syncs, 0 steady-state captures,
   equal streams with telemetry off and on), and telemetry_tpot — the
   ``serve`` requests with telemetry on, then off.
   Multi-tenant serving, on the ``serve`` weights: serve_lora — five
   rank-8 adapters written from the seed into a temporary
   ``adapter_dir`` (``adapter_write``); a 4-slot bank on the paged
   engine (K1 in graphs) serves the 8 requests, two base and six over
   three adapters (one named as ``model: "llama2-7b:<name>"``), after a
   warm request loaded a fourth, with a fifth adapter's request sent
   0.3 s into the run (an eviction mid-run): loads, evictions,
   ``last_load_ms``, the bank's bytes, and TTFT and TPOT beside the same
   9 requests on a bankless server. serve_lora_slot — the same on the
   slot engine (K4/K3 prefill). lora_check — bf16 at full depth on both
   engines: a mixed batch's base rows equal a bankless engine's bit for
   bit, every adapter row moves, an adapter loaded after the capture
   into an evicted slot is followed by the replayed graphs (streams
   equal a fresh engine's, no capture), and the share of adapter tokens
   equal to the offline-merged model's (no assertion); then fp32 at
   depth 2 (``reduced``): logits against the merged model's within
   1e-3 and 16 greedy tokens equal on both engines. grammar_check — a
   ``"json"`` and a token-id grammar beside an unconstrained request,
   both engines, speculation off and at k = 4: every token inside its
   mask. lora_audit — ``audit_adapters`` (depth 2, both engines, k 0
   and 4): adapter churn with masks live, no capture, no unsanctioned
   sync.
   fault_watchdog — on the ``serve`` weights, a paged server with a 5 s
   step watchdog and a ``wedged_step`` injected at ``engine_step`` #3:
   /readiness turns to a 503 ``degraded``, the stream in flight ends in
   a retryable error, a new submit gets 503 + ``Retry-After``,
   ``skytpu_gray_failures_total{kind="wedged_step"}`` reads 1, no graph
   is captured and no step runs after the wedge, and the watchdog
   detects it within (5.0, 6.9] s of the wedge's stamp (the largest
   healthy step of every serve phase beside it); then a fresh server
   with ``nan_logits`` at ``engine_step`` #2 under 4 concurrent streams:
   exactly one is evicted with a retryable non-finite error, the others
   complete, the replica stays ready and serves on. Live card memory
   before and after both servers (a growth above 67 MB adds the new
   blocks of ``torch.cuda.memory_snapshot()``).
   serve_mesh1 — the serving mesh's path (``parallel/mesh.py``) on a
   one-rank NCCL mesh: llama2-7b bf16 at full width and depth on the
   paged engine through K1, the 8 prompts x N_NEW tokens, the pool
   sized explicitly: its streams equal a meshless engine's bit for bit
   (a one-rank all-reduce and all-gather are copies), the census of one
   replayed decode step equals the expected one (an all-reduce after
   ``wo`` and after ``w_down`` per layer, one logits all-gather: the
   NCCL calls were captured in the decode graphs), the pool is its own
   contiguous tensor, and ``serving_mesh(tp=2)`` raises on one card;
   the line carries the NCCL version, captures and replays, K1
   launches and both engines' TPOT. ``multi_card: false``: the machine
   has one card, and NCCL refuses two ranks on one GPU.
   serve_gang — multi-host gang serving's replicated plane on the one
   card (``serve/gang.py``): rank 0 a ``ModelServer`` on llama2-7b
   bf16 at full width and depth (paged, ``decode_impl`` auto: K1,
   random weights from the seed), rank 1 a separate ``python -m
   skypilot_tpu_torch.serve.server --gang-rank 1`` process under the
   launch-env contract with the same engine on the same card; the 8
   requests through rank 0. The line carries the join seconds, each
   rank's K1 launches (rank 1's from its exit summary), whether the
   digests of every finished request are equal (all must be), the
   drain acked by both ranks, a ``gang_member_crash`` on rank 1 of a
   tiny second gang (cause ``heartbeat_lost`` within the heartbeat
   bound + 2 s) and K1 through the replicated kv-head layout
   (``mesh.kv_head_layout``) against the plain version at 64 q / 8 kv
   (tp 16, rank 5) and 6 q / 3 kv (tp 2, rank 1). A mesh gang across
   cards, replicated kv heads at tp > 1 and dp-split prefill need
   several mesh ranks, and NCCL refuses two ranks on one GPU: held on
   the CPU only.
   serve_mesh1_opts — the serving options on the same one-rank NCCL
   mesh, each case on the weights already on the card and held bit for
   bit against a meshless engine with the same params and options (4
   of serve's prompts x 16 new tokens): 'bank' (llama2-7b bf16 at 8 of
   32 layers, ``reduced``, paged, K1, a bank of two adapters, two base
   rows) and 'spec_slot' (the slot
   engine at speculate_k 4: K3 at sq 5 once a layer a round, the
   rounds' commits and accepted counts the meshless engine's) after
   serve_mesh1; 'w8a8' (serve_int8's weights at 8 of 32 layers,
   ``reduced``, with prefill_w8a8, K1 int8, the int8 GEMM; one
   prefill's logits equal and its census with a MAX all-reduce before
   each row-parallel product) after w8a8_slot; 'moe' (mixtral-8x7b
   int8 at 4 of 32 layers, ``reduced``, K1 int8) after serve_moe. Each line carries the census of the last replayed decode
   step and merge (or verify round) beside ``audit.expected_census``,
   its launches and the card label; ``serving_mesh(tp=2)`` must still
   raise on one card.
   costmodel_check — the cost model against the card (after the bf16
   ``decode_graphs``, then on the int8 weights after the int8 ones): a
   llama2-7b paged engine (K1) with the 8 requests seated takes one
   decode call of horizon 1; the call, captured as the audits capture
   it, is priced on meta copies of the engine. The line carries the
   step's floor (stored weights once, the embedding's gathered rows,
   the live KV) and its traced bytes by class, the device-busy ms of
   one replayed call (torch.profiler), the floor's share of that time
   at 3.35e12 B/s and the traced bytes over it (at most 105% of that
   rate, else the count is at fault), ``kv_static_check`` against the
   engine's ``skytpu_kv_read_bytes_per_step`` gauge, and
   ``roofline_step_bytes`` at batch 8 and context 400 (bf16: the weight
   floor within 1% of 13.23 GB). The pool's bytes are priced at each
   slot's pages up to its length, as the engine staged the lengths.
   audit_presets — the default audit presets (``audit.DEFAULT_PRESETS``,
   less its multi-device presets: their meshes need a card per rank)
   through ``run_preset`` on the card with the ``@cuda`` byte budget
   armed: each must be ``ok()`` (no unsanctioned sync, no capture, no
   host read or float64 in its priced programs, reads within budget),
   and a preset with no ``@cuda`` budget fails. The time limit skips the
   nine whose audit an earlier phase runs (AUDIT_PRESETS_SKIPPED,
   ``reduced``).
9. reference — a small fp32 model served on the card (kernel paths) and
   on the CPU (plain paths) from the same weights gives the same greedy
   tokens: the paged engine for bf16, int8 and int4 KV, the slot engine
   chunked and monolithic.
10. train — ``Trainer.fit`` trains ``llama3-1b`` at full width (bf16,
    remat 'block', fp32 Adam mu, random weights from the seed) on batch
    8 x seq 2048 from ``packed_batches`` over a seeded corpus for 6
    steps: finite and falling loss, K4 twice and K5a/K5b once per layer
    per step, no other kernel; step time, tok/s, FLOP rate and its share
    of the bf16 peak, peak memory, the share of the step in K4 + K5.
11. train_reference — a small fp32 model (head_dim 64) trained 3 steps
    on the card (K4, K5a, K5b) and on the CPU (plain paths) from the
    same params: losses and grad norms agree. train_mesh1 — the training
    mesh's step (``Trainer(mesh=make_mesh(MeshSpec()))``: a one-rank
    NCCL mesh, so every collective of the sharded step is a copy, the
    vocab-parallel cross-entropy and the global-norm clip) on llama3-1b
    at full width, bf16, depth cut to 4 of 16 (``reduced``), 2 steps
    beside the same steps meshless on the same batch: loss and grad norm
    of step 1 within 1e-5, later steps within 2e-3, the params' rms
    difference within 0.1 of the meshless update's rms (the largest
    difference and its count stated); K4 twice and K5a/K5b once a layer a
    step; the collective census. seq_parallel — ring attention (zigzag
    and contiguous, causal) and Ulysses at sp 4 through the lock-step
    runner (every rank's blocks in this process) at llama3-8b's widths
    (32/8 heads, d 128, bf16) over a whole sequence of 8192 (2048 a
    rank): outputs against K4 over the whole sequence and the plain
    version, q/k/v gradients against the whole sequence's K5a/K5b (each
    error read as the difference's rms over the tensor's and as the
    worst token's max over that token's rms, limits about three times
    the readings), K4
    (and K5a/K5b, the block backward) launches equal to the count
    ``ring_block_calls`` predicts. Both lines say what one card cannot
    show: several ranks, NCCL collective times, fsdp/tp/sp/pp across
    cards, pipeline bubbles.
12. serve_ckpt — gemma-2b (2.51B parameters: tied, sqrt(dim)-scaled
    embeddings, x * (1 + w) norms, GeGLU, 8/1 heads at d 256) written
    at full width, depth cut to 9 of 18 layers (``reduced``), by the
    port's ``synth.py`` into a temporary directory
    (``checkpoint_write``: bytes, seconds; depth cut further only when
    the disk is short), served by ``ModelServer(model_path=...)``
    on the paged engine with bf16 KV and K1 (``decode_impl='pallas'``),
    the same 8 requests as ``serve``: load seconds, K1 launches and the
    split plans they ran (the context must be split), TTFT, TPOT,
    tok/s, peak memory; then ``serve_ckpt_slot`` (the slot engine: K4
    and K3 at d 256, group 8).
13. serve_ckpt_int8 — ``quantize='int8'`` from the same directory
    twice: host quantization writes the int8 cache, the second load
    maps it; the leaves must be equal bit for bit, 4 requests each.
14. train_ckpt — ``Trainer.init_from_pretrained`` on the directory, 2
    steps at batch 2 x seq 2048 (K4, K5a, K5b at d 256, group 8):
    finite losses, the tied ``embed`` gradient non-zero on rows of
    tokens absent from the batch, peak memory; the directory is then
    deleted.
15. serve_qwen2 — qwen2-7b (7.6B parameters, q/k/v biases, 28/4 heads:
    group 7) written at full width, depth cut to 8 of 28 layers
    (``reduced``), served on the paged engine with bf16 KV through K1.
16. moe_int4_check — one mixtral-8x7b MoE layer (``moe.moe_ffn``, int8
    experts, bf16, at 8 and 64 tokens) and llama3-70b's int4 weight
    product (``quantization.qeinsum`` on a ``QuantizedWeight4``, per
    channel and with groups of 128) on the card against the same
    functions on the CPU.
17. serve_moe — mixtral-8x7b at full width, 8 of 32 layers (dim
    4096, 32/8 heads, 8 experts top-2, ffn 14336, vocab 32000): int8
    weights built on the card one layer slice at a time from the seed
    (the full bf16 tree, 93 GB, would not fit), int8 paged KV through K1, the
    same 8 requests as ``serve``.
18. serve_int4 — llama3-70b at full width (dim
    8192, 64/8 heads, ffn 28672, vocab 128256): int4 weights with
    per-channel scales built the same way, int4 paged KV through K1,
    the same requests; the line carries the packed weight bytes. Depth
    cut to 20 of 80 layers for the time limit (BIG_SERVE_LAYERS,
    ``reduced``), as serve_moe's to 8 of 32.
19. train_moe — mixtral-8x7b at full width, depth cut to 2 (``reduced``
    on the line: AdamW state for 32 layers does not fit one card), bf16,
    remat 'block', batch 2 x 2048, 3 steps at lr 1e-5: finite losses
    that do not rise, finite
    ``moe_aux_loss``, non-zero router and expert gradients, K4 twice and
    K5a/K5b once per layer per step; step time, tok/s, ``mfu`` from the
    active parameters, peak memory.
20. lora_train — LoRA fine-tuning of llama3-8b at full width and depth
    (32 layers, dim 4096, 32/8 heads, d 128, vocab 128256): a bf16 base
    from the seed, rank-16 adapters (alpha 32) on q, k, v and o, remat
    'block', 6 steps (10 before a cut for time) of ``Trainer.fit`` on one
    repeated 2 x 2048 batch:
    every base leaf bit for bit its copy from before training (in pinned
    host memory, compared as bytes), every ``b`` factor moved, the loss falling; step
    time, tok/s, ``mfu``, peak memory, K4/K5a/K5b launches a step,
    adapter and optimizer bytes. lora_remat — the same model under
    'block', 'attn' and 'dots', 2 steps each (5 before cuts for time):
    peak memory, step time,
    K4 launches a step (L under 'attn', 2L otherwise); at depth 2
    (``reduced``) one ``value_and_grad`` under each policy equals
    'none' bit for bit. lora_serve — the trained adapter written by
    ``multilora.save_adapter`` into a temporary ``adapter_dir`` and
    served on a paged llama3-8b engine with a bank (K1 in graphs) beside
    base rows: the base rows equal a bankless engine's bit for bit, the
    share of adapter tokens equal to the merged model's is reported;
    fp32 at depth 2: logits within 1e-3 of the merged model's and greedy
    tokens equal on both engines. lora_cli — ``python -m
    skypilot_tpu_torch.train``'s ``main`` with ``--lora-rank 16
    --adapter-out`` at depth 2 on a seeded corpus: train, resume from
    ``LATEST``, load the adapter back.
The ``reference`` phase (9) also serves small fp32 Gemma- and
Qwen2-family models (head_dim 64, random non-zero norms and biases), a
4-expert top-2 MoE at ``moe_capacity_factor`` 0.5 (decode drops
choices) and an int4-weight model (``quantize='int4'``, int4 KV) from a
checkpoint directory on the card and on the CPU: greedy tokens equal on
the paged (K1) and slot (K4, K3) engines.

Then the ``kernels`` line (K3's entry also times the long shape, K4's,
K5a's and K5b's the training shapes of llama3-1b and llama3-8b and the
7B shape, under ``times_by_shape``) and, last, ``{"ok": true,
"device": ...}``.
Every launch count in the ``kernels`` line is from a main-path phase
(5-8, 10, 17-19, ``serve_slot_spec`` for K3 at sq = 5, ``kv_probe``
for K6, ``kv_handoff``, ``kv_handoff_slot`` and ``kv_checkpoint``, and
``serve_sched``, ``serve_sched_slot``, ``sched_shed``, ``sched_drain``,
``disagg_relay``, ``serve_lora`` and ``serve_lora_slot``, and
``lora_train``, ``lora_remat`` and ``lora_serve``, ``serve_w8a8``,
``w8a8_slot``, ``fault_watchdog``, ``serve_mesh1``,
``serve_mesh1_opts`` and ``serve_gang``, rank 0's and rank 1's,
``train_mesh1`` and ``seq_parallel``),
with the counts set to 0 just before each; ``launches_by_path`` splits a kernel's count by
phase. The time limit cut ``kv_handoff``, ``kv_checkpoint``,
``sched_drain``, ``disagg_relay``, ``serve_sched_slot``, ``serve_spec``,
``serve_spec_fused``, ``serve_slot_spec`` and ``lora_check``'s bf16
part to CUT_LAYERS (8) of llama2-7b's 32 layers (``reduced`` on their
lines), serve_moe to 8 of 32 and serve_int4 to 20 of 80
(BIG_SERVE_LAYERS); qwen2-7b's checkpoint is written by a child process
while the gemma-2b checkpoint phases run; ``serve_lora_slot`` runs no
bankless baseline (``serve_slot`` holds the slot engine without a
bank). Launches made to compare or time a kernel do not count.
Phases 12-15 report their own launches on their own lines.
K4's count adds its paths (slot prefill and every training phase).

Run with no arguments: ``python3 chip_smoke.py``. Imports nothing of
JAX and nothing of the ``skypilot_tpu`` package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BW_BYTES_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# Peak operation rates (H100 SXM data sheet, dense) by operand type:
# fp32 outside the tensor cores (the fp32 kernels and the decode kernels
# K1/K2, whose work is fp32 CUDA-core arithmetic), and bf16 on the
# tensor cores (the flash kernels' bf16 matmuls).
FLOP_PEAKS = {'fp32_cuda_cores': 67e12, 'bf16_tensor_cores': 989e12}
INT8_PEAK = 1979e12           # int8 tensor cores, dense (same data sheet)
TOL_OUT = 2e-3                # normalised output, max abs
TOL_PARTIAL = 2e-3            # acc and l, max abs relative to max(l, 1)
TOL_M = 1e-4                  # running max, max abs; bf16 logsumexp
TOL_FP32 = 1e-5               # fp32 flash output and logsumexp, max abs:
                              # the same fp32 sums in another order
BF16_ULP = 2.0 ** -8          # one bf16 rounding, relative: K2 writes
                              # its output in q's dtype, so a bf16 output
                              # may differ from the plain version's by
                              # one rounding on top of TOL_OUT
GEOMETRIES = [('llama2-7b', dict(hq=32, hkv=32, d=128)),
              ('gqa', dict(hq=32, hkv=8, d=128)),
              ('d64', dict(hq=32, hkv=32, d=64)),
              ('d256', dict(hq=16, hkv=16, d=256)),
              ('gemma-2b', dict(hq=8, hkv=1, d=256)),
              ('qwen2-7b', dict(hq=28, hkv=4, d=128)),   # group 7
              ('llama3-70b', dict(hq=64, hkv=8, d=128))]
# Geometries whose K1/K2 checks also run fp32 queries (fp32, int8 and
# int4 pools).
FP32_GEOMETRIES = ('llama2-7b', 'gemma-2b', 'qwen2-7b')
RING_H = 8                    # ring rows of the K2 checks and timing


_T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since
    the script started, and ``cuda_alloc_gb``, the card memory held by
    live tensors when it was printed, so a run shows where its time and
    its memory went."""
    if 'phase' in obj:
        obj = {**obj, 't_s': round(time.monotonic() - _T0, 1)}
        torch = sys.modules.get('torch')
        if torch is not None and torch.cuda.is_initialized():
            obj['cuda_alloc_gb'] = round(torch.cuda.memory_allocated() / 1e9,
                                         3)
    print(json.dumps(obj), flush=True)


def _release(torch) -> None:
    """Free what the phase let go of: engines, servers and trainers hold
    reference cycles (CUDA graphs, callbacks, threads' closures) that
    only the cycle collector reclaims, so their card memory would
    otherwise stay allocated until some later collection, and the next
    full-width model would not fit."""
    gc.collect()
    torch.cuda.empty_cache()


class SmokeError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# --------------------------------------------------------------------- 1
def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {'phase': 'device', 'nvidia_smi': smi,
            'name': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit(info)
    return info


# --------------------------------------------------------------------- 2
def _cuobjdump():
    """The toolkit's ``cuobjdump`` (PATH, $CUDA_HOME, /usr/local/cuda)."""
    import shutil
    found = shutil.which('cuobjdump')
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        cand = os.path.join(root or '', 'bin', 'cuobjdump')
        if not found and root and os.path.exists(cand):
            found = cand
    require(found is not None, 'cuobjdump not found')
    return found


def _kernel_label(mangled):
    """'flash_fwd_kernel_tc<64>' or 'flash_fwd_kernel<bf16,128,chunk>'
    from a mangled kernel name (anonymous namespace, plain templates)."""
    import re
    m = re.search(r'\d+(flash_\w*?kernel(?:_tc)?)I(.*?)EEvNS_4ArgsE', mangled)
    if m is None:
        return mangled
    args = (m.group(2).replace('13__nv_bfloat16', 'bf16,')
            .replace('Lb1E', 'chunk,').replace('Lb0E', ''))
    args = re.sub(r'^f(?=L)', 'fp32,', args)
    args = re.sub(r'Li(\d+)E?', r'\1,', args).strip(',')
    return f'{m.group(1)}<{args}>'


def _sass_hmma(lib_path):
    """Tensor-core (HMMA) instructions per kernel in a library's SASS."""
    out = subprocess.run([_cuobjdump(), '--dump-sass', lib_path],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if 'Function :' in line:
            fn = _kernel_label(line.split('Function :')[1].strip())
            counts[fn] = 0
        elif fn is not None and 'HMMA' in line:
            counts[fn] += 1
    return counts


def phase_build():
    from skypilot_tpu_torch.ops import _build
    for name in _build.SOURCES:      # built anew: the report is this run's
        if os.path.exists(_build.library_path(name)):
            os.unlink(_build.library_path(name))
    t0 = time.monotonic()
    paths = _build.build_all()
    hmma = {name: _sass_hmma(_build.library_path(name))
            for name in ('flash_fwd', 'flash_bwd')}
    # K4, K3, K5a and K5b at d 64, 128 and 256: twelve bf16 bodies.
    tc = {k: n for lib in hmma.values() for k, n in lib.items()
          if '_tc<' in k}
    require(len(tc) == 12 and all(n > 0 for n in tc.values()),
            f'bf16 flash bodies without tensor-core instructions: {tc}')
    cuda_core_bf16 = [k for lib in hmma.values() for k in lib
                      if any(f'{body}<bf16' in k for body in (
                          'flash_fwd_kernel', 'flash_bwd_dkv_kernel',
                          'flash_bwd_dq_kernel'))]
    require(not cuda_core_bf16,
            f'CUDA-core flash bodies compiled for bf16: {cuda_core_bf16}')
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if 'registers' in ln]
            for name, log in _build.build_logs.items()}
    spills = {k: sum(' 0 bytes spill stores' not in ln
                     for ln in log.splitlines() if 'spill stores' in ln)
              for k, log in _build.build_logs.items()}
    emit({'phase': 'build', 'seconds': round(time.monotonic() - t0, 3),
          'libraries': [os.path.relpath(p) for p in paths],
          'ptxas_register_lines': {k: len(v) for k, v in regs.items()},
          'ptxas_max_registers': {
              k: max((int(ln.split('Used ')[1].split(' registers')[0])
                      for ln in v if 'Used ' in ln), default=None)
              for k, v in regs.items()},
          'ptxas_spills': spills, 'sass_hmma_by_kernel': hmma})
    require(spills['flash_fwd'] == 0 and spills['flash_bwd'] == 0,
            f'flash kernels spill registers: {spills}')


# --------------------------------------------------------------------- 3
def _cuda_ms(torch, fn, n_iter, n_warm=3):
    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def _profiled_device_ms(torch, fn, n_iter, kernel):
    """The device time a launch of the kernels whose name holds
    ``kernel``, from ``torch.profiler``'s ``key_averages()`` over
    ``n_iter`` calls of ``fn`` (one launch each); None when the profiler
    shows no device time or not exactly ``n_iter`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us = getattr(ev, 'self_device_time_total', None)
            if us is None:
                us = getattr(ev, 'self_cuda_time_total', 0.0)
            total_us += us
            launches += ev.count
    if total_us <= 0 or launches != n_iter:
        return None
    return total_us / 1e3 / launches


def _kernel_ms(torch, fn, n_iter, kernel, n_warm=3):
    """A kernel's times over ``n_iter`` calls of its wrapper: ``ms``,
    CUDA events around back-to-back calls (the larger of the wrapper's
    host time and the device time); ``device_ms``, the kernel's own
    device time a launch from the profiler (``device_ms_source``
    'profiler'), or ``ms`` again where the profiler shows no device time
    ('cuda_events'); ``host_us``, the wrapper's host time a call, by a
    host clock around the calls without a synchronise."""
    ms = _cuda_ms(torch, fn, n_iter, n_warm)
    t0 = time.perf_counter()
    for i in range(n_iter):
        fn(i)
    host_us = (time.perf_counter() - t0) / n_iter * 1e6
    torch.cuda.synchronize()
    device_ms = _profiled_device_ms(torch, fn, n_iter, kernel)
    return {'ms': ms, 'device_ms': ms if device_ms is None else device_ms,
            'device_ms_source': ('cuda_events' if device_ms is None
                                 else 'profiler'),
            'host_us': host_us}


def _make_paged_inputs(torch, *, slots, hq, hkv, d, page, P, lengths,
                       L, dtype, seed, kind=None):
    """q, pools (K and V), scales (None for bf16/fp32 pools), table and
    lengths on the card. ``kind`` 'int8'/'int4' quantizes random rows
    with the port's own row quantizers, as the engine writes them."""
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device='cuda').manual_seed(seed)
    n_pages = slots * P + 1
    shape = (L, n_pages, hkv, page, d)
    pools, scales = [], []
    for _ in range(2):
        rows = torch.randn(shape, generator=gen, device='cuda')
        if kind in ('int8', 'int4'):
            quant = (llama.quantize_kv_rows if kind == 'int8'
                     else llama.quantize_kv_rows4)
            codes, sc = quant(rows)
            pools.append(codes)
            scales.append(sc[..., 0].contiguous())
        else:
            pools.append(rows.to(dtype))
            scales.append(None)
        del rows
    q = torch.randn((slots, hq, d), generator=gen, device='cuda').to(dtype)
    # Distinct pages per slot, page 0 reserved (engine style).
    perm = torch.randperm(n_pages - 1, generator=gen, device='cuda') + 1
    table = perm[:slots * P].reshape(slots, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return (q, pools[0], pools[1], scales[0], scales[1], table.contiguous(),
            lens)


def _ring_inputs(torch, slots, hkv, d, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    return (f(slots, hkv, d), f(slots, hkv, d), f(slots, RING_H, hkv, d),
            f(slots, RING_H, hkv, d))


def _check_k1(torch, pa, ins):
    q, pk, pv, ks, vs, table, lens = ins
    got = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs, layer=1)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_reference(q, pk, pv, table, lens, ks,
                                               vs, layer=1)
    return _check_partial(torch, got, want, lens)


def _check_partial(torch, got, want, lens):
    """A decode partial (acc, m, l; K1 or, stacked over layers, K6)
    against its plain version: acc and l over max(l, 1), m, the output
    they normalise to, and the empty-slot sentinel."""
    (acc_k, m_k, l_k), (acc_r, m_r, l_r) = got, want
    norm = torch.clamp(l_r, min=1.0)
    err_acc = ((acc_k - acc_r).abs() / norm[..., None]).max().item()
    err_l = ((l_k - l_r).abs() / norm).max().item()
    err_m = (m_k - m_r).abs().max().item()
    live = l_r > 0
    out_k = acc_k[live] / l_k[live][:, None]
    out_r = acc_r[live] / l_r[live][:, None]
    err_out = (out_k - out_r).abs().max().item()
    empty = (lens == 0)[:, None].expand(m_k.shape)
    sentinel = bool((m_k[empty] == -1e30).all() and (l_k[empty] == 0).all()
                    and (acc_k[empty] == 0).all())
    finite = bool(torch.isfinite(acc_k).all() and torch.isfinite(l_k).all())
    ok = (err_acc <= TOL_PARTIAL and err_l <= TOL_PARTIAL
          and err_m <= TOL_M and err_out <= TOL_OUT and sentinel and finite)
    return ok, {'max_abs_err_acc_over_l': err_acc,
                'max_abs_err_l_over_l': err_l, 'max_abs_err_m': err_m,
                'max_abs_err_out': err_out, 'empty_slot_sentinel': sentinel,
                'tol_acc_l': TOL_PARTIAL, 'tol_m': TOL_M,
                'tol_out': TOL_OUT}


def _check_k2(torch, pa, ins, ring):
    q, pk, pv, ks, vs, table, lens = ins
    k_self, v_self, ring_k, ring_v = ring
    errs, excess = {}, {}
    finite = True
    rounding = BF16_ULP if q.dtype == torch.bfloat16 else 0.0
    for ring_len in (0, 1, RING_H):
        # ring_len from device memory, as a captured decode step passes
        # it (the kernel reads it at launch).
        dev_len = torch.full((), ring_len, dtype=torch.int32, device='cuda')
        got = pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, dev_len, pk, pv, table,
            lens, ks, vs, layer=1)
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_fused_reference(
            q, k_self, v_self, ring_k, ring_v, dev_len, pk, pv, table,
            lens, ks, vs, layer=1)
        finite = finite and bool(torch.isfinite(got).all())
        diff = (got.float() - want.float()).abs()
        errs[ring_len] = diff.max().item()
        excess[ring_len] = (diff - rounding * want.float().abs()).max().item()
    ok = finite and max(excess.values()) <= TOL_OUT
    return ok, {'ring_H': RING_H, 'ring_len_from': 'device_memory',
                'max_abs_err_out_by_ring_len': errs,
                'max_err_beyond_output_rounding': excess,
                'tol_out': TOL_OUT, 'output_rounding': rounding}


def phase_kernel_checks(torch, page):
    """Every kernel against its plain version at every listed geometry
    and pool kind, 8 slots with mixed lengths (0 included). Returns the
    worst normalised-output error per kernel name."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    P = 2048 // page
    full = P * page
    mixed = [0, 1, page + 72, full, 1024, 513, page, 777]
    cases = [(n, geo, torch.bfloat16, kind) for kind in ('bf16', 'int8',
                                                          'int4')
             for n, geo in GEOMETRIES]
    cases += [(f'{n}-fp32', geo, torch.float32, kind)
              for n, geo in GEOMETRIES if n in FP32_GEOMETRIES
              for kind in ('fp32', 'int8', 'int4')]
    worst = {}
    before = dict(pa.launch_counts)
    sms = pa._sm_count(torch.device('cuda', torch.cuda.current_device()))
    for name, geo, dtype, kind in cases:
        ins = _make_paged_inputs(
            torch, slots=8, page=page, P=P, lengths=mixed, L=2,
            dtype=dtype, seed=len(name) + len(kind), kind=kind, **geo)
        k1 = 'paged_decode' if kind in ('bf16', 'fp32') else \
            f'paged_decode_{kind}'
        ring = _ring_inputs(torch, 8, geo['hkv'], geo['d'], dtype,
                            seed=len(name))
        for kernel, (ok, errs) in (
                (k1, _check_k1(torch, pa, ins)),
                ('paged_decode_fused', _check_k2(torch, pa, ins, ring))):
            err = errs.get('max_abs_err_out',
                           max(errs.get('max_abs_err_out_by_ring_len',
                                        {0: 0.0}).values()))
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            emit({'phase': 'kernel_check', 'kernel': kernel, 'case': name,
                  'q_dtype': str(dtype).replace('torch.', ''),
                  'pool': kind, 'slots': 8, 'page': page, 'P': P,
                  'lengths': mixed, **geo,
                  'split_plan': pa.split_plan(8, geo['hkv'], P, page,
                                              geo['d'], sms),
                  **errs, 'ok': ok})
            require(ok, f'{kernel} disagrees with its plain version '
                        f'({name}, {kind})')
        del ins, ring
    pa.launch_counts.update(before)      # comparison launches do not count
    return worst


# --------------------------------------------------------------------- 4
CTX, SLOTS, LT = 1024, 8, 8    # timing shape: batch 8, context 1024,
                               # 8 pool layers cycled so reads are cold


def _bound(bytes_moved, flops, peak='fp32_cuda_cores'):
    """(bound_ms, 'bytes' | 'operations'): the larger of the bytes over
    the memory rate and the operations over ``FLOP_PEAKS[peak]``."""
    t_bytes, t_ops = bytes_moved / BW_BYTES_S, flops / FLOP_PEAKS[peak]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def _gathered_bf16(torch, pool, scale, li, table, hkv, d):
    """One layer's pages of every slot as contiguous [slots, hkv, ctx, d]
    bf16, dequantized for code pools (the SDPA yardstick's operand)."""
    from skypilot_tpu_torch.models.quantization import unpack_int4
    g = pool[li][table.long()]                    # [slots, P, hkv, page, d']
    if g.dtype == torch.uint8:
        g = unpack_int4(g, axis=-1)
    g = g.float() if scale is not None else g
    if scale is not None:
        g = g * scale[li][table.long()][..., None]
    return (g.permute(0, 2, 1, 3, 4).reshape(SLOTS, hkv, CTX, d)
            .to(torch.bfloat16).contiguous())


def phase_kernel_times(torch, page):
    """Each kernel timed at the llama2-7b decode shape, beside its bound
    (from this call's inputs), its plain version and one SDPA call."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    hq = hkv = 32
    d = 128
    Pt = CTX // page
    before = dict(pa.launch_counts)
    results = {}
    for kind in ('bf16', 'int8', 'int4'):
        ins = _make_paged_inputs(
            torch, slots=SLOTS, hq=hq, hkv=hkv, d=d, page=page, P=Pt,
            lengths=[CTX] * SLOTS, L=LT, dtype=torch.bfloat16, seed=7,
            kind=kind)
        q, pk, pv, ks, vs, table, lens = ins
        k_self, v_self, ring_k, ring_v = _ring_inputs(torch, SLOTS, hkv, d,
                                                      torch.bfloat16, 9)
        n_rows = SLOTS * CTX
        row_bytes = {'bf16': 2 * d, 'int8': d + 4, 'int4': d // 2 + 4}[kind]
        kv_bytes = 2 * n_rows * hkv * row_bytes            # codes + scales
        small = table.numel() * 4 + SLOTS * 4 + SLOTS * hq * d * 2   # q
        flops = 4 * n_rows * hq * d                        # q.k and p.v
        ksv = [_gathered_bf16(torch, pk, ks, li, table, hkv, d)
               for li in range(LT)]
        vsv = [_gathered_bf16(torch, pv, vs, li, table, hkv, d)
               for li in range(LT)]
        q4 = q[:, :, None, :]
        library_k1 = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksv[i % LT], vsv[i % LT]), 80)
        name = 'paged_decode' if kind == 'bf16' else f'paged_decode_{kind}'
        times = _kernel_ms(torch, lambda i: pa.paged_decode_attention(
            q, pk, pv, table, lens, ks, vs, layer=i % LT), 80,
            'paged_decode_kernel')
        plain = _cuda_ms(torch, lambda i: pa.paged_decode_attention_reference(
            q, pk, pv, table, lens, ks, vs, layer=i % LT), 5, n_warm=1)
        b = kv_bytes + small + SLOTS * hq * (d + 2) * 4    # + acc, m, l
        bound_ms, bound_by = _bound(b, flops)
        results[name] = {**times, 'plain_ms': plain,
                         'library_ms': library_k1, 'bound_ms': bound_ms,
                         'bound_by': bound_by, 'bytes': b, 'flops': flops}
        # K2 on the same pool: the page loop plus RING_H ring rows (the
        # count in device memory, as the decode step passes it), the
        # current token and a bf16 output.
        ring_len = RING_H
        dev_len = torch.full((), ring_len, dtype=torch.int32, device='cuda')
        ksf = [torch.cat([ksv[li], ring_k.permute(0, 2, 1, 3),
                          k_self[:, :, None]], 2) for li in range(LT)]
        vsf = [torch.cat([vsv[li], ring_v.permute(0, 2, 1, 3),
                          v_self[:, :, None]], 2) for li in range(LT)]
        del ksv, vsv
        library_k2 = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksf[i % LT], vsf[i % LT]), 80)
        del ksf, vsf
        times2 = _kernel_ms(torch, lambda i: pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, dev_len, pk, pv, table,
            lens, ks, vs, layer=i % LT), 80, 'paged_decode_kernel')
        plain2 = _cuda_ms(torch, lambda i: (
            pa.paged_decode_attention_fused_reference(
                q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
                lens, ks, vs, layer=i % LT)), 5, n_warm=1)
        b2 = (kv_bytes + small + 2 * SLOTS * (ring_len + 1) * hkv * d * 2
              + SLOTS * hq * d * 2)
        flops2 = 4 * SLOTS * (CTX + ring_len + 1) * hq * d
        bound2, by2 = _bound(b2, flops2)
        results[f'paged_decode_fused[{kind}]'] = {
            **times2, 'plain_ms': plain2, 'library_ms': library_k2,
            'bound_ms': bound2, 'bound_by': by2, 'bytes': b2,
            'flops': flops2}
        del ins, q, pk, pv, ks, vs
        _release(torch)
    pa.launch_counts.update(before)      # timing launches do not count
    for name, r in results.items():
        emit({'phase': 'kernel_time', 'kernel': name,
              'shape': {'slots': SLOTS, 'hq': hq, 'hkv': hkv, 'd': d,
                        'page': page, 'context': CTX, 'q_dtype': 'bfloat16',
                        'ring_len': RING_H if 'fused' in name else None},
              **r, 'flop_peak': 'fp32_cuda_cores',
              'achieved_gb_s': r['bytes'] / (r['ms'] * 1e-3) / 1e9,
              'roofline_share': r['bound_ms'] / r['ms']})
    return results


# ------------------------------------------------------------ 3, 4: K3/K4
FLASH_CASES = ((2, 64, 64, True), (2, 256, 256, True), (1, 2048, 2048, True),
               (2, 64, 300, False))          # (b, sq, skv, causal) for K4
FLASH_CHUNKS = ((64, 64), (64, 512), (64, 1792), (256, 64), (256, 512),
                (256, 1792))                 # (sq, cache rows) for K3
POISON = 1e4                  # K3: stale cache rows past cache_len


def _flash_inputs(torch, b, sq, skv, hq, hkv, d, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    return f(b, sq, hq, d), f(b, skv, hkv, d), f(b, skv, hkv, d)


def _flash_impl(dtype):
    """Which body a flash kernel (K3, K4, K5a, K5b) runs for operands of
    ``dtype``: bf16 on the tensor cores, fp32 on the CUDA cores."""
    return 'tensor_core' if str(dtype).endswith('bfloat16') else 'cuda_core'


def phase_flash_checks(torch):
    """K4 and K3 against their plain versions at every listed geometry
    (bf16; the 7B geometry in fp32 too), held against the plain
    version's fp32 output: a bf16 output may differ from it by one bf16
    rounding (at most BF16_ULP of the value) on top of TOL_OUT. (Against
    the plain version's own bf16 output the two roundings of two fp32
    sums in another order can land one ulp apart, up to 2 x BF16_ULP of
    the value: a one-ulp flip at |out| 1.14 measured 0.0034 beyond the
    allowance on an H100.) Returns the worst output error per kernel
    name."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    cases = [(n, geo, torch.bfloat16) for n, geo in GEOMETRIES]
    cases.append(('llama2-7b-fp32', GEOMETRIES[0][1], torch.float32))
    worst = {'flash_fwd': 0.0, 'flash_fwd_chunk': 0.0}
    before = dict(fa.launch_counts)

    def judge(kernel, name, dtype, got, want, line, lse_err=None,
              sdpa=None):
        bf16 = dtype == torch.bfloat16
        rounding = BF16_ULP if bf16 else 0.0
        tol_out, tol_lse = (TOL_OUT, TOL_M) if bf16 else (TOL_FP32, TOL_FP32)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - rounding * want.float().abs()).max().item()
        ok = (bool(torch.isfinite(got).all()) and excess <= tol_out
              and (lse_err is None or lse_err <= tol_lse))
        worst[kernel] = max(worst[kernel], err)
        emit({'phase': 'kernel_check', 'kernel': kernel, 'case': name,
              'q_dtype': str(dtype).replace('torch.', ''),
              'impl': _flash_impl(dtype), **line,
              'max_abs_err_out': err,
              'max_err_beyond_output_rounding': excess,
              'max_abs_err_lse': lse_err, 'tol_out': tol_out,
              'output_rounding': rounding,
              'tol_lse': tol_lse if lse_err is not None else None,
              'sdpa_err': None if sdpa is None else (
                  (sdpa.float() - want.float()).abs()
                  - rounding * want.float().abs()).max().item(),
              'ok': ok})
        require(ok, f'{kernel} disagrees with its plain version ({name}, '
                    f'{line})')

    for name, geo, dtype in cases:
        for b, sq, skv, causal in FLASH_CASES:
            q, k, v = _flash_inputs(torch, b, sq, skv, dtype=dtype, seed=sq,
                                    **geo)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            # The plain version's fp32 output (its math on fp32 copies of
            # the same inputs, before the final rounding to q's dtype):
            # a bf16 output is then one rounding away from it.
            want, want_lse = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal)
            sdpa = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal,
                enable_gqa=True).transpose(1, 2)
            judge('flash_fwd', name, dtype, out, want,
                  {'b': b, 'sq': sq, 'skv': skv, 'causal': causal, **geo},
                  (lse - want_lse).abs().max().item(), sdpa)
            del q, k, v, out, lse, want, want_lse, sdpa
        for sq, split in FLASH_CHUNKS:
            q, k, v = _flash_inputs(torch, 3, sq, split + sq, dtype=dtype,
                                    seed=split, **geo)
            lens = [0, split // 2 + 1, split]
            cl = torch.tensor(lens, dtype=torch.int32, device='cuda')
            # Then again with the cache rows past each row's cache_len
            # set to POISON: a kernel that reads them unmasked, or masks
            # the wrong rows, lands far beyond the tolerance.
            for poison in (None, POISON):
                if poison is not None:
                    for row, n in enumerate(lens):
                        k[row, n:split] = poison
                        v[row, n:split] = poison
                out = fa.flash_attention(q, k, v, cache_len=cl,
                                         kv_split=split)
                torch.cuda.synchronize()
                want = fa.flash_chunk_reference(q.float(), k.float(),
                                                v.float(), cl, split)
                judge('flash_fwd_chunk', name, dtype, out, want,
                      {'b': 3, 'sq': sq, 'kv_split': split,
                       'cache_len': lens, 'poison_past_cache_len': poison,
                       **geo})
            del q, k, v, out, want
    _release(torch)
    fa.launch_counts.update(before)      # comparison launches do not count
    return worst


FLASH_SETS = 4     # input sets cycled while timing, so reads are not
                   # served from the 50 MB L2 (each set is 25-67 MB)


def phase_flash_times(torch):
    """K4 and K3 timed at llama2-7b (hq = hkv = 32, d 128, bf16): the
    prefill shapes the slot engine serves (K4: a wave of 4 first chunks
    of 256; K3: 2 chunks of 256 against 256 cache rows) and a long shape
    (K4: one 2048-token prompt; K3: a chunk of 256 against 1792 rows),
    each beside its bound from this call's inputs (bf16 operands: the
    tensor-core peak), its plain version and one SDPA call (K3: with an
    explicit boolean mask over the concatenated kv); K3 also at a
    speculative verify round's shape (8 slots, k + 1 = 5 query rows
    against a 1024-row bucket holding the served prompts' lengths)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    hq = hkv = 32
    d = 128
    el = 2                                       # bf16 bytes
    before = dict(fa.launch_counts)
    results = {}
    for kernel, label, b, sq, split in (
            ('flash_fwd', 'served', 4, 256, 0),
            ('flash_fwd', 'long', 1, 2048, 0),
            ('flash_fwd_chunk', 'served', 2, 256, 256),
            ('flash_fwd_chunk', 'long', 1, 256, 1792),
            ('flash_fwd_chunk', 'verify', 8, SPEC_K + 1, 1024)):
        sets = [_flash_inputs(torch, b, sq, split + sq, hq, hkv, d,
                              torch.bfloat16, seed=11 + i)
                for i in range(FLASH_SETS)]
        lib = [tuple(t.transpose(1, 2).contiguous() for t in st)
               for st in sets]
        qkv_bytes = 2 * b * sq * hq * d * el             # q read, out written
        if kernel == 'flash_fwd':
            def run(i):
                return fa.flash_attention_fwd(*sets[i % FLASH_SETS])

            def plain(i):
                return fa.flash_attention_reference(*sets[i % FLASH_SETS])

            def library(i):
                return F.scaled_dot_product_attention(*lib[i % FLASH_SETS],
                                                      is_causal=True)
            pairs = b * hq * sq * (sq + 1) // 2
            moved = qkv_bytes + 2 * b * sq * hkv * d * el + b * hq * sq * 4
            lens = None
        else:
            lens = PROMPT_LENS if label == 'verify' else [split] * b
            cl = torch.tensor(lens, dtype=torch.int32, device='cuda')

            def run(i):
                q, k, v = sets[i % FLASH_SETS]
                return fa.flash_chunk_attention(
                    q, k[:, split:], v[:, split:], k[:, :split],
                    v[:, :split], cl)

            def plain(i):
                return fa.flash_chunk_reference(*sets[i % FLASH_SETS], cl,
                                                split)
            j = torch.arange(split + sq, device='cuda')
            qp = torch.arange(sq, device='cuda')[:, None]
            mask = torch.where(j < split, j < cl[:, None, None, None],
                               (j - split) <= qp)        # [b, 1, sq, skv]

            def library(i):
                return F.scaled_dot_product_attention(*lib[i % FLASH_SETS],
                                                      attn_mask=mask)
            pairs = hq * sum(sq * c + sq * (sq + 1) // 2 for c in lens)
            moved = (qkv_bytes + 2 * sum(lens) * hkv * d * el
                     + 2 * b * sq * hkv * d * el)
        flops = 4 * d * pairs                            # q.k and p.v
        times = _kernel_ms(torch, run, 40, 'flash_fwd_kernel')
        ms = times['ms']
        plain_ms = _cuda_ms(torch, plain, 4, n_warm=1)
        library_ms = _cuda_ms(torch, library, 40)
        bound_ms, bound_by = _bound(moved, flops, 'bf16_tensor_cores')
        r = {**times, 'plain_ms': plain_ms, 'library_ms': library_ms,
             'bound_ms': bound_ms, 'bound_by': bound_by, 'bytes': moved,
             'flops': flops}
        results[(kernel, label)] = r
        emit({'phase': 'kernel_time', 'kernel': kernel, 'shape_kind': label,
              'shape': {'b': b, 'sq': sq, 'cache_rows': split or None,
                        'cache_len': lens, 'hq': hq, 'hkv': hkv, 'd': d,
                        'q_dtype': 'bfloat16'},
              **r, 'flop_peak': 'bf16_tensor_cores',
              'achieved_tflop_s': flops / (ms * 1e-3) / 1e12,
              'achieved_gb_s': moved / (ms * 1e-3) / 1e9,
              'roofline_share': bound_ms / ms})
        del sets, lib
        _release(torch)
    fa.launch_counts.update(before)      # timing launches do not count
    fa.chunk_launches_by_sq.clear()
    return results


# ------------------------------------------------------------ 3, 4: K5
BWD_GEOMETRIES = [(d, g) for d in (64, 128, 256) for g in (1, 4, 8)]
BWD_SHAPES = ((2, 100, 100, True), (1, 300, 300, True),
              (2, 100, 300, False))          # (b, sq, skv, causal)
TOL_BWD = 2e-5                # element by element, times max(1, max |grad|):
                              # fp32 sums over up to 4 x 2048 rows in another
                              # order err with the size of their terms; bf16
                              # gradients get one bf16 ulp of the element on
                              # top (2 x BF16_ULP): both sides round the fp32
                              # gradient, and a rounding boundary between
                              # them flips one ulp
TOL_AUTOGRAD = 1e-2           # bf16 gradients of the K4/K5 Function against
                              # autograd through the plain forward, over
                              # max(1, |grad|): the kernels' delta is taken
                              # from the bf16-rounded output (2^-9 relative
                              # per element, as the reference's is), on top
                              # of one bf16 rounding of each gradient
TRAIN_ATTN = dict(b=8, sq=2048, hq=32, hkv=8, d=64)     # llama3-1b, batch 8
BIG_ATTN = dict(b=1, sq=2048, hq=32, hkv=32, d=128)     # llama2-7b, one row
LORA_ATTN = dict(b=2, sq=2048, hq=32, hkv=8, d=128)     # llama3-8b, batch 2


def _grad_err(got, want, rounding):
    """(max abs error, worst absolute error beyond ``rounding`` x |want|
    element by element, max |want|)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return (diff.max().item(), (diff - rounding * mag).max().item(),
            mag.max().item())


def _bwd_cases():
    """(dtype name, b, sq, skv, hq, hkv, d, causal) of every K5 check:
    each (head_dim, group) of BWD_GEOMETRIES (2 kv heads, 1 for group 8)
    at every BWD_SHAPES entry in fp32 and bf16, the gemma-2b and
    qwen2-7b geometries (bf16) at the same shapes, then the training
    shape and the 7B shape (bf16, causal) that the timed runs and the
    train phase launch."""
    for name in ('float32', 'bfloat16'):
        for d, g in BWD_GEOMETRIES:
            hkv = 1 if g == 8 else 2
            for b, sq, skv, causal in BWD_SHAPES:
                yield name, b, sq, skv, g * hkv, hkv, d, causal
    for name, geo in GEOMETRIES[-2:]:        # gemma-2b, qwen2-7b (group 7)
        for b, sq, skv, causal in BWD_SHAPES:
            yield ('bfloat16', b, sq, skv, geo['hq'], geo['hkv'], geo['d'],
                   causal)
    for t in (TRAIN_ATTN, BIG_ATTN):
        yield ('bfloat16', t['b'], t['sq'], t['sq'], t['hq'], t['hkv'],
               t['d'], True)


def phase_flash_bwd_checks(torch):
    """K5a and K5b against the plain backward, from K4's own out and
    lse, at every case of ``_bwd_cases``: every gradient element within
    TOL_BWD x max(1, max |grad|) (beyond one bf16 ulp of it for bf16).
    Returns the worst absolute error per kernel name."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    worst = {'flash_bwd_dkv': 0.0, 'flash_bwd_dq': 0.0}
    before = dict(fa.launch_counts)
    for name, b, sq, skv, hq, hkv, d, causal in _bwd_cases():
        dtype = getattr(torch, name)
        rounding = 2 * BF16_ULP if dtype == torch.bfloat16 else 0.0
        q, k, v = _flash_inputs(torch, b, sq, skv, hq, hkv, d, dtype,
                                seed=sq + d + hq // hkv)
        do = _flash_inputs(torch, b, sq, sq, hq, hq, d, dtype,
                           seed=skv + d)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.attention_delta(out, do)
        got = {'flash_bwd_dkv': fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal=causal),
               'flash_bwd_dq': (fa.flash_attention_bwd_dq(
                   q, k, v, do, lse, delta, causal=causal),)}
        torch.cuda.synchronize()
        dq, dk, dv = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal)
        want = {'flash_bwd_dkv': (dk, dv), 'flash_bwd_dq': (dq,)}
        sq_, sk_, sv_ = _sdpa_grads(torch, q, k, v, do, causal)
        sdpa = {'flash_bwd_dkv': (sk_, sv_), 'flash_bwd_dq': (sq_,)}
        for kernel, grads in got.items():
            errs = [_grad_err(a, w, rounding)
                    for a, w in zip(grads, want[kernel])]
            sdpa_err = max(_grad_err(a, w, rounding)[1]
                           for a, w in zip(sdpa[kernel], want[kernel]))
            err = max(e[0] for e in errs)
            excess = max(e[1] for e in errs)
            tol = TOL_BWD * max(1.0, max(e[2] for e in errs))
            ok = (excess <= tol and all(
                bool(torch.isfinite(a).all()) for a in grads))
            worst[kernel] = max(worst[kernel], err)
            emit({'phase': 'kernel_check', 'kernel': kernel,
                  'q_dtype': name, 'impl': _flash_impl(name),
                  'b': b, 'sq': sq, 'skv': skv,
                  'causal': causal, 'hq': hq, 'hkv': hkv, 'd': d,
                  'max_abs_err': err, 'max_err_beyond_rounding': excess,
                  'max_abs_grad': max(e[2] for e in errs),
                  'tol_abs': tol, 'output_rounding': rounding,
                  'sdpa_err': sdpa_err, 'ok': ok})
            require(ok, f'{kernel} disagrees with its plain version '
                        f'(d {d}, {hq}/{hkv} heads, {b}x{sq}x{skv}, '
                        f'causal {causal}, {name})')
        del q, k, v, do, out, lse, delta, got, want, dq, dk, dv, sdpa
        _release(torch)
    fa.launch_counts.update(before)      # comparison launches do not count
    return worst


def _sdpa_grads(torch, q, k, v, do, causal):
    """(dq, dk, dv) of ``scaled_dot_product_attention`` (GQA) on the
    same inputs, in the model layout: the library yardstick of the
    backward checks."""
    import torch.nn.functional as F
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    return tuple(g.transpose(1, 2) for g in torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2)))


def phase_autograd_check(torch):
    """``attention(impl='flash')`` (the K4/K5 autograd Function) against
    ``torch.autograd`` through the plain forward at the training shape,
    bf16: one K4, one K5a and one K5b launch, gradients within
    TOL_AUTOGRAD of max(1, max |grad|). A check of the Function's
    plumbing; the kernels are held element by element at this shape in
    ``phase_flash_bwd_checks``."""
    from skypilot_tpu_torch.ops import attention as at
    from skypilot_tpu_torch.ops import flash_attention as fa
    t = TRAIN_ATTN
    q, k, v = (x.requires_grad_(True) for x in _flash_inputs(
        torch, t['b'], t['sq'], t['sq'], t['hq'], t['hkv'], t['d'],
        torch.bfloat16, seed=21))
    do = _flash_inputs(torch, t['b'], t['sq'], t['sq'], t['hq'], t['hq'],
                       t['d'], torch.bfloat16, seed=22)[0]
    before = dict(fa.launch_counts)
    got = torch.autograd.grad(at.attention(q, k, v, impl='flash'),
                              (q, k, v), do)
    torch.cuda.synchronize()
    launched = {key: fa.launch_counts[key] - before[key]
                for key in ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq')}
    fa.launch_counts.update(before)      # a comparison, not a main path
    want = torch.autograd.grad(
        fa.flash_attention_reference(q, k, v, causal=True)[0], (q, k, v), do)
    errs = {}
    for n, g, w in zip(('dq', 'dk', 'dv'), got, want):
        err, excess, mag = _grad_err(g, w, BF16_ULP)
        errs[n] = (err, excess / max(1.0, mag))
    ok = (all(e[1] <= TOL_AUTOGRAD for e in errs.values())
          and all(n == 1 for n in launched.values())
          and all(bool(torch.isfinite(g).all()) for g in got))
    emit({'phase': 'autograd_check', 'shape': TRAIN_ATTN,
          'q_dtype': 'bfloat16', 'launches': launched,
          'max_abs_err': {n: e[0] for n, e in errs.items()},
          'max_err_beyond_rounding_over_max_grad': {n: e[1] for n, e
                                                    in errs.items()},
          'tol': TOL_AUTOGRAD, 'ok': ok})
    require(ok, f'flash autograd disagrees with autograd through the plain '
                f'forward: {errs}, launches {launched}')
    del q, k, v, do, got, want
    _release(torch)


def _sdpa_backward(torch, F, q, k, v, do):
    """A closure timing one backward of ``scaled_dot_product_attention``
    (causal, GQA) on [b, h, s, d] copies of the operands."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)

    def run(_):
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return run


def phase_flash_bwd_times(torch):
    """K4, K5a and K5b at the training shape, the 7B shape and the
    llama3-8b LoRA training shape (bf16, causal), each beside its bound (bf16 operands: the tensor-core peak),
    the plain version's time (for K5: the plain backward, which computes
    dq, dk and dv together) and one library call (K4: the SDPA forward;
    K5: the SDPA backward, all three gradients)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    el = 2                                       # bf16 bytes
    before = dict(fa.launch_counts)
    results = {}
    for label, t in (('train', TRAIN_ATTN), ('7b', BIG_ATTN),
                     ('8b_train', LORA_ATTN)):
        b, s, hq, hkv, d = t['b'], t['sq'], t['hq'], t['hkv'], t['d']
        q, k, v = _flash_inputs(torch, b, s, s, hq, hkv, d, torch.bfloat16,
                                seed=31)
        do = _flash_inputs(torch, b, s, s, hq, hq, d, torch.bfloat16,
                           seed=32)[0]
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(out, do)
        pairs = b * hq * s * (s + 1) // 2
        q_bytes = b * s * hq * d * el                # q, do, out, dq each
        kv_bytes = b * s * hkv * d * el              # k, v, dk, dv each
        stats = 2 * b * hq * s * 4                   # lse and delta
        sdpa_fwd = [t_.transpose(1, 2).contiguous() for t_ in (q, k, v)]
        library_bwd = _cuda_ms(torch, _sdpa_backward(torch, F, q, k, v, do),
                               10)
        plain_bwd = _cuda_ms(torch, lambda i: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do), 2, n_warm=1)
        rows = {
            'flash_fwd': (lambda i: fa.flash_attention_fwd(q, k, v),
                          2 * q_bytes + 2 * kv_bytes + stats // 2,
                          4 * d * pairs,
                          _cuda_ms(torch, lambda i: (
                              fa.flash_attention_reference(q, k, v)), 2,
                              n_warm=1),
                          _cuda_ms(torch, lambda i: (
                              F.scaled_dot_product_attention(
                                  *sdpa_fwd, is_causal=True,
                                  enable_gqa=True)), 10)),
            'flash_bwd_dkv': (lambda i: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta), 2 * q_bytes + 4 * kv_bytes + stats,
                              8 * d * pairs, plain_bwd, library_bwd),
            'flash_bwd_dq': (lambda i: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta), 3 * q_bytes + 2 * kv_bytes + stats,
                             6 * d * pairs, plain_bwd, library_bwd)}
        for kernel, (run, moved, flops, plain_ms, library_ms) in rows.items():
            times = _kernel_ms(torch, run, 10, f'{kernel}_kernel')
            ms = times['ms']
            bound_ms, bound_by = _bound(moved, flops, 'bf16_tensor_cores')
            r = {**times, 'plain_ms': plain_ms, 'library_ms': library_ms,
                 'bound_ms': bound_ms, 'bound_by': bound_by, 'bytes': moved,
                 'flops': flops}
            results[(kernel, label)] = r
            emit({'phase': 'kernel_time', 'kernel': kernel,
                  'shape_kind': label, 'shape': dict(t, causal=True,
                                                     q_dtype='bfloat16'),
                  **r, 'flop_peak': 'bf16_tensor_cores',
                  'plain_covers': ('dq, dk and dv' if kernel != 'flash_fwd'
                                   else 'the forward'),
                  'library_covers': ('sdpa backward: dq, dk and dv'
                                     if kernel != 'flash_fwd'
                                     else 'sdpa forward'),
                  'achieved_tflop_s': flops / (ms * 1e-3) / 1e12,
                  'roofline_share': bound_ms / ms})
        del q, k, v, do, out, lse, delta, sdpa_fwd, rows
        _release(torch)
    fa.launch_counts.update(before)      # timing launches do not count
    return results


def phase_weight_path(torch):
    """The cost of the int8 weight path: one decode step's weight
    matmuls at batch 8 (one layer's seven products, timed and counted
    32 times, plus the unembed) with bf16 weights against int8 codes
    through ``qeinsum`` (which widens the codes to bf16 per call)."""
    from skypilot_tpu_torch.models import configs, quantization
    from skypilot_tpu_torch.models.quantization import qeinsum
    cfg = configs.LLAMA2_7B
    gen = torch.Generator(device='cuda').manual_seed(5)
    d, h, hd, f = cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen, device='cuda')
                * shape[0] ** -0.5).to(torch.bfloat16)
    layer = {'wq': w(1, d, h, hd), 'wk': w(1, d, h, hd),
             'wv': w(1, d, h, hd), 'wo': w(1, h, hd, d),
             'w_gate': w(1, d, f), 'w_up': w(1, d, f), 'w_down': w(1, f, d)}
    tree = {'layers': layer, 'unembed': w(d, cfg.vocab_size)}
    qtree = quantization.quantize_params(tree)
    x = torch.randn((8, 1, d), generator=gen, device='cuda').to(
        torch.bfloat16)
    xf = torch.randn((8, 1, f), generator=gen, device='cuda').to(
        torch.bfloat16)
    xo = torch.randn((8, 1, h, hd), generator=gen, device='cuda').to(
        torch.bfloat16)

    def step(t):
        lw = {k: (quantization.QuantizedWeight(v.int8[0], v.scale[0])
                  if isinstance(v, quantization.QuantizedWeight) else v[0])
              for k, v in t['layers'].items()}

        def one(_):
            for _ in range(cfg.n_layers):
                for k in ('wq', 'wk', 'wv'):
                    qeinsum('bsd,dhk->bshk', x, lw[k])
                qeinsum('bshk,hkd->bsd', xo, lw['wo'])
                qeinsum('bsd,df->bsf', x, lw['w_gate'])
                qeinsum('bsd,df->bsf', x, lw['w_up'])
                qeinsum('bsf,fd->bsd', xf, lw['w_down'])
            qeinsum('bsd,dv->bsv', x, t['unembed'], out_dtype=torch.float32)
        return one
    times = {}
    for name, t in (('bf16', tree), ('int8', qtree), ('bf16_again', tree),
                    ('int8_again', qtree)):
        times[name] = _cuda_ms(torch, step(t), 5, n_warm=2)
    emit({'phase': 'weight_path', 'model': cfg.name, 'batch': 8,
          'what': 'one decode step of weight matmuls (32 x one layer + '
                  'unembed), CUDA events',
          'step_ms': times,
          'int8_minus_bf16_ms': (times['int8'] + times['int8_again']
                                 - times['bf16'] - times['bf16_again']) / 2})
    del tree, qtree, layer
    _release(torch)


# ---------------------------------------------------------------- kv_probe
PROBE_LAYERS = 32              # llama2-7b's pool: every layer in one call


def phase_kv_probe(torch, page):
    """K6's path, the KV bandwidth probe of the reference: llama2-7b's
    paged pool at the serve shape (32 layers, 8 slots at context 1024,
    32/32 heads, d 128, page ``page``), every layer's cache partial in
    one launch, for a bf16, an int8 and an int4 pool in turn. The counts
    are set to 0 just before each probe call and read just after; then
    (not counted) K6 against its plain version at K1's tolerances and
    bit for bit against 32 K1 launches, and K6 timed beside its bound
    (one call reads every layer's pages once), the 32 K1 launches, the
    plain version and one SDPA call over all layers' gathered bf16 rows.
    Each pool is freed before the next. Returns (launches, worst output
    error, timings by kernel name)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    L, hq, hkv, d = PROBE_LAYERS, 32, 32, 128
    P = CTX // page
    launches, worst, results = 0, 0.0, {}
    before = dict(pa.launch_counts)
    for kind in ('bf16', 'int8', 'int4'):
        q1, pk, pv, ks, vs, table, lens = _make_paged_inputs(
            torch, slots=SLOTS, hq=hq, hkv=hkv, d=d, page=page, P=P,
            lengths=[CTX] * SLOTS, L=L, dtype=torch.bfloat16, seed=13,
            kind=kind)
        gen = torch.Generator(device='cuda').manual_seed(14)
        q = torch.randn((L,) + tuple(q1.shape), generator=gen,
                        device='cuda').to(torch.bfloat16)
        key = f'paged_decode_attention_all_layers[{kind}]'
        pa.reset_launch_counts()         # counts to 0 just before the path
        got = pa.paged_decode_attention_all_layers(q, pk, pv, table, lens,
                                                   ks, vs)
        torch.cuda.synchronize()
        after = dict(pa.launch_counts)
        require(after[key] == 1 and sum(after.values()) == 1,
                f'kv_probe ({kind}) launched {after}')
        launches += after[key]
        want = pa.paged_decode_attention_all_layers_reference(
            q, pk, pv, table, lens, ks, vs)
        ok, errs = _check_partial(torch, got, want, lens)
        k1 = [pa.paged_decode_attention(q[li], pk, pv, table, lens, ks, vs,
                                        layer=li) for li in range(L)]
        same = all(torch.equal(g[li], one[i]) for li, one in enumerate(k1)
                   for i, g in enumerate(got))
        del want, k1
        name = ('paged_decode_all_layers' if kind == 'bf16'
                else f'paged_decode_all_layers_{kind}')
        worst = max(worst, errs['max_abs_err_out'])
        emit({'phase': 'kernel_check', 'kernel': name, 'case': 'kv_probe',
              'q_dtype': 'bfloat16', 'pool': kind, 'layers': L,
              'slots': SLOTS, 'page': page, 'P': P, 'context': CTX,
              'hq': hq, 'hkv': hkv, 'd': d, **errs,
              'bitwise_equal_to_per_layer_k1': same, 'ok': ok and same})
        require(ok and same, f'{name} disagrees with its plain version or '
                             f'with {L} K1 launches')
        n_rows = SLOTS * CTX
        row_bytes = {'bf16': 2 * d, 'int8': d + 4, 'int4': d // 2 + 4}[kind]
        moved = (L * 2 * n_rows * hkv * row_bytes        # codes + scales
                 + table.numel() * 4 + SLOTS * 4 + q.numel() * 2
                 + L * SLOTS * hq * (d + 2) * 4)        # acc, m, l
        flops = L * 4 * n_rows * hq * d
        ksv = torch.cat([_gathered_bf16(torch, pk, ks, li, table, hkv, d)
                         for li in range(L)])           # [L * slots, ...]
        vsv = torch.cat([_gathered_bf16(torch, pv, vs, li, table, hkv, d)
                         for li in range(L)])
        q4 = q.reshape(L * SLOTS, hq, 1, d)
        library_ms = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksv, vsv), 10)
        del ksv, vsv
        times = _kernel_ms(torch, lambda i: (
            pa.paged_decode_attention_all_layers(q, pk, pv, table, lens, ks,
                                                 vs)), 20,
            'paged_decode_kernel')
        ms = times['ms']
        k1_ms = _cuda_ms(torch, lambda i: [pa.paged_decode_attention(
            q[li], pk, pv, table, lens, ks, vs, layer=li)
            for li in range(L)], 10)
        plain_ms = _cuda_ms(torch, lambda i: (
            pa.paged_decode_attention_all_layers_reference(
                q, pk, pv, table, lens, ks, vs)), 2, n_warm=1)
        bound_ms, bound_by = _bound(moved, flops)
        results[name] = {**times, 'plain_ms': plain_ms,
                         'library_ms': library_ms, 'bound_ms': bound_ms,
                         'bound_by': bound_by, 'bytes': moved,
                         'flops': flops}
        emit({'phase': 'kernel_time', 'kernel': name,
              'shape': {'layers': L, 'slots': SLOTS, 'hq': hq, 'hkv': hkv,
                        'd': d, 'page': page, 'context': CTX,
                        'q_dtype': 'bfloat16', 'pool': kind},
              **results[name], 'k1_x32_ms': k1_ms,
              'flop_peak': 'fp32_cuda_cores',
              'library_covers': 'one sdpa call over all layers, gathered '
                                'bf16 rows (gather not timed)',
              'achieved_gb_s': moved / (ms * 1e-3) / 1e9,
              'roofline_share': bound_ms / ms})
        del q1, q, q4, pk, pv, ks, vs, table, lens, got
        _release(torch)
    pa.launch_counts.update(before)      # comparison launches do not count
    emit({'phase': 'kv_probe', 'model': 'llama2-7b', 'layers': L,
          'slots': SLOTS, 'context': CTX, 'pools': ['bf16', 'int8', 'int4'],
          'kernel_launches': {'paged_decode_attention_all_layers': launches},
          'ms_by_pool': {k: r['ms'] for k, r in results.items()}})
    return launches, worst, results


# --------------------------------------------------------------------- 5
N_NEW = 32                     # new tokens per served request
PROMPT_LENS = [100, 170, 240, 310, 380, 450, 520, 600]
TOL_ATTN = 1.6e-2              # layer attention output, max abs error
                               # over max(|output|, 1): both paths round
                               # the output to bf16 (2^-8 relative) and
                               # the plain path also rounds the
                               # probabilities to bf16 before p.V


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _fresh_registry():
    """A fresh process telemetry registry, so that the next server's
    ``/metrics`` (its TTFT and TPOT medians among them) counts its own
    requests only: like the reference's, the registry is process-wide and
    a second server in the process adds to the first one's series."""
    from skypilot_tpu_torch.telemetry import registry
    registry.reset_registry()


def _post(url, body, stream):
    """POST JSON; returns (parsed result, client TTFT ms or None)."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            return json.loads(resp.read()), None
        events, ttft = [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith('data:'):
                continue
            data = line[5:].strip()
            if ttft is None:
                ttft = (time.monotonic() - t0) * 1e3
            events.append(data)
        return events, ttft


def _served_tokens(route, stream, result):
    """Token ids (or count, for text chunks) a response carries."""
    if route == '/generate':
        if stream:
            done = json.loads(result[-1])
            require(done.get('done'), f'no done event: {result[-1]}')
            return done['tokens']
        return result['tokens']
    if stream:
        require(result[-1] == '[DONE]', 'completion stream not [DONE]')
        chunks = [json.loads(e) for e in result[:-1]]
        return [c for c in chunks if c['choices'][0]['finish_reason'] is None]
    return [None] * result['usage']['completion_tokens']


def _prompts(seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, vocab, n)] for n in PROMPT_LENS]


CUT_LAYERS = 8      # depth of the kv_handoff, kv_checkpoint, sched_drain,
                    # disagg_relay, serve_sched_slot, serve_spec*,
                    # serve_slot_spec and lora_check 7B models, cut for
                    # the time limit


def _cut_7b(params):
    """llama2-7b at full width and CUT_LAYERS layers over the first
    layers of ``params`` (views: nothing is copied), with its
    ``reduced`` entry: (config, params, reduced)."""
    import dataclasses
    from skypilot_tpu_torch.models import configs
    full = configs.LLAMA2_7B
    cfg = dataclasses.replace(full, n_layers=CUT_LAYERS)
    layers = {k: v[:CUT_LAYERS] for k, v in params['layers'].items()}
    return (cfg, dict(params, layers=layers),
            {'n_layers': [full.n_layers, CUT_LAYERS],
             'why': "chip_smoke.py's time limit"})


def _attention_check(torch, eng, seed, phase):
    """Kernel path against the plain path on an engine's state: seat one
    request, prefill it, then run its first decode step's layer
    attention both ways against the same pool (layers 0 and L-1)."""
    import numpy as np
    from skypilot_tpu_torch.inference import paged
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.quantization import qeinsum
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops.attention import ring_decode_attention
    cfg = eng.cfg
    rng = np.random.default_rng(seed + 99)
    prompt = [int(t) for t in rng.integers(3, cfg.vocab_size, 700)]
    rid = eng.add_request(prompt, max_new_tokens=4)
    for _ in range(64):
        if not (eng._prefill_off or eng._queue):
            break
        eng._admit()
    require(not (eng._prefill_off or eng._queue), 'probe request not seated')
    slot = next(s for s, r in enumerate(eng._slots)
                if r is not None and r.request_id == rid)
    P = eng._pages_needed(int(eng._slot_len[slot]) + 1)
    table = torch.zeros((1, P), dtype=torch.int32, device='cuda')
    table[0, :len(eng._pages[slot][:P])] = torch.tensor(
        eng._pages[slot][:P], dtype=torch.int32)
    lengths = torch.tensor([int(eng._slot_len[slot])], dtype=torch.int32,
                           device='cuda')
    tok = eng._tok_dev[slot:slot + 1].long()[:, None]
    params = eng.params
    layer = llama.layer_params(params, 0)
    x = llama._embed_tokens(params, tok, cfg)
    h = llama.rms_norm(x, layer['attn_norm'], cfg.norm_eps,
                       cfg.norm_plus_one)
    pos = lengths.long()[:, None]
    q, k, v = (qeinsum('bsd,dhk->bshk', h, layer[w])
               for w in ('wq', 'wk', 'wv'))
    if cfg.qkv_bias:
        q, k, v = (t + layer[b].to(t.dtype)
                   for t, b in zip((q, k, v), ('bq', 'bk', 'bv')))
    q = llama.rope(q, pos, cfg.rope_theta)
    k = llama.rope(k, pos, cfg.rope_theta)
    ring = torch.zeros((1, 1, cfg.n_kv_heads, cfg.head_dim),
                       dtype=cfg.dtype, device='cuda')
    c = eng.cache
    before = dict(pa.launch_counts)
    errs, mags = [], []
    layers = (0, cfg.n_layers - 1)
    for li in layers:
        kernel_paths = {}
        part = pa.paged_decode_attention(q[:, 0], c.pool_k, c.pool_v, table,
                                         lengths, c.k_scale, c.v_scale,
                                         layer=li)
        kernel_paths['pallas'] = pa.merge_partial_with_ring_self(
            part, q, k, v, ring, ring, 0)
        kernel_paths['cross_layer'] = pa.paged_decode_attention_fused(
            q[:, 0], k[:, 0], v[:, 0], ring, ring, 0, c.pool_k, c.pool_v,
            table, lengths, c.k_scale, c.v_scale, layer=li)[:, None]
        ck, cv, sck, scv = paged._gather_layer(c, li, table)
        want = ring_decode_attention(q, k, v, ck, cv, lengths, ring, ring, 0,
                                     k_scale=sck, v_scale=scv)
        mags.append(want.float().abs().max().item())
        for impl, got in kernel_paths.items():
            err = (got.float() - want.float()).abs().max().item()
            errs.append({'layer': li, 'impl': impl, 'max_abs_err': err})
            rel = err / max(mags[-1], 1.0)
            require(rel <= TOL_ATTN and bool(torch.isfinite(got).all()),
                    f'{phase} layer {li} attention ({impl}): kernel path vs '
                    f'plain path max abs err {err} (relative {rel}) > '
                    f'{TOL_ATTN}')
    pa.launch_counts.update(before)
    emit({'phase': 'attention_check', 'of': phase, 'model': cfg.name,
          'kv_cache_dtype': eng.kv_cache_dtype,
          'context': int(lengths[0]), 'layers': list(layers),
          'errors': errs, 'max_abs_value': mags,
          'tol_over_max_abs_value': TOL_ATTN})


def _drive(port, cfg, seed, reset, prompts=None, tokens=None,
           extras=None):
    """The 8 requests (four routes, streamed and not) sent at once to the
    server on ``port`` (``_prompts`` unless ``prompts`` are given);
    ``reset`` runs just before the first is sent. Every request must
    bring back N_NEW tokens; ``tokens`` (a list) receives the token ids
    of the ``/generate`` requests in order; ``extras[i]`` (a dict) joins
    request i's body. Returns (token counts, TTFTs in ms, wall
    seconds)."""
    import threading
    routes = [('/v1/completions', False), ('/generate', True),
              ('/v1/completions', True), ('/generate', False)] * 2
    jobs = []
    for prompt, (route, stream) in zip(prompts or _prompts(
            seed, cfg.vocab_size), routes):
        body = ({'prompt': prompt, 'max_tokens': N_NEW,
                 'temperature': 0.0, 'eos_id': None}
                if route == '/v1/completions' else
                {'prompt': prompt, 'max_new_tokens': N_NEW,
                 'temperature': 0.0})
        body['stream'] = stream
        if extras is not None:
            body.update(extras[len(jobs)])
        jobs.append((route, stream, body))
    results = [None] * len(jobs)
    errors = []

    def run(i, route, stream, body):
        try:
            results[i] = _post(f'http://127.0.0.1:{port}{route}', body,
                               stream)
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'{route}: {type(e).__name__}: {e}')

    threads = [threading.Thread(target=run, args=(i,) + job)
               for i, job in enumerate(jobs)]
    reset()
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    require(not errors, f'requests failed: {errors}')
    counts, ttfts = [], []
    for (route, stream, _), (res, ttft) in zip(jobs, results):
        toks = _served_tokens(route, stream, res)
        counts.append(len(toks))
        if ttft is not None:
            ttfts.append(ttft)
        if route == '/generate':
            require(all(0 <= t < cfg.vocab_size for t in toks),
                    'token id out of range')
            if tokens is not None:
                tokens.append(list(toks))
        if route == '/generate' and not stream:
            ttfts.append(res['ttft_ms'])
    require(all(c == N_NEW for c in counts),
            f'token counts {counts}, want {N_NEW} each')
    return counts, ttfts, wall


def _serve_line(torch, phase, cfg, srv, counts, ttfts, wall, **extra):
    """The JSON line of a serve phase: latency, throughput, memory."""
    import numpy as np
    eng = srv.engine
    if srv.step_age_max_s > _HEALTHY_STEP_MAX['s']:
        _HEALTHY_STEP_MAX.update(s=srv.step_age_max_s, phase=phase)
    return {'phase': phase, 'model': cfg.name,
            'kv_cache_dtype': eng.kv_cache_dtype, 'max_batch': 8,
            'max_seq': 2048, **extra, 'requests': len(counts),
            'prompt_lens': PROMPT_LENS, 'new_tokens': counts,
            'wall_s': wall, 'ttft_ms': sorted(ttfts),
            'ttft_ms_median': float(np.median(ttfts)),
            'output_tok_s': sum(counts) / wall,
            'tpot_ms_median_server': srv.metrics_json()['tpot_ms_median'],
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'param_bytes': eng._param_bytes,
            'decode_steps_per_call': eng.decode_steps_per_call,
            'step_age_max_s': srv.step_age_max_s,
            'step_watchdog_s': srv.step_watchdog_s,
            **eng.graph_stats(),
            'kv_pool': eng.kv_pool_stats()}


def _weight_bytes_by_kind(params):
    """Stored weight bytes by leaf kind: packed int4 codes, int8 codes,
    their scales, and unquantized leaves."""
    from skypilot_tpu_torch.models.quantization import (QuantizedWeight,
                                                        QuantizedWeight4)
    out = {'int4_packed': 0, 'int8_codes': 0, 'scales': 0, 'unquantized': 0}

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, (QuantizedWeight, QuantizedWeight4)):
                kind = ('int4_packed' if isinstance(v, QuantizedWeight4)
                        else 'int8_codes')
                out[kind] += v[0].numel() * v[0].element_size()
                out['scales'] += v.scale.numel() * v.scale.element_size()
            else:
                out['unquantized'] += v.numel() * v.element_size()
    walk(params)
    return out


def _split_plans(pa, key):
    """The main path's launches of ``key`` by split plan, as
    {'<splits>x<pages per split>': launches}."""
    return {f'{s}x{pps}': n for (k, s, pps), n in
            sorted(pa.split_plan_counts.items()) if k == key}


def phase_serve(torch, seed, phase, keep_params=False, model='llama2-7b',
                want_split=False, extra=None, record=None, tokens=None,
                after_drive=None, **server_kw):
    """``model`` (llama2-7b by default; random weights from the seed, or
    the checkpoint of ``model_path=``) served end to end through the
    port's ModelServer; the decode kernel must run once per layer per
    decode step, and with ``want_split`` some launches must split the
    context. Under ``prefill_w8a8`` every prefill call launches the int8
    GEMM once per layer product, and never otherwise. ``tokens`` (a
    list) receives the ``/generate`` streams, ``after_drive(srv, eng)``
    adds fields to the line (run under the engine lock once the requests
    are done), ``record`` (a dict) receives the line. Returns the launch
    count of the expected kernel and, with ``keep_params``, the served
    weights (else None)."""
    from skypilot_tpu_torch.models import quantization as q
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer

    quantize = server_kw.get('quantize')
    kv = server_kw.get('kv_cache_dtype') or {
        'int8': 'int8', 'int4': 'int4'}.get(quantize, 'bf16')
    key = f'paged_decode_attention[{kv}]'
    torch.cuda.reset_peak_memory_stats()
    port = _free_port()
    t0 = time.monotonic()
    _fresh_registry()
    srv = ModelServer(model, max_batch=8, max_seq=2048, port=port,
                      seed=seed, **server_kw)
    srv.start(block=False)
    try:
        srv.wait_ready(timeout=600)
        ready_s = time.monotonic() - t0
        eng = srv.engine
        cfg = eng.cfg
        require(eng.decode_impl == 'pallas',
                f'decode_impl resolved to {eng.decode_impl!r}')
        require(eng.kv_cache_dtype == kv,
                f'kv_cache_dtype resolved to {eng.kv_cache_dtype!r}')
        steps0, calls0 = eng.decode_substeps, eng.decode_calls

        def reset():                     # counts to 0 just before the path
            pa.reset_launch_counts()
            fa.reset_launch_counts()
            q.reset_launch_counts()
        counts, ttfts, wall = _drive(port, cfg, seed, reset, tokens=tokens)
        counts_after = dict(pa.launch_counts)
        flash_after = dict(fa.launch_counts)
        int_mm = q.launch_counts['int_mm']
        launches = counts_after[key]
        steps = eng.decode_substeps - steps0
        calls = eng.decode_calls - calls0
        pinned = server_kw.get('decode_steps_per_call')
        require(not pinned or (calls > 0 and steps <= pinned * calls),
                f'{calls} decode calls for {steps} steps at '
                f'decode_steps_per_call={pinned}')
        require(launches == cfg.n_layers * steps and steps > 0,
                f'{key} launches {launches} != n_layers {cfg.n_layers} x '
                f'decode steps {steps}')
        require(sum(counts_after.values()) == launches
                and not any(flash_after.values()),
                f'other kernels launched on the {phase} path: '
                f'{counts_after} {flash_after}')
        plans = _split_plans(pa, key)
        require(not want_split or any(int(p.split('x')[0]) > 1
                                      for p in plans),
                f'{key} never split the context on the {phase} path: '
                f'{plans}')
        per_call = W8A8_PRODUCTS * cfg.n_layers
        if server_kw.get('prefill_w8a8'):
            require(int_mm > 0 and int_mm % per_call == 0,
                    f'{int_mm} int8 GEMMs on the {phase} path, not a '
                    f'multiple of {per_call} a prefill call')
            extra = dict(extra or {}, int_mm_launches=int_mm,
                         int_mm_per_prefill_call=per_call,
                         prefill_calls=int_mm // per_call)
        else:
            require(int_mm == 0, f'{int_mm} int8 GEMMs on the {phase} '
                    'path without prefill_w8a8')
        if after_drive is not None:
            with srv._lock:
                extra = dict(extra or {}, **after_drive(srv, eng))
        line = _serve_line(
            torch, phase, cfg, srv, counts, ttfts, wall,
            weights=quantize or 'bfloat16',
            weight_bytes_by_kind=_weight_bytes_by_kind(eng.params),
            peak_mem_limit_gb=torch.cuda.get_device_properties(
                0).total_memory / 1e9,
            page=eng.page, n_pages=eng.alloc.n_pages,
            decode_impl=eng.decode_impl, ready_s=ready_s,
            load_s=eng.load_s, decode_steps=steps, decode_calls=calls,
            kernel_launches={key: launches}, split_plans=plans,
            heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
            n_layers=cfg.n_layers, **(extra or {}))
        emit(line)
        if record is not None:
            record.update(line)
    finally:
        srv.stop()
    _attention_check(torch, eng, seed, phase)
    params = eng.params if keep_params else None
    del eng, srv
    _release(torch)
    return launches, params


# ------------------------------------------------------------- W8A8
# llama2-7b's layer products: wq (the q/k/v/o width), w1 (gate and up),
# w2 (down), each [k, n].
W8A8_SHAPES = (('wq', 4096, 4096), ('w_gate', 4096, 11008),
               ('w_down', 11008, 4096))
W8A8_ROWS = (5, 16, 17, 2048)   # below, at and above the int8 GEMM's
                                # 17-row floor, and a prefill chunk batch
W8A8_DECODE_ROWS = 8            # a decode step's rows (W8A16 layout check)
W8A8_TIMED_ROWS = 2048
W8A8_PRODUCTS = 7               # int8 GEMMs a dense layer runs: q, k, v,
                                # o, gate, up, down


def _w8a8_plain(torch, x, codes, scale):
    """The plain W8A8 product on the CPU: the rows quantized by
    ``quantize_rows`` on the host, the exact integer product (computed
    in fp64, where every partial sum of int8 x int8 over k <= 11008 is
    an integer below 2^53, so it equals the int32 product), the fp32
    epilogue on the host. Returns (fp32 output, row codes, row
    scales)."""
    from skypilot_tpu_torch.models import quantization as q
    x8, xs = q.quantize_rows(x.cpu())
    prod = (x8.to('cuda').double() @ codes.double()).cpu()
    y = prod.float() * xs
    return y * scale.cpu().reshape(-1).float(), x8, xs


def phase_w8a8_check(torch):
    """W8A8 products at llama2-7b's widths on the card, int8 weights
    (codes column-major, the layout the engines store under W8A8) and
    per-channel int4, bf16 activations, at 5, 16, 17 and 2048 rows:
    ``int8_matmul`` (``torch._int_mm``) equal to the exact int32
    product; ``qeinsum`` inside ``w8a8_region`` equal bit for bit to the
    plain version (fp32 and bf16 outputs); the relative error against
    W8A16 stated; W8A16 decode rows equal on row- and column-major
    codes; times at 2048 rows beside W8A16, row-major codes and one
    bf16 ``torch.matmul``."""
    from skypilot_tpu_torch.models import quantization as q
    g = torch.Generator(device='cuda')
    g.manual_seed(7)
    card = _card_label()
    for name, k, n in W8A8_SHAPES:
        w = torch.randn((k, n), generator=g, device='cuda',
                        dtype=torch.bfloat16) * 0.02
        i8 = q.quantize_array(w, (0,))
        row_major = i8
        leaves = {'int8': q.QuantizedWeight(
            int8=i8.int8.t().contiguous().t(), scale=i8.scale),
            'int4': q.quantize_array4(w, (0,))}
        for kind, leaf in leaves.items():
            codes = (leaf.int8 if kind == 'int8' else
                     q.unpack_int4(leaf.packed.t(), axis=1).t())
            require(codes.stride() == (1, k),
                    f'{name} {kind}: codes not column-major')
            rows = []
            for m in W8A8_ROWS:
                x = torch.randn((1, m, k), generator=g, device='cuda',
                                dtype=torch.bfloat16)
                x8, xs = q.quantize_rows(x)
                before = q.launch_counts['int_mm']
                got_int = q.int8_matmul(x8, codes)
                require(q.launch_counts['int_mm'] == before + 1,
                        f'{name} {kind} m={m}: _int_mm not launched')
                int_equal = torch.equal(got_int.double(),
                                        x8.double() @ codes.double())
                require(int_equal, f'{name} {kind} m={m}: _int_mm != the '
                        f'int32 product')
                want, want8, want_xs = _w8a8_plain(torch, x, codes,
                                                   leaf.scale)
                require(torch.equal(x8.cpu(), want8)
                        and torch.equal(xs.cpu(), want_xs),
                        f'{name} {kind} m={m}: the row quantizer differs '
                        'between the card and the CPU')
                with q.w8a8_region():
                    y32 = q.qeinsum('bsd,df->bsf', x, leaf,
                                    out_dtype=torch.float32)
                    y16 = q.qeinsum('bsd,df->bsf', x, leaf)
                eq32 = torch.equal(y32.cpu(), want)
                eq16 = torch.equal(y16.cpu().view(torch.int16),
                                   want.to(torch.bfloat16).view(torch.int16))
                require(eq32 and eq16,
                        f'{name} {kind} m={m}: W8A8 output differs from '
                        f'the plain version (fp32 {eq32}, bf16 {eq16})')
                ref = q.qeinsum('bsd,df->bsf', x, leaf,
                                out_dtype=torch.float32)
                rel = ((y32 - ref).abs().max() / ref.abs().max()).item()
                require(rel < 0.05, f'{name} {kind} m={m}: W8A8 relative '
                        f'error {rel} against W8A16')
                rows.append({'m': m, 'int_mm_equal': int_equal,
                             'fp32_bit_equal': eq32, 'bf16_bit_equal': eq16,
                             'rel_err_vs_w8a16': rel})
            line = {'phase': 'w8a8_check', 'card': card, 'weight': name,
                    'kind': kind, 'k': k, 'n': n, 'activations': 'bfloat16',
                    'rows': rows}
            x = torch.randn((1, W8A8_TIMED_ROWS, k), generator=g,
                            device='cuda', dtype=torch.bfloat16)

            def region(_, leaf=leaf, x=x):
                with q.w8a8_region():
                    q.qeinsum('bsd,df->bsf', x, leaf)
            timed = {'w8a8_ms': region,
                     'w8a16_ms': lambda _, leaf=leaf, x=x: q.qeinsum(
                         'bsd,df->bsf', x, leaf)}
            if kind == 'int8':
                x8, _ = q.quantize_rows(x)
                wb = w.contiguous()
                timed.update({
                    'w8a8_row_major_codes_ms':
                        lambda _, x=x: region(_, row_major, x),
                    'int_mm_ms': lambda _, x8=x8: torch._int_mm(
                        x8[0], codes),
                    'int_mm_row_major_codes_ms': lambda _, x8=x8:
                        torch._int_mm(x8[0], row_major.int8),
                    'quantize_rows_ms': lambda _, x=x: q.quantize_rows(x),
                    'library_bf16_matmul_ms': lambda _, x=x: torch.matmul(
                        x[0], wb)})
                # W8A16 decode rows: the same bits on either layout.
                xd = torch.randn((W8A8_DECODE_ROWS, 1, k), generator=g,
                                 device='cuda', dtype=torch.bfloat16)
                a = q.qeinsum('bsd,df->bsf', xd, leaf)
                b = q.qeinsum('bsd,df->bsf', xd, row_major)
                line['w8a16_decode_layouts_bit_equal'] = torch.equal(a, b)
                line['w8a16_decode_layouts_max_abs_diff'] = (
                    a.float() - b.float()).abs().max().item()
            before = q.launch_counts['int_mm']
            line['timed_rows'] = W8A8_TIMED_ROWS
            for key, fn in timed.items():
                line[key] = _cuda_ms(torch, fn, 10)
            q.launch_counts['int_mm'] = before
            line['int8_ops'] = 2 * W8A8_TIMED_ROWS * k * n
            line['bound_ms_int8'] = line['int8_ops'] / INT8_PEAK * 1e3
            emit(line)
    _release(torch)


# --------------------------------------------------------------------- 6
def phase_serve_slot(torch, seed, params=None, phase='serve_slot',
                     extra=None, weights='bfloat16', record=None,
                     **server_kw):
    """The bf16 7B weights of ``serve`` (or ``params``, or the checkpoint
    of ``model_path=``) behind ``ModelServer(kv_cache='slot')``, the same
    requests: every prefill call runs one flash launch per layer, K4 for
    calls without cache rows (first chunks) and K3 for chunks against
    the cache, both at least once; no paged kernel runs; under
    ``prefill_w8a8`` each prefill call also runs one int8 GEMM per layer
    product. ``record`` (a dict) receives the line. Returns the K4 and
    K3 launch counts."""
    from skypilot_tpu_torch.models import quantization as q
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer
    torch.cuda.reset_peak_memory_stats()
    port = _free_port()
    t0 = time.monotonic()
    _fresh_registry()
    srv = ModelServer('llama2-7b', max_batch=8, max_seq=2048, port=port,
                      seed=seed, params=params, kv_cache='slot',
                      **server_kw)
    srv.start(block=False)
    try:
        srv.wait_ready(timeout=600)
        ready_s = time.monotonic() - t0
        eng = srv.engine
        cfg = eng.cfg
        require(eng.chunked and eng.kv_cache_dtype == 'bf16',
                f'slot engine resolved to chunk {eng.chunk}, '
                f'{eng.kv_cache_dtype}')
        calls0 = dict(eng.prefill_calls)
        steps0, dcalls0 = eng.decode_substeps, eng.decode_calls

        def reset():                     # counts to 0 just before the path
            pa.reset_launch_counts()
            fa.reset_launch_counts()
            q.reset_launch_counts()
        counts, ttfts, wall = _drive(port, cfg, seed, reset)
        flash_after = dict(fa.launch_counts)
        paged_after = dict(pa.launch_counts)
        int_mm = q.launch_counts['int_mm']
        calls = {k: eng.prefill_calls[k] - calls0[k] for k in calls0}
        steps = eng.decode_substeps - steps0
        k4, k3 = flash_after['flash_fwd'], flash_after['flash_fwd_chunk']
        require(k4 == cfg.n_layers * calls['uncached'] and k4 > 0,
                f'K4 launches {k4} != {cfg.n_layers} x uncached prefill '
                f'calls {calls["uncached"]}')
        require(k3 == cfg.n_layers * calls['cached'] and k3 > 0,
                f'K3 launches {k3} != {cfg.n_layers} x cached prefill '
                f'calls {calls["cached"]}')
        require(not any(paged_after.values()),
                f'paged kernels launched on the slot path: {paged_after}')
        want_mm = (W8A8_PRODUCTS * cfg.n_layers * sum(calls.values())
                   if server_kw.get('prefill_w8a8') else 0)
        require(int_mm == want_mm,
                f'{int_mm} int8 GEMMs on the {phase} path, want {want_mm}')
        line = _serve_line(
            torch, phase, cfg, srv, counts, ttfts, wall, weights=weights,
            kv_cache='slot', prefill_chunk_tokens=eng.chunk,
            ready_s=ready_s, load_s=eng.load_s, decode_steps=steps,
            decode_calls=eng.decode_calls - dcalls0,
            prefill_calls=calls,
            kernel_launches=dict(flash_after, int_mm=int_mm),
            heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
            **(extra or {}))
        emit(line)
        if record is not None:
            record.update(line)
    finally:
        srv.stop()
    del eng, srv
    _release(torch)
    return k4, k3


# --------------------------------------------------------------------- 8
def phase_decode_variants(torch, seed, params):
    """Two engines over the same int8 weights at full width, 8 prompts x
    32 tokens: int4 KV through K1, int8 KV through K2. Each kernel must
    run once per layer per decode step. Returns their launch counts."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg = configs.LLAMA2_7B
    out = {}
    for kv, impl, key in (
            ('int4', 'pallas', 'paged_decode_attention[int4]'),
            ('int8', 'cross_layer', 'paged_decode_attention_fused[int8]')):
        torch.cuda.reset_peak_memory_stats()
        eng = PagedInferenceEngine(cfg, params, max_batch=8, max_seq=2048,
                                   kv_cache_dtype=kv, decode_impl=impl)
        require(eng.kv_cache_dtype == kv and eng.decode_impl == impl,
                f'engine resolved to {eng.kv_cache_dtype}/{eng.decode_impl}')
        eng.add_request([1, 2, 3], max_new_tokens=2)      # warm-up
        eng.run_to_completion(horizon=4)
        pa.reset_launch_counts()
        steps0, calls0 = eng.decode_substeps, eng.decode_calls
        t0 = time.monotonic()
        rids = [eng.add_request(p, max_new_tokens=N_NEW)
                for p in _prompts(seed + 1, cfg.vocab_size)]
        done = eng.run_to_completion(horizon=32)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts_after = dict(pa.launch_counts)
        steps = eng.decode_substeps - steps0
        toks = [done[r].output for r in rids]
        require(all(len(t) == N_NEW for t in toks),
                f'{kv}/{impl}: token counts {[len(t) for t in toks]}')
        require(all(0 <= t < cfg.vocab_size for o in toks for t in o),
                f'{kv}/{impl}: token id out of range')
        launches = counts_after[key]
        require(launches == cfg.n_layers * steps and steps > 0,
                f'{key} launches {launches} != {cfg.n_layers} x {steps}')
        require(sum(counts_after.values()) == launches,
                f'other kernels launched: {counts_after}')
        out[key] = launches
        emit({'phase': 'decode_variants', 'model': cfg.name,
              'weights': 'int8', 'kv_cache_dtype': kv, 'decode_impl': impl,
              'requests': len(rids), 'new_tokens': N_NEW,
              'decode_steps': steps, 'decode_calls': eng.decode_calls - calls0,
              'kernel_launches': {key: launches}, 'wall_s': wall,
              'output_tok_s': sum(len(t) for t in toks) / wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
              **eng.graph_stats(), 'kv_pool': eng.kv_pool_stats()})
        del eng, done
        _release(torch)
    return out


# -------------------------------------------------------------------- 8b
GRAPH_HORIZONS = (1, 8, 32)
GRAPH_TIMED_HORIZONS = (1, 8)  # decode_graphs' eager vs replay timings:
                               # the profiled eager call of 32 steps cost
                               # ~45 s of the time limit
GRAPH_N_PAGES = 40             # the check engines' pools: the 8 prompts
                               # plus 32 decode rows take 29 pages
GRAPH_REPS = {'replay': 5, 'eager': 1}     # an eager call of 32 steps: ~3 s
GRAPH_CUT_HORIZONS = (1, 8)    # the untimed cases' horizons: the eager
                               # call of 32 steps cost ~15 s of the limit
AUDIT_LAYERS = 2               # the audits run llama2-7b's width at depth 2


def _seated_engine(torch, params, seed, kv, impl):
    """A llama2-7b paged engine (``params``) with the 8 requests of the
    serve phases admitted and prefilled, ready to decode."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs
    cfg = configs.LLAMA2_7B
    eng = PagedInferenceEngine(cfg, params, max_batch=8, max_seq=2048,
                               n_pages=GRAPH_N_PAGES, kv_cache_dtype=kv,
                               decode_impl=impl)
    require(eng.kv_cache_dtype == kv and eng.decode_impl == impl,
            f'engine resolved to {eng.kv_cache_dtype}/{eng.decode_impl}')
    for p in _prompts(seed, cfg.vocab_size):
        eng.add_request(p, max_new_tokens=N_NEW)
    while eng._queue or eng._prefill_off:
        eng._admit()
    torch.cuda.synchronize()
    return eng


def _call_ms(torch, fn, reps):
    """Host clock around ``reps`` synchronised calls of ``fn`` (both
    decode paths ran from the same state just before, in the check): the
    ms a call takes end to end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _device_busy_ms(torch, fn):
    """The device's busy time during one call of ``fn``: the sum of the
    device activities (kernels, copies, fills) ``torch.profiler``
    records; None when it records none. Device activity only: tracing
    the host's ops as well costs minutes over an eager call's ~100,000
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, 'self_device_time_total', None)
            if us is None:
                us = getattr(ev, 'self_cuda_time_total', 0.0)
            total_us += us
    return total_us / 1e3 if total_us > 0 else None


def _graph_timing(torch, eng, horizon, P):
    """One decode call a step, eager (``paged_decode_horizon`` and the
    merge) against the engine's graph replays, on the state the last
    check staged; each with the device's idle share of the call."""
    from skypilot_tpu_torch.inference import paged
    buf = eng._buf

    def eager():
        _, rk, rv = paged.paged_decode_horizon(
            eng.params, eng.cache, buf.table(P), eng._tok_dev, buf.lengths,
            eng.cfg, horizon=horizon, decode_impl=eng.decode_impl)
        paged.merge_ring_into_pool(eng.cache, rk, rv, buf.table(P),
                                   buf.lengths, buf.active)

    def replay():
        eng._decode_call(horizon, False, P)

    out = {'horizon': horizon}
    for name, fn in (('eager', eager), ('replay', replay)):
        ms = _call_ms(torch, fn, GRAPH_REPS[name])
        busy = _device_busy_ms(torch, fn)
        out[name] = {'ms_per_call': ms, 'ms_per_step': ms / horizon,
                     'device_busy_ms': busy,
                     'idle_share': (None if busy is None
                                    else max(0.0, 1.0 - busy / ms))}
    out['speedup'] = out['eager']['ms_per_call'] / out['replay']['ms_per_call']
    return out


def phase_decode_graphs(torch, seed, params, weights, cases, timed=False,
                        horizons=GRAPH_HORIZONS):
    """The compiled decode program on llama2-7b at full width (the
    ``serve`` phase's bf16 weights or ``decode_variants``' int8 ones):
    for each (decode_impl, KV dtype) case an engine with the 8 requests
    prefilled checks, at ``horizons`` (1, 8 and 32), that the engine's graph
    replay and an eager call of the module's step function from the
    same state give equal tokens, ring rows and pool bytes, bit for bit
    (``audit.graph_matches_eager``); with ``timed``, one decode call's
    ms a step eager against replayed and the device's idle share of
    each. These launches compare kernels and do not count."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    saved = graphs._snapshot()
    for impl, kv in cases:
        torch.cuda.reset_peak_memory_stats()
        eng = _seated_engine(torch, params, seed, kv, impl)
        checks, timings = [], []
        for h in horizons:
            res = audit.graph_matches_eager(eng, h)
            checks.append(res)
            require(res['tokens_equal'] and res['ring_equal']
                    and res['pool_equal'],
                    f'graph replay differs from the eager step ({impl}, '
                    f'{kv}, horizon {h}): {res}')
            if timed and h in GRAPH_TIMED_HORIZONS:
                timings.append(_graph_timing(torch, eng, h, res['P']))
        stats = eng.graph_stats()
        emit({'phase': 'decode_graphs', 'check': 'graph_vs_eager',
              'model': eng.cfg.name, 'weights': weights,
              'kv_cache_dtype': kv, 'decode_impl': impl,
              'results': checks, 'timings': timings, **stats,
              'reduced': ({'timed_horizons': [list(GRAPH_HORIZONS),
                                              list(GRAPH_TIMED_HORIZONS)]}
                          if timed else
                          {'horizons': [list(GRAPH_HORIZONS), list(horizons)]}
                          if horizons != GRAPH_HORIZONS else None),
              'capture_s_per_key': stats['graph_capture_s']
              / max(1, stats['graph_captures']),
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9})
        del eng
        _release(torch)
    graphs._restore(saved)


def phase_decode_audits(torch):
    """The steady-state audits on the card at llama2-7b's width, depth
    cut to AUDIT_LAYERS: ``audit_multistep(k=4)`` on the paged engine
    and the engine audit on both engines, each under the sync debug
    mode: no unsanctioned sync, no capture in the audited rounds, and
    (multi-step) two dispatches a round at horizon 4."""
    import dataclasses
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.models import configs
    cfg = dataclasses.replace(configs.LLAMA2_7B, n_layers=AUDIT_LAYERS,
                              name=f'llama2-7b-depth{AUDIT_LAYERS}')
    saved = graphs._snapshot()
    for run in (lambda: audit.audit_multistep(4, cfg=cfg),
                lambda: audit.audit_engine('paged', cfg=cfg),
                lambda: audit.audit_engine('slot', cfg=cfg)):
        report = run()
        emit({'phase': 'decode_audit', 'model': cfg.name,
              'reduced': {'n_layers': [configs.LLAMA2_7B.n_layers,
                                       AUDIT_LAYERS]},
              **report.as_dict()})
        require(report.ok() and report.captures[0] > 0,
                f'{report.name}: {report.violations()}')
        _release(torch)
    graphs._restore(saved)


COST_RATE_CEILING = 1.05       # traced bytes over device-busy time may
                               # reach this share of BW_BYTES_S; more is a
                               # fault of the count
LLAMA2_7B_WEIGHTS = 13.23e9    # llama2-7b's bf16 weight floor at batch 8
                               # (the reference cost model's 13.2315 GB)


def phase_costmodel_check(torch, seed, params, weights, kv):
    """The cost model against the card on llama2-7b at full width and
    depth: the engine of the serve phases (``params``, K1) with the 8
    requests seated takes one real decode call of horizon 1 (its graphs
    captured), which the audit's capture prices on meta copies of the
    engine (``costmodel.engine_dispatch_costs``: the step and the ring
    merge). Beside the step's floor (``weight_floor_bytes`` plus the live
    KV) and its traced bytes, the device-busy ms of one replayed call
    (``_device_busy_ms``): the floor's share of that time at
    BW_BYTES_S, and the traced bytes over it (at most
    COST_RATE_CEILING of BW_BYTES_S); ``kv_static_check`` holds the
    static KV bytes per token to the engine's
    ``skytpu_kv_read_bytes_per_step`` gauge. Decode launches here do not
    count (the graphs' replays compare the count with the card)."""
    from skypilot_tpu_torch.analysis import costmodel
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.inference.engine import KV_READ_METRIC
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.telemetry import registry
    saved = graphs._snapshot()
    eng = _seated_engine(torch, params, seed, kv, 'pallas')
    caps = {}
    inner = eng._decode_call

    def shim(h, sample, P):
        caps[(h, sample, P)] = costmodel.Capture(eng, 'decode',
                                                 (h, sample, P))
        return inner(h, sample, P)

    eng._decode_call = shim
    lengths = eng._slot_len + eng._slot_inflight
    live = int(sum(int(lengths[s]) for s, r in enumerate(eng._slots)
                   if r is not None))
    require(eng._enqueue_decode(1), 'no decode call was enqueued')
    del eng._decode_call
    torch.cuda.synchronize()
    gauge = registry.get_registry().get(KV_READ_METRIC).value
    (key, cap), = caps.items()
    t0 = time.monotonic()
    costs = costmodel.engine_dispatch_costs(eng, [cap])
    trace_s = time.monotonic() - t0
    read = sum(c.read_total for c in costs.values())
    written = sum(c.written_total for c in costs.values())
    slots = sum(r is not None for r in eng._slots)
    floor_w = costmodel.weight_floor_bytes(eng.cfg, eng.params, slots)
    kv_tok = costs['decode'].kv_bytes_per_token
    floor = floor_w + live * kv_tok

    def replay():
        eng._decode_call(*key)

    busy = _device_busy_ms(torch, replay)
    call_ms = _call_ms(torch, replay, 5)
    require(busy is not None, 'the profiler recorded no device time')
    rate = (read + written) / (busy / 1e3)
    check = costmodel.kv_static_check(eng.cfg, kv, gauge / live)
    roof = costmodel.roofline_step_bytes(
        configs.LLAMA2_7B, batch=8, avg_ctx=400,
        quantize=None if weights == 'bfloat16' else 'int8')
    line = {'phase': 'costmodel_check', 'model': eng.cfg.name,
            'weights': weights, 'kv_cache_dtype': kv,
            'decode_impl': eng.decode_impl, 'card': _card_label(),
            'key': list(key), 'slots': slots, 'live_tokens': live,
            'floor_bytes': floor, 'floor_weight_bytes': floor_w,
            'floor_kv_bytes': live * kv_tok,
            'traced_read_by_class': {
                k: dict(c.read) for k, c in costs.items()},
            'traced_read_bytes': read, 'traced_written_bytes': written,
            'traced_over_floor': read / floor,
            'priced_ops': sum(len(c.eqns) for c in costs.values()),
            'trace_s': trace_s,
            'device_busy_ms': busy, 'call_ms': call_ms,
            'floor_ms_at_bw': floor / BW_BYTES_S * 1e3,
            'floor_share_of_busy': floor / BW_BYTES_S * 1e3 / busy,
            'traced_bytes_s': rate, 'traced_share_of_bw': rate / BW_BYTES_S,
            'kv_gauge_bytes': gauge, 'kv_static_check': check,
            'host_reads': [h for c in costs.values() for h in c.host_reads],
            'roofline_batch8_ctx400': {
                k: v for k, v in roof.items() if k != 'read_by_class'}}
    emit(line)
    require(not line['host_reads'], f'host reads in the decode program: '
                                    f'{line["host_reads"]}')
    require(read >= floor, f'traced {read} B below the floor {floor} B')
    require(rate <= COST_RATE_CEILING * BW_BYTES_S,
            f'traced bytes over device time {rate:.3e} B/s above '
            f'{COST_RATE_CEILING} x {BW_BYTES_S:.3e}: a fault of the count')
    require(check['ok'], f'kv_static_check: {check}')
    if weights == 'bfloat16':
        require(abs(floor_w / LLAMA2_7B_WEIGHTS - 1) <= 0.01
                and abs(roof['weight_bytes'] / LLAMA2_7B_WEIGHTS - 1) <= 0.01,
                f'bf16 weight floor {floor_w} / {roof["weight_bytes"]} not '
                f'within 1% of {LLAMA2_7B_WEIGHTS}')
    del eng, cap, caps, costs
    _release(torch)
    graphs._restore(saved)


# Default presets whose audit function an earlier phase already runs on
# the card at llama2-7b's width (decode_audit: paged, slot, multistep;
# spec_audit: paged-spec, slot-spec, spec-multistep; telemetry_audit:
# telemetry; lora_audit: adapters, adapters-slot), skipped here for the
# time limit and listed on each line's ``reduced``. Their ``@cuda``
# budgets come from the card all the same (``--emit-budgets``).
AUDIT_PRESETS_SKIPPED = ('slot', 'paged', 'slot-spec', 'paged-spec',
                         'telemetry', 'multistep', 'spec-multistep',
                         'adapters', 'adapters-slot')


def phase_audit_presets(torch):
    """Every single-device default audit preset
    (``audit.DEFAULT_PRESETS``) on the card, through ``run_preset`` with
    the budget for CUDA armed (``costmodel.BYTE_BUDGETS['<preset>@cuda']``,
    emitted on the card): each must be ``ok()``, and a preset with no
    budget for the back-end it resolved to fails. Each preset's line
    carries its per-dispatch traced bytes."""
    from skypilot_tpu_torch.analysis import audit, costmodel
    from skypilot_tpu_torch.inference import graphs
    saved = graphs._snapshot()
    names = [n for n in audit.default_presets('cuda')
             if n not in AUDIT_PRESETS_SKIPPED]
    failed = {}
    for name in names:
        t0 = time.monotonic()
        report = audit.run_preset(name, device='cuda')
        emit({'phase': 'audit_presets', 'preset': name,
              'budget_key': costmodel.budget_key(name, 'cuda'),
              'preset_s': round(time.monotonic() - t0, 2),
              'reduced': {'skipped': list(AUDIT_PRESETS_SKIPPED),
                          'needs_more_cards': [
                              n for n in audit.DEFAULT_PRESETS
                              if n not in audit.default_presets('cuda')]},
              **report.as_dict()})
        if not report.ok():
            failed[name] = report.violations()
        del report
        _release(torch)
    graphs._restore(saved)
    require(not failed, f'audit presets failed: {failed}')


# ------------------------------------------------------------ speculative
SPEC_K = 4                     # drafts a verify round proposes
SPEC_ROUNDS = 4                # fused rounds a call (decode_steps_per_call)
SPEC_SEGMENT = 16              # a spec prompt: one random segment repeated
SPEC_N_PAGES = 64              # the check engines' pools: the 8 prompts plus
                               # 4 fused rounds of 5 rows each


def _spec_prompts(seed, vocab):
    """The serve phases' prompt lengths, each a random SPEC_SEGMENT-token
    segment repeated to its length, so that prompt lookup has something
    to match."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    out = []
    for n in PROMPT_LENS:
        seg = [int(t) for t in rng.integers(3, vocab, SPEC_SEGMENT)]
        out.append((seg * (n // SPEC_SEGMENT + 1))[:n])
    return out


def _spec_cfg(torch, dtype):
    import dataclasses
    from skypilot_tpu_torch.models import configs
    name = str(dtype).replace('torch.', '')
    return dataclasses.replace(
        configs.LLAMA2_7B, n_layers=AUDIT_LAYERS, dtype=dtype,
        name=f'llama2-7b-depth{AUDIT_LAYERS}-{name}')


def _spec_engine(torch, kind, cfg, params, **kw):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    if kind == 'paged':
        return PagedInferenceEngine(cfg, params, max_batch=8, max_seq=2048,
                                    n_pages=SPEC_N_PAGES, **kw)
    return InferenceEngine(cfg, params, max_batch=8, max_seq=2048, **kw)


def _check_k3_verify(torch):
    """K3 at a verify round's shape on the slot engine's main path (8
    slots, sq = k + 1 = 5 query rows against a 1024-row cache bucket,
    each row's cache length a served prompt's) against its plain
    version, bf16 and fp32, then again with the cache rows past each
    length poisoned. Returns the worst output error."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, sq, split = 8, SPEC_K + 1, 1024
    before = dict(fa.launch_counts)
    before_sq = dict(fa.chunk_launches_by_sq)
    cl = torch.tensor(PROMPT_LENS, dtype=torch.int32, device='cuda')
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(torch, b, sq, split + sq, 32, 32, 128,
                                dtype, seed=sq)
        bf16 = dtype == torch.bfloat16
        rounding, tol = (BF16_ULP, TOL_OUT) if bf16 else (0.0, TOL_FP32)
        for poison in (None, POISON):
            if poison is not None:
                for row, n in enumerate(PROMPT_LENS):
                    k[row, n:split] = poison
                    v[row, n:split] = poison
            out = fa.flash_chunk_attention(q, k[:, split:], v[:, split:],
                                           k[:, :split], v[:, :split], cl)
            torch.cuda.synchronize()
            want = fa.flash_chunk_reference(q.float(), k.float(), v.float(),
                                            cl, split)
            diff = (out.float() - want.float()).abs()
            err = diff.max().item()
            excess = (diff - rounding * want.float().abs()).max().item()
            ok = bool(torch.isfinite(out).all()) and excess <= tol
            worst = max(worst, err)
            emit({'phase': 'kernel_check', 'kernel': 'flash_fwd_chunk',
                  'case': 'spec_verify', 'q_dtype': str(dtype).replace(
                      'torch.', ''), 'impl': _flash_impl(dtype), 'b': b,
                  'sq': sq, 'kv_split': split, 'cache_len': PROMPT_LENS,
                  'poison_past_cache_len': poison, 'hq': 32, 'hkv': 32,
                  'd': 128, 'max_abs_err_out': err,
                  'max_err_beyond_output_rounding': excess, 'tol_out': tol,
                  'output_rounding': rounding, 'ok': ok})
            require(ok, f'K3 at sq={sq} disagrees with its plain version '
                        f'({dtype}, poison {poison})')
        del q, k, v, out, want
    fa.launch_counts.update(before)      # comparison launches do not count
    fa.chunk_launches_by_sq.clear()
    fa.chunk_launches_by_sq.update(before_sq)
    return worst


def phase_spec_check(torch, seed):
    """Speculative decoding at llama2-7b's width, depth cut to
    AUDIT_LAYERS (``reduced``), the 8 spec prompts x N_NEW tokens: (1) at
    fp32, the greedy speculative stream (k = SPEC_K, single rounds and
    SPEC_ROUNDS fused rounds a call) equals the vanilla stream on both
    engines; (2) in bf16, a replayed verify call equals the same round
    run eagerly, bit for bit (commit, n_commit, tokens, pool or cache
    bytes; ``audit.spec_graph_matches_eager``) on bf16, int8 and int4
    paged pools and a bf16 slot cache, single and fused; (3) K3 at the
    verify width against its plain version. These launches check and do
    not count. Returns K3's worst error."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.models import llama
    saved = graphs._snapshot()
    reduced = {'n_layers': [32, AUDIT_LAYERS]}
    cfg = _spec_cfg(torch, torch.float32)
    prompts = _spec_prompts(seed, cfg.vocab_size)
    params = llama.init_params(cfg, seed, device='cuda')
    for kind in ('paged', 'slot'):
        def run(**kw):
            eng = _spec_engine(torch, kind, cfg, params, **kw)
            rids = [eng.add_request(p, max_new_tokens=N_NEW)
                    for p in prompts]
            done = eng.run_to_completion(horizon=8)
            return [done[r].output for r in rids], eng
        want, _ = run()
        runs = {}
        for fused in (None, SPEC_ROUNDS):
            got, eng = run(speculate_k=SPEC_K, decode_steps_per_call=fused)
            label = f'fused{fused}' if fused else 'single'
            require(got == want, f'fp32 speculative stream ({kind}, '
                                 f'{label}) differs from the vanilla one')
            runs[label] = {**eng.spec_metrics(),
                           'verify_calls': eng.spec_verify_calls,
                           'fused_calls': eng.spec_fused_calls,
                           **eng.graph_stats()}
            del eng
        emit({'phase': 'spec_check', 'check': 'greedy_identity_fp32',
              'model': cfg.name, 'reduced': reduced, 'engine': kind,
              'speculate_k': SPEC_K, 'streams_equal': True, 'runs': runs})
    del params
    _release(torch)
    cfg = _spec_cfg(torch, torch.bfloat16)
    params = llama.init_params(cfg, seed, device='cuda')
    for kind, kv in (('paged', 'bf16'), ('paged', 'int8'),
                     ('paged', 'int4'), ('slot', 'bf16')):
        results = []
        for rounds in (0, SPEC_ROUNDS):
            eng = _spec_engine(torch, kind, cfg, params, kv_cache_dtype=kv,
                               speculate_k=SPEC_K,
                               decode_steps_per_call=rounds or None)
            for p in prompts:
                eng.add_request(p, max_new_tokens=N_NEW)
            while eng._queue or eng._prefill_off:
                eng._admit()
            eng._spec_drain()
            res = audit.spec_graph_matches_eager(eng, rounds)
            results.append({**res, 'graph_pool_gb':
                            eng.graph_stats()['graph_pool_gb']})
            require(res['commit_equal'] and res['n_commit_equal']
                    and res['cache_equal'] and res['tokens_equal']
                    and res['captures'] == 1 and res['replays'] == 1,
                    f'replayed verify differs from the eager round ({kind}, '
                    f'{kv}, rounds {rounds}): {res}')
            del eng
            _release(torch)
        emit({'phase': 'spec_check', 'check': 'replay_vs_eager',
              'model': cfg.name, 'reduced': reduced, 'engine': kind,
              'kv_cache_dtype': kv, 'speculate_k': SPEC_K,
              'results': results})
    del params
    _release(torch)
    worst = _check_k3_verify(torch)
    graphs._restore(saved)
    return worst


SPEC_TIMING_REPS = 8           # successive replayed calls timed


def _seat_requests(eng, reqs, extra_rows):
    """``reqs`` ((prompt, request kwargs) pairs) seated in ``eng`` (the
    server's engine, idle, under its lock), prefilled and read back,
    each paged slot holding pages for ``extra_rows`` more rows. Returns
    the request ids."""
    rids = [eng.add_request(list(p), max_new_tokens=N_NEW, **kw)
            for p, kw in reqs]
    while eng._queue or eng._prefill_off:
        eng._admit()
    eng.drain_pipeline()
    if hasattr(eng, '_pages'):
        for s, r in enumerate(eng._decode_ready()):
            require(r is None or eng._ensure_pages(
                s, int(eng._slot_len[s]) + extra_rows), 'pool too small')
    return rids


def _spec_requests(eng, seed):
    """The 8 spec prompts as ``_seat_requests`` pairs."""
    return [(p, {}) for p in _spec_prompts(seed, eng.cfg.vocab_size)]


def _spec_timing(torch, eng, seed, rounds):
    """A speculative call (one verify round, or ``rounds`` fused rounds)
    replayed at full width with the 8 spec prompts seated: ms a call
    from dispatch to readback over SPEC_TIMING_REPS successive calls
    after one warm-up call (the paged engine repeats the same round;
    the slot engine's rounds advance its cache), and the device's busy
    time in one call (torch.profiler) with its idle share. The seated
    requests are cancelled after; these launches do not count."""
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.utils.device import host_sync
    saved = graphs._snapshot()
    per = max(1, rounds)
    rids = _seat_requests(eng, _spec_requests(eng, seed),
                          (SPEC_TIMING_REPS + 2) * per * (SPEC_K + 1))
    ready = eng._decode_ready()
    eng._meta_dirty = True
    eng._stage_rows(ready)
    proposals, n_prop, starved = eng._spec_build_proposals(ready)
    require(not starved, 'slots starved in the timing state')

    def call():
        out = (eng._spec_fused_call(ready, rounds) if rounds
               else eng._spec_verify_call(ready, proposals, n_prop))
        host_sync(out)

    call()                               # the key's capture, if new
    ms = _call_ms(torch, call, SPEC_TIMING_REPS)
    busy = _device_busy_ms(torch, call)
    for rid in rids:
        eng.cancel(rid)
    graphs._restore(saved)
    return {'rounds_per_call': per, 'ms_per_call': ms,
            'ms_per_round': ms / per, 'device_busy_ms_per_call': busy,
            'idle_share': (None if busy is None
                           else max(0.0, 1.0 - busy / ms))}


def _decode_timing(torch, eng, reqs, horizon):
    """One replayed decode call (``horizon`` steps and the merge) with
    ``reqs`` ((prompt, request kwargs) pairs) seated and prefilled, the
    call staged as the engine stages it: ms a call from dispatch to
    readback over SPEC_TIMING_REPS calls after a warm-up call (the paged
    engine repeats one state; the slot engine's calls advance its
    cache), and the device's busy time in one call with its idle share.
    The requests are cancelled after; these launches do not count."""
    import numpy as np
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.inference.engine import _bucket_len
    from skypilot_tpu_torch.utils.device import host_sync
    saved = graphs._snapshot()
    rids = _seat_requests(eng, reqs, horizon)
    ready = eng._decode_ready()
    eng._meta_dirty = True
    eng._stage_rows(ready)
    buf = eng._buf
    live = [s for s, r in enumerate(ready) if r is not None]
    if hasattr(eng, '_pages'):
        lengths = eng._slot_len + eng._slot_inflight
        third = _bucket_len(max(
            eng._pages_needed(int(lengths[s]) + horizon) for s in live),
            minimum=1)
        table_p = np.zeros((eng.max_batch, third), np.int32)
        for s in range(eng.max_batch):
            ps = eng._pages[s][:third]
            table_p[s, :len(ps)] = ps
        buf.set_lengths(lengths)
        buf.upload(buf.set_table(table_p))
    else:
        buf.upload(buf.rows_words)
        third = min(eng.max_seq, _bucket_len(
            int(max(eng._slot_len[s] for s in live))
            + (SPEC_TIMING_REPS + 2) * horizon))

    def call():
        host_sync(eng._decode_call(horizon, False, third))

    call()                               # the key's capture, if new
    ms = _call_ms(torch, call, SPEC_TIMING_REPS)
    busy = _device_busy_ms(torch, call)
    for rid in rids:
        eng.cancel(rid)
    graphs._restore(saved)
    return {'horizon': horizon,
            ('P' if hasattr(eng, '_pages') else 'kv_bucket'): third,
            'ms_per_call': ms, 'ms_per_step': ms / horizon,
            'device_busy_ms_per_call': busy,
            'device_busy_ms_per_step': (None if busy is None
                                        else busy / horizon),
            'idle_share': (None if busy is None
                           else max(0.0, 1.0 - busy / ms))}


def phase_serve_spec(torch, seed, params, phase, kv_cache='paged',
                     decode_steps_per_call=None):
    """The bf16 7B weights of ``serve`` behind ``ModelServer(speculate_k=
    SPEC_K)`` (``decode_steps_per_call`` fuses that many rounds a call),
    the 8 requests of ``serve`` with spec prompts; then the same
    requests with ``speculate_k=0`` in the same phase, to compare
    against (no claim). Speculation must accept drafts. The paged
    engine's rounds run no kernel (its verify is plain torch, as the
    reference's is XLA); the slot engine's rounds run K3 at sq = k + 1,
    one launch per layer a round. After the requests, the idle server's
    engine times a replayed speculative call (``_spec_timing``) and, on
    the paged engine, the vanilla server's replayed decode call at the
    same state (``_decode_timing``). Returns K3's launches at that
    width (0 on the paged engine)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer
    sq = SPEC_K + 1
    line, runs, toks = {}, {}, {}
    cut_cfg, params, cut = _cut_7b(params)
    for k in (SPEC_K, 0):
        torch.cuda.reset_peak_memory_stats()
        port = _free_port()
        t0 = time.monotonic()
        _fresh_registry()
        srv = ModelServer(cut_cfg, max_batch=8, max_seq=2048,
                          port=port, seed=seed, params=params,
                          kv_cache=kv_cache, speculate_k=k,
                          decode_steps_per_call=decode_steps_per_call)
        srv.start(block=False)
        try:
            srv.wait_ready(timeout=600)
            ready_s = time.monotonic() - t0
            eng = srv.engine
            cfg = eng.cfg
            m0 = eng.spec_metrics()
            calls0 = (eng.spec_verify_calls, eng.spec_fused_calls,
                      eng.spec_round_s)

            def reset():                 # counts to 0 just before the path
                pa.reset_launch_counts()
                fa.reset_launch_counts()
            toks[k] = []
            counts, ttfts, wall = _drive(port, cfg, seed, reset,
                                         prompts=_spec_prompts(
                                             seed, cfg.vocab_size),
                                         tokens=toks[k])
            flash_after = dict(fa.launch_counts)
            by_sq = dict(fa.chunk_launches_by_sq)
            paged_after = dict(pa.launch_counts)
            m = eng.spec_metrics()
            d = {n: m[n] - m0[n] for n in ('spec_rounds', 'spec_proposed',
                                           'spec_accepted',
                                           'spec_committed')}
            verify_calls = eng.spec_verify_calls - calls0[0]
            fused_calls = eng.spec_fused_calls - calls0[1]
            round_s = eng.spec_round_s - calls0[2]
            run = _serve_line(torch, phase, cfg, srv, counts, ttfts, wall,
                              weights='bfloat16', kv_cache=kv_cache,
                              ready_s=ready_s, speculate_k=k,
                              spec_prompts=f'{SPEC_SEGMENT}-token segment '
                                           'repeated',
                              kernel_launches={**flash_after,
                                               **paged_after},
                              k3_launches_by_sq=by_sq, reduced=cut)
            if k:
                rounds = verify_calls + fused_calls * (
                    decode_steps_per_call or 1)
                run.update(
                    spec_rounds=d['spec_rounds'],
                    spec_proposed=d['spec_proposed'],
                    spec_accepted=d['spec_accepted'],
                    spec_committed=d['spec_committed'],
                    spec_accept_rate=(d['spec_accepted']
                                      / max(1, d['spec_proposed'])),
                    spec_tokens_per_step=m['spec_tokens_per_step'],
                    spec_verify_calls=verify_calls,
                    spec_fused_calls=fused_calls,
                    spec_call_ms=round_s * 1e3 / max(
                        1, verify_calls + fused_calls))
                require(d['spec_accepted'] > 0,
                        f'{phase}: no draft accepted ({d})')
                require(rounds == d['spec_rounds'] and rounds > 0,
                        f'{phase}: {rounds} rounds dispatched, '
                        f'{d["spec_rounds"]} counted')
                require(not any(paged_after.values()),
                        f'{phase}: paged kernels launched: {paged_after}')
                if kv_cache == 'slot':
                    calls = by_sq.get(sq, 0)
                    require(calls == cfg.n_layers * rounds,
                            f'{phase}: K3 launches at sq={sq} {calls} != '
                            f'n_layers x verify rounds {rounds}')
                    line['k3_verify_launches'] = calls
                else:
                    require(not any(flash_after.values()),
                            f'{phase}: flash kernels launched on the paged '
                            f'path: {flash_after}')
            with srv._lock:              # the engine is idle: time it
                if k:
                    run['spec_timing'] = _spec_timing(
                        torch, eng, seed, decode_steps_per_call or 0)
                elif kv_cache == 'paged':
                    run['decode_timing'] = _decode_timing(
                        torch, eng, _spec_requests(eng, seed),
                        decode_steps_per_call or 1)
            runs[k] = run
        finally:
            srv.stop()
        del eng, srv
        _release(torch)
    same = sum(a == b for x, y in zip(toks[SPEC_K], toks[0])
               for a, b in zip(x, y))
    total = sum(len(x) for x in toks[0])
    spec, vanilla = runs[SPEC_K], runs[0]
    emit({**spec, 'vanilla': {
        key: vanilla[key] for key in (
            'ttft_ms_median', 'tpot_ms_median_server', 'output_tok_s',
            'wall_s', 'peak_mem_gb', 'graph_captures', 'graph_replays',
            'graph_pool_gb', 'decode_steps_per_call')},
        'vanilla_decode_timing': vanilla.get('decode_timing'),
        'generate_tokens_equal_to_vanilla_share': same / max(1, total)})
    return line.get('k3_verify_launches', 0)


def phase_spec_audit(torch):
    """The speculative steady state on the card at llama2-7b's width,
    depth cut to AUDIT_LAYERS: ``audit_engine(speculate_k=SPEC_K)`` on
    both engines and ``audit_spec_multistep(SPEC_K, SPEC_ROUNDS)``,
    under the sync debug mode: no unsanctioned sync, no capture in the
    audited rounds, one sanctioned sync per dispatch, and fused one
    dispatch per SPEC_ROUNDS rounds with no single-round fallback."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    cfg = _spec_cfg(torch, torch.bfloat16)
    saved = graphs._snapshot()
    for run in (lambda: audit.audit_engine('paged', cfg=cfg,
                                           speculate_k=SPEC_K),
                lambda: audit.audit_engine('slot', cfg=cfg,
                                           speculate_k=SPEC_K),
                lambda: audit.audit_spec_multistep(SPEC_K, SPEC_ROUNDS,
                                                   cfg=cfg)):
        report = run()
        emit({'phase': 'spec_audit', 'model': cfg.name,
              'reduced': {'n_layers': [32, AUDIT_LAYERS]},
              **report.as_dict()})
        require(report.ok() and report.captures[0] > 0
                and report.spec_syncs == report.dispatches > 0,
                f'{report.name}: {report.violations()}')
        _release(torch)
    graphs._restore(saved)


# -------------------------------------------------------------------- 8c
KV_N_PAGES = 64                # the handoff engines' pools (of 128 rows):
                               # the 8 prompts and 32 new rows take 29
KV_DECODE_FIRST = 4            # decode steps before the export
KV_SLOT_MAX_SEQ = 1024         # the slot handoff engines' reservations
KV_PREFIX = 512                # shared prefix of the checkpoint prompts
KV_TAILS = (16, 40, 64, 88, 24, 48, 72, 96)   # their distinct tails


MESH1_N_PAGES = 48            # serve_mesh1's pools: the 8 prompts with
                              # their 32 new tokens take at most 40 pages


def phase_serve_mesh1(torch, seed, params):
    """The serving mesh's path on the card (``parallel/mesh.py``): a
    one-rank NCCL mesh (``make_mesh(MeshSpec.for_serving(1, 1))``;
    ``serving_mesh`` stays meshless at 1 x 1 as the reference's does)
    under the paged engine at llama2-7b's full width and depth, bf16,
    K1 (``decode_impl='pallas'``), the 8 prompts x N_NEW tokens, the
    pool sized explicitly. Its streams must equal a meshless engine's
    on the same params bit for bit (a one-rank all-reduce and
    all-gather are copies); the census of one replayed decode step
    (``audit.expected_census``: an all-reduce after ``wo`` and after
    ``w_down`` per layer, one logits all-gather) shows the NCCL calls
    were captured in the decode graphs. ``serving_mesh(tp=2)`` must
    raise ``ValueError`` on one card. Cross-card NCCL is not exercised:
    the machine has one card, and NCCL refuses two ranks on one GPU."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = configs.LLAMA2_7B
    prompts = _prompts(seed, cfg.vocab_size)
    kw = dict(max_batch=8, max_seq=2048, n_pages=MESH1_N_PAGES,
              decode_impl='pallas', device='cuda')
    try:
        mesh_lib.serving_mesh(tp=2, device='cuda')
        refused = False
    except ValueError:
        refused = True
    require(refused or torch.cuda.device_count() >= 2,
            'serving_mesh(tp=2) did not raise on one card')

    def serve(eng):
        rids = [eng.add_request(list(p), max_new_tokens=N_NEW)
                for p in prompts]
        t0 = time.monotonic()
        done = eng.run_to_completion(horizon=32)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        reqs = [done[r] for r in rids]
        tpot = [(r.finish_time - r.first_token_time) / (len(r.output) - 1)
                * 1e3 for r in reqs]
        return [r.output for r in reqs], wall, sum(tpot) / len(tpot)

    saved = graphs._snapshot()
    ref = PagedInferenceEngine(cfg, params, **kw)
    want, ref_wall, ref_tpot = serve(ref)
    ref_step = _decode_timing(torch, ref, [(p, {}) for p in prompts], 8)
    del ref
    _release(torch)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec.for_serving(1, 1),
                              device='cuda')
    try:
        eng = PagedInferenceEngine(cfg, params, mesh=mesh, **kw)
        census = {}
        audit._record_collectives(eng, census)
        pa.reset_launch_counts()
        mesh_lib.reset_collective_counts()
        got, wall, tpot = serve(eng)
        launches = dict(pa.launch_counts)
        issued = dict(mesh_lib.collective_counts)
        del eng._run_graph
        stats = eng.graph_stats()
        expected = audit.expected_census(eng)
        with mesh_lib.scope(mesh, eng._tp_plan):
            step = _decode_timing(torch, eng, [(p, {}) for p in prompts], 8)
        pool_ok = (eng.cache.pool_k.is_contiguous()
                   and tuple(eng.cache.pool_k.shape)
                   == (cfg.n_layers, MESH1_N_PAGES, cfg.n_kv_heads,
                       eng.page, cfg.head_dim))
        eng.close()
        del eng
    finally:
        mesh.shutdown()
    graphs._restore(saved)
    k1 = launches.get('paged_decode_attention[bf16]', 0)
    line = {'phase': 'serve_mesh1', 'model': cfg.name, 'weights':
            'bfloat16', 'kv_cache': 'paged', 'decode_impl': 'pallas',
            'mesh': {'tp': 1, 'dp': 1, 'backend': 'nccl'},
            'nccl_version': '.'.join(map(str, torch.cuda.nccl.version())),
            'requests': len(prompts), 'new_tokens': N_NEW,
            'n_pages': MESH1_N_PAGES,
            'streams_equal_meshless': got == want,
            'census_step': census.get('decode'),
            'census_merge': census.get('merge', {}),
            'census_expected': expected,
            'collectives_issued': issued,
            'graph_captures': stats['graph_captures'],
            'graph_replays': stats['graph_replays'],
            'k1_launches': k1, 'pool_local_contiguous': pool_ok,
            'tpot_ms': {'mesh': tpot, 'meshless': ref_tpot},
            'wall_s': {'mesh': wall, 'meshless': ref_wall},
            'decode_ms_per_step': {'mesh': step['ms_per_step'],
                                   'meshless': ref_step['ms_per_step']},
            'serving_mesh_tp2_refused': refused,
            'multi_card': False,
            'multi_card_reason': 'one card on this machine, and NCCL '
                                 'refuses two ranks on one GPU',
            'card': _card_label()}
    emit(line)
    require(got == want, 'serve_mesh1: mesh streams differ from the '
                         'meshless engine')
    require(census.get('decode') == expected['decode']
            and census.get('merge', {}) == expected['merge'],
            f'serve_mesh1: census {census} != {expected}')
    require(k1 > 0, 'serve_mesh1: K1 never launched')
    require(stats['graph_replays'] > 0, 'serve_mesh1: no graph replays')
    require(pool_ok, 'serve_mesh1: the mesh pool is not its own '
                     'contiguous tensor of the local shape')
    return k1


GANG_MAX_SEQ = 1024           # serve_gang: both ranks' max_seq (the 8
                              # prompts + N_NEW fit; the auto-sized pools
                              # of two 7B engines share one card)
GANG_HB_TIMEOUT_S = 1.0       # serve_gang's crash check: heartbeat bound
GANG_CRASH_AT = 40            # ... and the follower heartbeat that dies


def _gang_follower(port, gang_id, model, extra=(), env=None):
    """Rank 1 of a replicated gang: ``python -m skypilot_tpu_torch.serve.
    server --gang-rank 1`` under the launch-env contract, its stdout
    piped (its exit summary is one JSON line)."""
    env = dict(os.environ if env is None else env,
               SKYTPU_COORDINATOR=f'http://127.0.0.1:{port}',
               SKYTPU_RANK='1', SKYTPU_WORLD='2', SKYTPU_GANG_ID=gang_id,
               SKYTPU_GANG_HEARTBEAT='0.05',
               SKYTPU_GANG_HEARTBEAT_TIMEOUT='30',
               SKYTPU_GANG_JOIN_TIMEOUT='300')
    return subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--gang-rank', '1', '--model', model, '--device', 'cuda',
         '--max-batch', '8', '--max-seq', str(GANG_MAX_SEQ), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def _follower_summary(out):
    for line in (out or '').splitlines():
        if line.startswith('{"gang_follower"'):
            return json.loads(line)['gang_follower']
    return None


def _await(cond, timeout, what):
    t0 = time.monotonic()
    while not cond():
        require(time.monotonic() - t0 < timeout, f'serve_gang: {what} '
                f'not within {timeout} s')
        time.sleep(0.01)
    return time.monotonic() - t0


def phase_serve_gang(torch, seed):
    """A replicated gang of world 2 on the one card (``serve/gang.py``):
    rank 0 a ``ModelServer`` on llama2-7b bf16 at full width and depth,
    paged, ``decode_impl`` auto (K1), random weights from ``seed``;
    rank 1 a separate ``python -m skypilot_tpu_torch.serve.server
    --gang-rank 1`` process under the launch-env contract, building the
    same engine from the same seed on the same card (two copies of the
    weights). The 8 requests x N_NEW tokens through rank 0's HTTP front
    end; rank 1 replays the op log. The line carries the join seconds,
    each rank's K1 launches over the served requests (rank 1's from its
    exit summary: its replay, its warm-up excluded), whether the
    digests of every finished request are equal, the drain acked by
    both ranks, and a ``gang_member_crash`` on rank 1 of a second,
    tiny gang (the same code path; the model does not enter the
    heartbeat): the failure cause and the seconds from rank 1's last
    heartbeat to rank 0 failing, against the heartbeat bound. A mesh gang across
    cards, replicated kv heads at tp > 1 and dp-split prefill need
    several ranks of a mesh, and NCCL refuses two ranks on one GPU:
    they are held on the CPU only."""
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve import gang as gang_lib
    from skypilot_tpu_torch.serve.server import ModelServer
    cfg = configs.LLAMA2_7B
    _fresh_registry()
    port = _free_port()
    # heartbeat_s 0.5: stop() then waits 1 s for rank 1's shutdown ack
    # (rank 1 itself syncs every 0.05 s).
    spec = gang_lib.GangSpec(gang_id='smoke-gang', rank=0, world=2,
                             join_timeout_s=300.0, heartbeat_s=0.5,
                             heartbeat_timeout_s=30.0)
    t_build = time.monotonic()
    srv = ModelServer(cfg, port=port, max_batch=8, max_seq=GANG_MAX_SEQ,
                      seed=seed, gang=spec, step_watchdog_s=0,
                      device='cuda')
    srv.start(block=False)
    proc = _gang_follower(port, 'smoke-gang', cfg.name,
                          ('--seed', str(seed)))
    follower = None
    try:
        srv.wait_ready(600)
        join_s = _await(lambda: srv._gang.all_joined
                        or proc.poll() is not None, 600, 'the barrier')
        require(srv._gang.all_joined, f'serve_gang: rank 1 exited '
                f'({proc.poll()}) before joining')
        build_s = time.monotonic() - t_build
        k1_key = 'paged_decode_attention[bf16]'
        counts, ttfts, wall = _drive(port, cfg, seed,
                                     pa.reset_launch_counts)
        k1_rank0 = pa.launch_counts[k1_key]
        _await(lambda: srv._gang.status()['members']['1']['applied']
               == srv._gang.status()['ops'], 120, 'rank 1 catching up')
        srv.begin_drain(60)
        drain_s = _await(lambda: srv.drain_status()['drained'], 90,
                         'the gang drain')
        drain = srv.drain_status()
        status = srv._gang.status()
        leader_digests = dict(srv._gang.digest.finished)
        gang_error = srv._error
    finally:
        srv.stop()
        try:
            out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        follower = _follower_summary(out)
    del srv
    _release(torch)
    require(proc.returncode == 0 and follower is not None,
            f'serve_gang: rank 1 rc {proc.returncode}: {err[-2000:]}')
    k1_rank1 = follower['launches'].get(k1_key, 0)
    finished = follower['finished']
    digests_equal = (len(finished) >= len(counts) and all(
        leader_digests.get(int(r)) == d for r, d in finished.items()))
    crash = _gang_crash_check(torch)
    layout = _kv_layout_check(torch)
    line = {'phase': 'serve_gang', 'model': cfg.name, 'weights': 'bfloat16',
            'kv_cache': 'paged', 'decode_impl': 'auto (K1)',
            'plane': 'replicated', 'world': 2, 'ranks_on_card': 2,
            'max_seq': GANG_MAX_SEQ, 'requests': len(counts),
            'new_tokens': N_NEW, 'join_s': status['join_seconds'],
            'barrier_wait_s': join_s,
            'build_and_join_s': build_s, 'wall_s': wall,
            'ttft_ms': sorted(ttfts),
            'k1_launches': {'rank0': k1_rank0, 'rank1': k1_rank1},
            'ops': status['ops'], 'ops_applied_rank1':
                follower['ops_applied'],
            'finished_digests': len(finished),
            'digests_equal': digests_equal,
            'drain_s': drain_s,
            'drain_acked_by_both': bool(drain.get('gang_drain_acked')
                                        and drain['drained']),
            'rank1_exit': follower['exit'], 'gang_error': gang_error,
            'crash': crash, 'kv_layout_k1': layout,
            'kv_layout_tol_out': TOL_OUT, 'reduced': None,
            'multi_card': False,
            'held_on_the_cpu_only': 'a mesh gang across cards, replicated '
                                    'kv heads at tp > 1 and dp-split '
                                    'prefill: each needs several mesh '
                                    'ranks, and NCCL refuses two ranks on '
                                    'one GPU',
            'card': _card_label()}
    emit(line)
    require(gang_error is None, f'serve_gang: the gang failed: {gang_error}')
    require(k1_rank0 > 0 and k1_rank1 > 0,
            f'serve_gang: K1 launches {k1_rank0} / {k1_rank1}')
    require(digests_equal, 'serve_gang: the digests differ')
    require(line['drain_acked_by_both'], 'serve_gang: drain not acked')
    require(all(c['max_abs_err_out'] <= TOL_OUT for c in layout.values()),
            f'serve_gang: K1 through the kv-head layout {layout}')
    require(crash['cause'] == 'heartbeat_lost'
            and crash['detect_s'] <= GANG_HB_TIMEOUT_S + 2.0,
            f'serve_gang: crash check {crash}')
    return k1_rank0 + k1_rank1


def _kv_layout_check(torch):
    """K1 through the replicated kv-head layout (``mesh.kv_head_layout``:
    this rank's q heads placed in a virtual query over every kv head,
    ``mesh.attend_local_heads``) against the plain version on the kv
    heads expanded per local q head (group 1), bf16 pools at d 128, 8
    slots of mixed lengths: llama3-70b's 64 q / 8 kv at tp 16 (rank 5:
    its 4 q heads read kv head 2, the aligned case) and 6 q / 3 kv at tp
    2 (rank 1: q heads 3, 4, 5 read kv heads 1, 2, 2). A tp > 1 mesh
    cannot run on one card, so this holds the kernel path of the layout
    and nothing of the mesh. Returns the worst error of the normalised
    outputs of the live slots per case."""
    import dataclasses
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    base = dataclasses.replace(configs.LLAMA2_7B, head_dim_override=128)
    cases = {'64q_8kv_tp16_rank5': (dataclasses.replace(
                 base, n_heads=64, n_kv_heads=8), 16, 5),
             '6q_3kv_tp2_rank1': (dataclasses.replace(
                 base, n_heads=6, n_kv_heads=3), 2, 1)}
    lengths = [0, 1, 100, 512, 700, 1024, 333, 64]
    out = {}
    for name, (cfg, tp, rank) in cases.items():
        positions, nv = mesh_lib.kv_head_layout(
            cfg, mesh_lib.MeshSpec.for_serving(tp=tp), tp_rank=rank)
        hkv = cfg.n_kv_heads
        q, pk, pv, ks, vs, table, lens = _make_paged_inputs(
            torch, slots=8, hq=len(positions), hkv=hkv, d=128, page=128,
            P=8, lengths=lengths, L=2, dtype=torch.bfloat16, seed=11)

        def k1(qv, k, v):
            acc, _, l = pa.paged_decode_attention(
                qv[:, 0].contiguous(), pk, pv, table, lens, ks, vs, layer=1)
            return (acc / l.clamp(min=1e-30)[..., None])[:, None]

        plan = {'kv_groups': (positions, nv),
                'kv_index': torch.tensor(positions, device='cuda')}
        with mesh_lib.scope(None, plan):
            got = mesh_lib.attend_local_heads(k1, q[:, None], None,
                                              None)[:, 0]
        torch.cuda.synchronize()
        idx = torch.tensor([p // (nv // hkv) for p in positions],
                           device='cuda')
        acc, _, l = pa.paged_decode_attention_reference(
            q, pk.index_select(2, idx).contiguous(),
            pv.index_select(2, idx).contiguous(), table, lens, layer=1)
        want = acc / l.clamp(min=1e-30)[..., None]
        live = lens > 0
        out[name] = {'positions': list(positions), 'virtual_heads': nv,
                     'max_abs_err_out': (got[live].float()
                                         - want[live]).abs().max().item()}
    return out


def _gang_crash_check(torch):
    """A tiny replicated gang on the card whose rank 1 dies at its
    ``GANG_CRASH_AT``-th heartbeat (``gang_member_crash``, rank 1, kind
    ``replica_crash``): rank 0 must fail the gang with cause
    ``heartbeat_lost`` about ``GANG_HB_TIMEOUT_S`` after the death.
    Returns the cause, the age of rank 1's last heartbeat when rank 0
    failed (``detect_s``: its death, within one heartbeat period) and
    the seconds from its process exit (polled every 10 ms) to the
    failure."""
    from skypilot_tpu_torch.serve import gang as gang_lib
    from skypilot_tpu_torch.serve.server import ModelServer
    port = _free_port()
    spec = gang_lib.GangSpec(gang_id='smoke-crash', rank=0, world=2,
                             join_timeout_s=300.0, heartbeat_s=0.05,
                             heartbeat_timeout_s=GANG_HB_TIMEOUT_S)
    srv = ModelServer('tiny', port=port, max_batch=8, max_seq=GANG_MAX_SEQ,
                      gang=spec, step_watchdog_s=0, device='cuda')
    srv.start(block=False)
    fault = json.dumps({'seed': 0, 'rules': [
        {'kind': 'replica_crash', 'site': 'gang_member_crash', 'rank': 1,
         'at': GANG_CRASH_AT}]})
    proc = _gang_follower(port, 'smoke-crash', 'tiny',
                          ('--fault-spec', fault))
    try:
        srv.wait_ready(300)
        _await(lambda: proc.poll() is not None, 300, 'rank 1 dying')
        died = time.monotonic()
        joined = srv._gang.all_joined
        _await(lambda: srv._error is not None, 30, 'rank 0 failing')
        after_exit_s = time.monotonic() - died
        # Rank 1's last heartbeat is its death, give or take one period.
        detect_s = srv._gang.status()['members']['1']['heartbeat_age_s']
        failed = srv._gang.failed or ''
        cause = ('heartbeat_lost' if 'heartbeat lost' in failed
                 else failed[:80])
        rc = proc.returncode
    finally:
        srv.stop()
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    del srv
    _release(torch)
    return {'model': 'tiny', 'joined_first': joined, 'rank1_rc': rc,
            'cause': cause, 'detect_s': detect_s,
            'after_process_exit_s': after_exit_s,
            'heartbeat_timeout_s': GANG_HB_TIMEOUT_S,
            'crash_at_heartbeat': GANG_CRASH_AT}


MESH_OPTS_REQUESTS = 4        # serve_mesh1_opts: the first 4 prompts of
MESH_OPTS_NEW = 16            # serve's, 16 new tokens each
# The depth of serve_mesh1_opts' 'bank', 'w8a8' and 'moe' cases, cut for
# time (their lines' ``reduced``).
MESH_OPTS_LAYERS = {'bank': CUT_LAYERS, 'w8a8': CUT_LAYERS, 'moe': 4}


def _first_layers(cfg, params, n, full_layers=None):
    """``cfg`` and ``params`` cut to their first ``n`` layers (views of
    the stacked leaves, quantized ones too: nothing is copied), and the
    ``reduced`` record of the cut from ``full_layers`` (default: the
    config's depth)."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    layers = llama._select_layers(params['layers'], lambda t: t[:n])
    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, layers=layers),
            {'n_layers': [full_layers or cfg.n_layers, n],
             'why': "chip_smoke.py's time limit"})


def _mesh_opts_case(torch, case, cfg, params, reqs, *, kind='paged',
                    adapters=None, prefill_tokens=None, extra=None,
                    **opts):
    """One case of serve_mesh1_opts: ``reqs`` ((prompt, request kwargs)
    pairs, MESH_OPTS_NEW new tokens each) on a meshless engine of
    ``kind`` with ``opts``, then on a one-rank NCCL mesh engine with the
    same params and options (``adapters``, {name: tree}, registered on
    both first). The mesh engine's streams must equal the meshless
    one's bit for bit (a one-rank mesh slices nothing and its
    collectives are copies), and the census of its last replayed graph
    of each label (a decode step and its merge, or a verify round) must
    be ``audit.expected_census``. With ``prefill_tokens`` one prefill's
    logits (``prefill_logits``) must be equal too, and its census
    ``audit.expected_prefill_census``. The launch counts are set to 0
    just before the mesh engine's requests and read just after. Returns
    the case's line."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import quantization as q
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cls = PagedInferenceEngine if kind == 'paged' else InferenceEngine
    kw = dict(max_batch=8, max_seq=2048, device='cuda', **opts)
    if kind == 'paged':
        kw.update(n_pages=MESH1_N_PAGES, decode_impl='pallas')
    saved = graphs._snapshot()

    def drive(eng):
        for name, tree in (adapters or {}).items():
            eng.register_adapter(name, tree, 1.0)
        rids = [eng.add_request(list(p), max_new_tokens=MESH_OPTS_NEW, **r)
                for p, r in reqs]
        t0 = time.monotonic()
        done = eng.run_to_completion(horizon=16)
        torch.cuda.synchronize()
        return [done[r].output for r in rids], time.monotonic() - t0

    ref = cls(cfg, params, **kw)
    want, ref_wall = drive(ref)
    ref_spec = ref.spec_metrics()
    ref_logits = (ref.prefill_logits(prefill_tokens)
                  if prefill_tokens is not None else None)
    del ref
    _release(torch)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec.for_serving(1, 1),
                              device='cuda')
    try:
        eng = cls(cfg, params, mesh=mesh, **kw)
        census = {}
        audit._record_collectives(eng, census)
        pa.reset_launch_counts()
        fa.reset_launch_counts()
        q.reset_launch_counts()
        got, wall = drive(eng)
        launches = {**pa.launch_counts, **fa.launch_counts}
        k3_by_sq = dict(fa.chunk_launches_by_sq)
        int_mm = q.launch_counts['int_mm']
        del eng._run_graph
        expected = audit.expected_census(eng)
        spec = eng.spec_metrics()
        prefill = {}
        if prefill_tokens is not None:
            mesh_lib.reset_collective_counts()
            logits = eng.prefill_logits(prefill_tokens)
            prefill = {'census': dict(mesh_lib.collective_counts),
                       'census_expected': audit.expected_prefill_census(
                           eng),
                       'logits_equal_meshless': bool(
                           (logits == ref_logits).all())}
        stats = eng.graph_stats()
        eng.close()
        del eng
    finally:
        mesh.shutdown()
    graphs._restore(saved)
    _release(torch)
    line = {'phase': 'serve_mesh1_opts', 'case': case, 'model': cfg.name,
            'n_layers': cfg.n_layers, 'kv_cache': kind,
            'mesh': {'tp': 1, 'dp': 1, 'backend': 'nccl'},
            'options': dict(opts),
            'requests': len(reqs), 'new_tokens': MESH_OPTS_NEW,
            'streams_equal_meshless': got == want,
            'census': census, 'census_expected': expected,
            'kernel_launches': {k: n for k, n in launches.items() if n},
            'k3_launches_by_sq': k3_by_sq, 'int_mm_launches': int_mm,
            'graph_captures': stats['graph_captures'],
            'graph_replays': stats['graph_replays'],
            'wall_s': {'mesh': wall, 'meshless': ref_wall},
            'card': _card_label(), **(extra or {})}
    if opts.get('speculate_k'):
        line['spec'] = {'mesh': spec, 'meshless': ref_spec}
    if prefill:
        line['prefill'] = prefill
    emit(line)
    require(got == want, f'serve_mesh1_opts[{case}]: mesh streams differ '
                         'from the meshless engine')
    require(census and all(census.get(k) == v for k, v in expected.items()),
            f'serve_mesh1_opts[{case}]: census {census} != {expected}')
    require(stats['graph_replays'] > 0,
            f'serve_mesh1_opts[{case}]: no graph replays')
    if opts.get('speculate_k'):
        require(spec == ref_spec and spec['spec_accepted'] > 0,
                f'serve_mesh1_opts[{case}]: speculation {spec} != the '
                f'meshless {ref_spec}')
    if prefill:
        require(prefill['census'] == prefill['census_expected']
                and prefill['logits_equal_meshless'],
                f'serve_mesh1_opts[{case}]: prefill {prefill}')
    return line


def phase_serve_mesh1_opts(torch, seed, case, params, cfg=None,
                           reduced=None):
    """The serving options on the one-rank NCCL mesh (``serve_mesh1``'s
    mesh), each on the weights already on the card, held bit for bit
    against a meshless engine with the same params and options
    (``_mesh_opts_case``):

    - 'bank': llama2-7b bf16 at depth ``MESH_OPTS_LAYERS['bank']``
      (``reduced``), paged, K1, a bank of two adapters with two base
      rows among the requests;
    - 'spec_slot': the slot engine with ``speculate_k=SPEC_K`` on the
      spec prompts: K3 at sq = k + 1 once a layer a round, and the
      rounds' commits and accepted counts equal the meshless engine's;
    - 'w8a8': the int8 weights of ``serve_int8`` with ``prefill_w8a8``
      at depth ``MESH_OPTS_LAYERS['w8a8']`` (``reduced``), paged, K1
      int8: the int8 GEMM runs, and one prefill's logits and census (a
      MAX all-reduce before each row-parallel product) are checked too;
    - 'moe': mixtral-8x7b int8 at full width, depth
      ``MESH_OPTS_LAYERS['moe']`` (``reduced``; the first layers of
      serve_moe's weights), paged, K1 int8.

    ``serving_mesh(tp=2)`` must still raise on one card. Returns the
    case's launches of its path kernel: K1 for the paged cases, K3 (and
    K4, the slot engine's first prefill chunks) for 'spec_slot'."""
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    try:
        mesh_lib.serving_mesh(tp=2, device='cuda')
        refused = False
    except ValueError:
        refused = True
    require(refused or torch.cuda.device_count() >= 2,
            'serving_mesh(tp=2) did not raise on one card')
    extra = {'serving_mesh_tp2_refused': refused}
    cfg = cfg or configs.LLAMA2_7B
    prompts = _prompts(seed, cfg.vocab_size)[:MESH_OPTS_REQUESTS]
    if case == 'bank':
        cfg, params, cut = _first_layers(cfg, params,
                                         MESH_OPTS_LAYERS['bank'])
        trees = {f'm{i}': _lora_tree(cfg, seed * 1000 + 50 + i)
                 for i in range(2)}
        reqs = [(p, {'adapter': 'm0'} if i == 0 else
                 {'adapter': 'm1'} if i == 2 else {})
                for i, p in enumerate(prompts)]
        line = _mesh_opts_case(
            torch, case, cfg, params, reqs, adapters=trees,
            extra=dict(extra, weights='bfloat16', adapter_rows=2,
                       base_rows=2, reduced=cut),
            adapter_slots=2, adapter_rank=LORA_RANK)
        k1 = line['kernel_launches'].get('paged_decode_attention[bf16]', 0)
        require(k1 > 0, 'serve_mesh1_opts[bank]: K1 never launched')
        return {'paged_decode_attention[bf16]': k1}
    if case == 'spec_slot':
        reqs = [(p, {}) for p in
                _spec_prompts(seed, cfg.vocab_size)[:MESH_OPTS_REQUESTS]]
        line = _mesh_opts_case(
            torch, case, cfg, params, reqs, kind='slot',
            extra=dict(extra, weights='bfloat16',
                       spec_prompts=f'{SPEC_SEGMENT}-token segment '
                                    'repeated'),
            speculate_k=SPEC_K)
        k3 = line['k3_launches_by_sq'].get(SPEC_K + 1, 0)
        rounds = line['spec']['mesh']['spec_rounds']
        require(k3 > 0 and k3 == cfg.n_layers * rounds,
                f'serve_mesh1_opts[spec_slot]: K3 launches at sq='
                f'{SPEC_K + 1} {k3} != n_layers x rounds {rounds}')
        return {'flash_fwd_chunk':
                    line['kernel_launches'].get('flash_fwd_chunk', 0),
                'flash_fwd': line['kernel_launches'].get('flash_fwd', 0)}
    if case == 'w8a8':
        import numpy as np
        cfg, params, cut = _first_layers(cfg, params,
                                         MESH_OPTS_LAYERS['w8a8'])
        tokens = np.asarray(prompts[0][:64], np.int32)[None]
        line = _mesh_opts_case(
            torch, case, cfg, params, [(p, {}) for p in prompts],
            prefill_tokens=tokens,
            extra=dict(extra, weights='int8', reduced=cut),
            prefill_w8a8=True)
        k1 = line['kernel_launches'].get('paged_decode_attention[int8]', 0)
        require(k1 > 0 and line['int_mm_launches'] > 0,
                f'serve_mesh1_opts[w8a8]: K1 {k1}, int8 GEMMs '
                f'{line["int_mm_launches"]}')
        return {'paged_decode_attention[int8]': k1}
    if case == 'moe':
        cfg, params, reduced = _first_layers(
            cfg, params, MESH_OPTS_LAYERS['moe'],
            full_layers=(reduced or {}).get('n_layers', [None])[0])
        line = _mesh_opts_case(
            torch, case, cfg, params, [(p, {}) for p in prompts],
            extra=dict(extra, weights='int8',
                       weights_built_on_card_from_seed=True,
                       reduced=reduced))
        k1 = line['kernel_launches'].get('paged_decode_attention[int8]', 0)
        require(k1 > 0, 'serve_mesh1_opts[moe]: K1 never launched')
        return {'paged_decode_attention[int8]': k1}
    raise ValueError(f'unknown serve_mesh1_opts case {case!r}')


def _card_label():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _seat(torch, eng, prompts, **req_kw):
    """``prompts`` admitted and prefilled in full (no decode yet), so
    every request's decode calls start together; returns the ids."""
    rids = [eng.add_request(list(p), max_new_tokens=N_NEW, **req_kw)
            for p in prompts]
    while eng._queue or eng._prefill_off:
        eng._admit()
    torch.cuda.synchronize()
    return rids


def _poison_kv(eng) -> int:
    """Every row of ``eng``'s KV cache or pool, scales included, set in
    place to a pattern no export carries (0.5 in a float tensor, 0x55 in
    a code tensor). Returns the tensors filled."""
    n = 0
    for name in ('k', 'v', 'pool_k', 'pool_v', 'k_scale', 'v_scale'):
        t = getattr(eng.cache, name, None)
        if t is not None:
            t.fill_(0.5 if t.is_floating_point() else 0x55)
            n += 1
    return n


def _handoff_case(torch, make, prompts, kernel_keys):
    """One handoff case on two engines over the same weights. ``ref``
    serves the prompts uninterrupted (seated, then decode calls of
    KV_DECODE_FIRST steps). ``src`` seats them too, runs one decode call
    of KV_DECODE_FIRST steps, exports every request (drained first; one
    sanctioned readback each), which goes through the wire codec and is
    cancelled. ``ref``, idle again and with its graphs captured, has its
    whole cache overwritten with a fixed pattern (``_poison_kv``: the
    rows its own run left in the slots and pages the ingest reuses must
    not pass for landed ones), then ingests the snapshots and runs them
    to completion: each stream must equal its uninterrupted one bit for
    bit (the decode call boundaries are the same), and no graph is
    captured. Launch counts are set to 0 just before ``src`` seats its
    prompts and read after the ingested run. Returns the phase line's
    measurements."""
    from skypilot_tpu_torch.inference import kv_transfer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.utils import device as dev
    ref = make()
    rids = _seat(torch, ref, prompts)
    done = ref.run_to_completion(horizon=KV_DECODE_FIRST)
    want = [done[r].output for r in rids]
    for r in rids:
        ref.pop_finished(r)
    captures0 = ref.graph_stats()['graph_captures']
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    src = make()
    steps0 = ref.decode_substeps
    rids = _seat(torch, src, prompts)
    src.step(horizon=KV_DECODE_FIRST)
    src.drain_pipeline()
    export_ms, wire, blobs = [], [], []
    for r in rids:
        n0 = dev.host_sync_count()
        t0 = time.perf_counter()
        snap, events = src.export_kv_snapshot(r)
        export_ms.append((time.perf_counter() - t0) * 1e3)
        require(snap is not None and not events
                and dev.host_sync_count() - n0 == 1,
                'an export is one sanctioned readback of a decoding request')
        require(len(snap['output']) == 1 + KV_DECODE_FIRST,
                f'exported after {len(snap["output"])} tokens')
        blobs.append(kv_transfer.encode_handoff(snap))
        wire.append(len(blobs[-1]))
        src.cancel(r)
    src_steps = src.decode_substeps
    src_calls = dict(getattr(src, 'prefill_calls', {}))
    del src, snap
    _release(torch)
    require(_poison_kv(ref) >= 2, 'no KV tensor to poison')
    ingest_ms, new = [], []
    for blob in blobs:
        snap = kv_transfer.decode_handoff(blob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new.append(ref.ingest_kv_snapshot(snap))
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
    del blobs, snap
    done = ref.run_to_completion(horizon=KV_DECODE_FIRST)
    got = [done[r].output for r in new]
    counts = {k: n for k, n in list(pa.launch_counts.items())
              + list(fa.launch_counts.items()) if n}
    steps = src_steps + ref.decode_substeps - steps0
    require(got == want, 'a handed-off stream differs from the '
            'uninterrupted run: ' + str([i for i, (g, w) in
                                         enumerate(zip(got, want))
                                         if g != w]))
    require(ref.graph_stats()['graph_captures'] == captures0,
            'the decode after the ingest captured a graph')
    for key, want_n in kernel_keys(ref.cfg, steps, src_calls).items():
        require(counts.get(key, 0) == want_n,
                f'{key} launches {counts.get(key, 0)} != {want_n}')
    require(set(counts) == set(kernel_keys(ref.cfg, steps, src_calls)),
            f'other kernels launched on the handoff path: {counts}')
    stats = ref.kv_pool_stats()
    del ref
    _release(torch)
    return {'streams_equal': True, 'receiver_kv_poisoned': True,
            'requests': len(got),
            'exported_after_tokens': 1 + KV_DECODE_FIRST,
            'export_ms': export_ms,
            'export_ms_median': float(sorted(export_ms)[len(export_ms) // 2]),
            'wire_bytes': wire, 'wire_bytes_total': sum(wire),
            'kv_token_bytes': stats['kv_token_bytes'],
            'ingest_ms': ingest_ms,
            'ingest_ms_median': float(sorted(ingest_ms)[len(ingest_ms) // 2]),
            'graph_captures_after_ingest': 0, 'decode_steps': steps,
            'kernel_launches': counts}


def phase_kv_handoff(torch, seed, params):
    """KV handoff on llama2-7b at full width (the ``serve`` phase's bf16
    weights) through the paged engine: bf16, int8 and int4 pools on K1
    (``pallas``) and an int8 pool on K2 (``cross_layer``), each pool
    KV_N_PAGES pages of 128 rows (two auto-sized pools would not fit
    beside the weights). See ``_handoff_case``. Returns the launches by
    kernel key. Depth cut to CUT_LAYERS (``reduced``)."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    cfg, params, cut = _cut_7b(params)
    prompts = _prompts(seed, cfg.vocab_size)
    card = _card_label()
    launches = {}
    for impl, kv in (('pallas', 'bf16'), ('pallas', 'int8'),
                     ('pallas', 'int4'), ('cross_layer', 'int8')):
        key = ('paged_decode_attention_fused' if impl == 'cross_layer'
               else 'paged_decode_attention') + f'[{kv}]'

        def make(impl=impl, kv=kv):
            eng = PagedInferenceEngine(cfg, params, max_batch=8,
                                       max_seq=2048, n_pages=KV_N_PAGES,
                                       kv_cache_dtype=kv, decode_impl=impl)
            require(eng.decode_impl == impl and eng.kv_cache_dtype == kv,
                    f'engine resolved to {eng.decode_impl}/'
                    f'{eng.kv_cache_dtype}')
            return eng
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        line = _handoff_case(
            torch, make, prompts,
            lambda c, steps, _, key=key: {key: c.n_layers * steps})
        launches[key] = line['kernel_launches'].get(key, 0)
        emit({'phase': 'kv_handoff', 'card': card, 'model': cfg.name,
              'reduced': cut, 'kv_cache': 'paged', 'kv_cache_dtype': kv,
              'decode_impl': impl, 'n_pages': KV_N_PAGES, 'page': 128,
              'prompt_lens': PROMPT_LENS, 'new_tokens': N_NEW, **line,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
              't_s': time.monotonic() - t0})
    return launches


def phase_kv_handoff_slot(torch, seed, params):
    """The same handoff on the slot engine (bf16 cache, max_seq
    KV_SLOT_MAX_SEQ): prefill on K4 (first chunks) and K3 (chunks
    against the cache) in the source engine, decode in the slot
    engine's graphs. Returns (K4, K3) launches."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import configs
    cfg = configs.LLAMA2_7B
    prompts = _prompts(seed, cfg.vocab_size)

    def make():
        return InferenceEngine(cfg, params, max_batch=8,
                               max_seq=KV_SLOT_MAX_SEQ)

    def kernel_keys(c, steps, calls):
        del steps
        return {'flash_fwd': c.n_layers * calls['uncached'],
                'flash_fwd_chunk': c.n_layers * calls['cached']}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    line = _handoff_case(torch, make, prompts, kernel_keys)
    k4 = line['kernel_launches'].get('flash_fwd', 0)
    k3 = line['kernel_launches'].get('flash_fwd_chunk', 0)
    require(k4 > 0 and k3 > 0, f'K4 {k4}, K3 {k3} launches')
    emit({'phase': 'kv_handoff_slot', 'card': _card_label(),
          'model': cfg.name, 'kv_cache': 'slot', 'kv_cache_dtype': 'bf16',
          'max_seq': KV_SLOT_MAX_SEQ,
          'cache_bytes': 8 * KV_SLOT_MAX_SEQ * line['kv_token_bytes'],
          'prompt_lens': PROMPT_LENS, 'new_tokens': N_NEW, **line,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
          't_s': time.monotonic() - t0})
    return k4, k3


def _serve_one_by_one(port, prompts):
    """Each prompt as a streamed ``/generate`` request, one after the
    other (a lone request's decode calls do not depend on other
    traffic): returns (token lists, client TTFTs in ms)."""
    toks, ttfts = [], []
    for p in prompts:
        events, ttft = _post(f'http://127.0.0.1:{port}/generate',
                             {'prompt': p, 'max_new_tokens': N_NEW,
                              'temperature': 0.0, 'stream': True}, True)
        toks.append(_served_tokens('/generate', True, events))
        ttfts.append(ttft)
    return toks, ttfts


def phase_kv_checkpoint(torch, seed, params):
    """The spot-recovery loop with one model on the card at a time:
    server A (llama2-7b, the ``serve`` weights, paged bf16 on K1) serves
    8 prompts that share a KV_PREFIX-token prefix one by one (the first
    cold, the rest hitting A's own cache), writes its checkpoint to a
    file through ``POST /checkpoint {"path"}`` and stops; server B
    warm-boots from that file (``checkpoint_path``) and serves the same
    prompts: every prompt must hit the prefix and every stream must equal
    A's. Each server first serves one unrelated prompt of the same
    length class, untimed, so the decode graphs those prompts use are
    captured before any timed request (a first use captures inside the
    request's TTFT). K1 launches are counted over B's requests. Returns
    them."""
    import tempfile
    import numpy as np
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer
    rng = np.random.default_rng(seed + 11)
    vocab = 32000
    prefix = [int(t) for t in rng.integers(3, vocab, KV_PREFIX)]
    prompts = [prefix + [int(t) for t in rng.integers(3, vocab, n)]
               for n in KV_TAILS]
    keys_prompt = [int(t) for t in rng.integers(3, vocab, KV_PREFIX + 64)]
    card = _card_label()
    cut_cfg, params, cut = _cut_7b(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'kv.ckpt')
        lines = {}
        for name in ('cold', 'warm'):
            torch.cuda.reset_peak_memory_stats()
            port = _free_port()
            t0 = time.monotonic()
            _fresh_registry()
            srv = ModelServer(cut_cfg, max_batch=8, max_seq=2048,
                              port=port, params=params,
                              checkpoint_path=path if name == 'warm'
                              else None)
            srv.start(block=False)
            try:
                srv.wait_ready(timeout=600)
                ready_s = time.monotonic() - t0
                eng = srv.engine
                _serve_one_by_one(port, [keys_prompt])
                hits0 = eng.alloc.prefix_hits
                steps0 = eng.decode_substeps
                pa.reset_launch_counts()
                toks, ttfts = _serve_one_by_one(port, prompts)
                launches = dict(pa.launch_counts)
                line = {'ready_s': ready_s, 'ttft_ms': ttfts,
                        'graph_captures': eng.graph_stats()[
                            'graph_captures'],
                        'prefix_hits': eng.alloc.prefix_hits - hits0,
                        'decode_steps': eng.decode_substeps - steps0,
                        'kernel_launches': {k: n for k, n in
                                            launches.items() if n},
                        'warm_boot': srv.warm_boot, 'tokens': toks,
                        'n_pages': eng.alloc.n_pages,
                        'peak_mem_gb':
                            torch.cuda.max_memory_allocated() / 1e9}
                if name == 'cold':
                    body, _ = _post(f'http://127.0.0.1:{port}/checkpoint',
                                    {'path': path}, False)
                    line['checkpoint'] = body
            finally:
                srv.stop()
            lines[name] = line
            cfg = eng.cfg
            del eng, srv
            _release(torch)
    cold, warm = lines['cold'], lines['warm']
    key = 'paged_decode_attention[bf16]'
    k1 = warm['kernel_launches'].get(key, 0)
    require(warm['warm_boot'] is not None
            and warm['warm_boot']['warmed_rows'] >= KV_PREFIX,
            f'warm boot landed {warm["warm_boot"]}')
    require(warm['prefix_hits'] >= len(prompts),
            f'{warm["prefix_hits"]} prefix hits for {len(prompts)} prompts')
    require(warm['tokens'] == cold['tokens'],
            'the warm server\'s streams differ from the cold server\'s')
    require(k1 == cfg.n_layers * warm['decode_steps'] > 0
            and set(warm['kernel_launches']) == {key},
            f'K1 launches {warm["kernel_launches"]} for '
            f'{warm["decode_steps"]} decode steps')
    emit({'phase': 'kv_checkpoint', 'card': card, 'model': cfg.name,
          'kv_cache': 'paged', 'kv_cache_dtype': 'bf16',
          'prefix_tokens': KV_PREFIX, 'tails': list(KV_TAILS),
          'new_tokens': N_NEW, 'streams_equal': True,
          'checkpoint': cold.pop('checkpoint'),
          'ttft_cold_ms': cold['ttft_ms'][0],
          'ttft_warm_ms_median': float(np.median(warm['ttft_ms'])),
          'ttft_a_own_cache_ms_median': float(np.median(cold['ttft_ms'][1:])),
          **{f'{n}_{k}': lines[n][k] for n in ('cold', 'warm')
             for k in ('ttft_ms', 'prefix_hits', 'ready_s', 'decode_steps',
                       'kernel_launches', 'peak_mem_gb', 'n_pages',
                       'graph_captures')},
          'warm_boot': warm['warm_boot'], 'reduced': cut})
    return k1


def phase_kv_audit(torch):
    """``audit_handoff`` at llama2-7b's width, depth cut to AUDIT_LAYERS,
    under the sync debug mode: the decode after an ingest (paged bf16
    and int8, slot bf16) and after a ``warm_prefix`` (paged) replays the
    warm-up's graphs, with no unsanctioned sync, the landing
    included."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    cfg = _spec_cfg(torch, torch.bfloat16)
    saved = graphs._snapshot()
    for kind, what, kv in (('paged', 'ingest', 'bf16'),
                           ('paged', 'ingest', 'int8'),
                           ('paged', 'warm', 'bf16'),
                           ('slot', 'ingest', 'bf16')):
        report = audit.audit_handoff(kind, what, cfg=cfg, kv_cache_dtype=kv)
        emit({'phase': 'kv_audit', 'model': cfg.name,
              'reduced': {'n_layers': [32, AUDIT_LAYERS]},
              **report.as_dict()})
        require(report.ok() and report.captures[0] > 0
                and report.landed_rows > 0
                and (what != 'warm' or report.prefix_hits > 0),
                f'{report.name}: {report.violations()}')
        _release(torch)
    graphs._restore(saved)


# ------------------------------------------------------- the serving front
SCHED_TP = (16, (512, 1024), 128)     # throughput tier: n, prompt lens, new
SCHED_LAT = (8, (32, 64), 16)         # latency tier: n, prompt lens, new
SCHED_LAT_GAP_S = 0.25                # latency arrivals, one each 0.25 s
SCHED_LAT_START_S = 0.5               # ... after the throughput backlog
SHED_BOUND = 1024                     # sched_shed's max_queue_tokens
SHED_FLOOD = 20                       # sched_shed's requests, all at once:
                                      # 8 run, 8 queue, 4 are refused
SHED_REDUCED = {'max_queue_tokens': [4096, SHED_BOUND],
                'flood': [56, SHED_FLOOD]}    # cut for the time limit
SHED_PROMPT, SHED_NEW = 16, 112       # each: 128 work tokens
DRAIN_NEW = 128                       # sched_drain's new tokens a request


def _http(port, path, body=None, headers=None, timeout=600):
    """One request to the server on ``port``: (status, headers, body
    bytes). An HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if body is None else json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _sse_timed(port, path, body, headers=None, timeout=600):
    """A streamed request read line by line: (status, events, client ms
    from the send to the first token and to the last). An HTTP error
    status comes back with its JSON body as the one event."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    t0 = time.monotonic()
    events, first, last = [], None, None
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith('data:'):
                    continue
                data = line[5:].strip()
                now = (time.monotonic() - t0) * 1e3
                if data == '[DONE]':
                    continue
                ev = json.loads(data)
                if 'token' in ev:
                    first = now if first is None else first
                    last = now
                events.append(ev)
            return r.status, events, first, last
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())], None, None


def _pct(xs, q):
    """The q-quantile of ``xs`` by the registry's rule (index
    ``int(q * n)`` of the sorted values), 0 when empty."""
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(q * len(xs)))]) if xs else 0.0


def _sched_server(params, seed, cfg='llama2-7b', **kw):
    """A llama2-7b ``ModelServer`` (or ``cfg``) over ``params`` on a
    fresh process registry (its ``/metrics`` then counts only this
    server), ready."""
    from skypilot_tpu_torch.serve.server import ModelServer
    from skypilot_tpu_torch.telemetry import tracing
    _fresh_registry()
    tracing.get_trace_buffer().clear()
    port = _free_port()
    srv = ModelServer(cfg, max_batch=8, max_seq=2048, port=port,
                      seed=seed, params=params, **kw)
    srv.start(block=False)
    try:
        srv.wait_ready(timeout=600)
    except Exception:
        srv.stop()
        raise
    return srv, port


def _sched_prompts(seed, vocab, n_tp, n_lat):
    import numpy as np
    rng = np.random.default_rng(seed + 23)

    def draw(n, lens):
        return [[int(t) for t in rng.integers(
            3, vocab, int(rng.integers(lens[0], lens[1] + 1)))]
            for _ in range(n)]
    return draw(n_tp, SCHED_TP[1]), draw(n_lat, SCHED_LAT[1])


def _sched_mix(port, tp, lat, tiered):
    """The throughput requests all at once, then the latency requests
    at SCHED_LAT_GAP_S intervals into the backlog, every one a streamed
    ``/generate``; tiers from the ``slo_tier`` field (``tiered``) or all
    in the throughput tier. Returns per-kind records (client TTFT and
    TPOT from the token events) and the wall seconds."""
    import threading
    jobs = ([(0.0, 'throughput', p, SCHED_TP[2]) for p in tp]
            + [(SCHED_LAT_START_S + i * SCHED_LAT_GAP_S, 'latency', p,
                SCHED_LAT[2]) for i, p in enumerate(lat)])
    out = [None] * len(jobs)
    errors = []
    t_start = time.monotonic()

    def run(i, delay, kind, prompt, new):
        time.sleep(max(0.0, t_start + delay - time.monotonic()))
        try:
            status, events, first, last = _sse_timed(
                port, '/generate', {
                    'prompt': prompt, 'max_new_tokens': new,
                    'temperature': 0.0, 'stream': True,
                    'slo_tier': kind if tiered else 'throughput'})
            done = events[-1] if events else {}
            require(status == 200 and done.get('done'),
                    f'{kind} request: HTTP {status} {events[-1:]}')
            n = len(done['tokens'])
            out[i] = {'kind': kind, 'tokens': n, 'ttft_ms': first,
                      'tpot_ms': ((last - first) / (n - 1) if n > 1
                                  else None)}
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'{kind}: {type(e).__name__}: {e}')

    threads = [threading.Thread(target=run, args=(i,) + job)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    require(not errors, f'requests failed: {errors}')
    for rec, (_, kind, _, new) in zip(out, jobs):
        require(rec['tokens'] == new,
                f'a {kind} request brought {rec["tokens"]} tokens, want {new}')
    by_kind = {}
    for kind in ('latency', 'throughput'):
        recs = [r for r in out if r['kind'] == kind]
        ttft = [r['ttft_ms'] for r in recs]
        tpot = [r['tpot_ms'] for r in recs if r['tpot_ms'] is not None]
        by_kind[kind] = {'requests': len(recs),
                         'client_ttft_ms_p50': _pct(ttft, 0.5),
                         'client_ttft_ms_p90': _pct(ttft, 0.9),
                         'client_tpot_ms_p50': _pct(tpot, 0.5)}
    return by_kind, wall


def _tier_block(port):
    """Per tier from ``/metrics?format=json``: TTFT p50/p90 (admission
    to first token), queue wait p50/p90 (submit to admission), TPOT
    median and the admitted count."""
    _, _, body = _http(port, '/metrics?format=json')
    tiers = json.loads(body)['sched']['tiers']
    keys = ('admitted', 'ttft_ms_median', 'ttft_ms_p90',
            'queue_wait_ms_median', 'queue_wait_ms_p90', 'tpot_ms_median')
    return {t: {k: v[k] for k in keys} for t, v in tiers.items()}


def phase_serve_sched(torch, seed, params, kv_cache='paged',
                      phase='serve_sched', scale=1, cut=False):
    """The SLO scheduler on llama2-7b at full width (the ``serve``
    weights), 8 slots: SCHED_TP throughput-tier requests (512-1024-token
    prompts, 128 new tokens) at once, then SCHED_LAT latency-tier
    requests (32-64-token prompts, 16 new tokens) arriving at 0.25 s
    intervals into the backlog (``scale`` divides both counts). Run
    twice on fresh servers: with the tiers, and with every request in
    the throughput tier. Each request must bring its full count, and the
    tiered run must admit every latency request in the latency tier. The
    paged engine decodes on K1 (once per layer per decode step, no other
    kernel), the slot engine prefills on K4/K3 (once per layer per
    prefill call). ``cut`` serves CUT_LAYERS of the 32 layers
    (``_cut_7b``). Returns the launches of the tiered run by kernel."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    model, reduced = 'llama2-7b', {}
    if cut:
        model, params, reduced = _cut_7b(params)
    if scale > 1:
        reduced = dict(reduced, requests_divided_by=scale)
    n_tp, n_lat = SCHED_TP[0] // scale, SCHED_LAT[0] // scale
    tp, lat = _sched_prompts(seed, 32000, n_tp, n_lat)
    card = _card_label()
    runs, launches = {}, None
    for tiered in (True, False):
        torch.cuda.reset_peak_memory_stats()
        srv, port = _sched_server(params, seed, cfg=model,
                                  kv_cache=kv_cache)
        try:
            eng = srv.engine
            steps0 = eng.decode_substeps
            calls0 = dict(getattr(eng, 'prefill_calls', {}))
            pa.reset_launch_counts()
            fa.reset_launch_counts()
            by_kind, wall = _sched_mix(port, tp, lat, tiered)
            counts = {k: n for k, n in list(pa.launch_counts.items())
                      + list(fa.launch_counts.items()) if n}
            steps = eng.decode_substeps - steps0
            cfg = eng.cfg
            if kv_cache == 'paged':
                want = {'paged_decode_attention[bf16]': cfg.n_layers * steps}
            else:
                calls = {k: eng.prefill_calls[k] - calls0[k] for k in calls0}
                want = {'flash_fwd': cfg.n_layers * calls['uncached'],
                        'flash_fwd_chunk': cfg.n_layers * calls['cached']}
                want = {k: n for k, n in want.items() if n}
            require(counts == want and steps > 0,
                    f'{phase} launches {counts}, want {want}')
            tiers = _tier_block(port)
            if tiered:
                launches = counts
                require(tiers['latency']['admitted'] == n_lat,
                        f'latency tier admitted {tiers["latency"]}')
            runs['tiered' if tiered else 'one_tier'] = {
                'by_kind': by_kind, 'tiers': tiers, 'wall_s': wall,
                'output_tok_s': (n_tp * SCHED_TP[2]
                                 + n_lat * SCHED_LAT[2]) / wall,
                'decode_steps': steps, 'kernel_launches': counts,
                'graph_captures': eng.graph_stats()['graph_captures'],
                'pool_token_capacity':
                    eng.kv_pool_stats()['pool_token_capacity'],
                'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
        finally:
            srv.stop()
        del eng, srv
        _release(torch)
    emit({'phase': phase, 'card': card, 'model': 'llama2-7b',
          'reduced': reduced or None,
          'kv_cache': kv_cache, 'kv_cache_dtype': 'bf16', 'max_batch': 8,
          'throughput_requests': [n_tp, list(SCHED_TP[1]), SCHED_TP[2]],
          'latency_requests': [n_lat, list(SCHED_LAT[1]), SCHED_LAT[2]],
          'latency_arrival_gap_s': SCHED_LAT_GAP_S, **runs})
    return launches


def phase_sched_shed(torch, seed, params):
    """Load shedding at ``max_queue_tokens=SHED_BOUND``: after a warm-up
    batch (so the throughput meter behind ``Retry-After`` is warm),
    SHED_FLOOD requests of SHED_PROMPT + SHED_NEW work tokens arrive at
    once in one tier. Every refusal must be a 429 with an integer
    ``Retry-After`` >= 1 (the body's ``retry_after_s`` the same);
    ``skytpu_sched_shed_total`` in the Prometheus text must equal the
    429s seen; each refused request, sent again after its
    ``Retry-After``, must complete with its full count. K1 launches once
    per layer per decode step. Returns them."""
    import threading
    import numpy as np
    from skypilot_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(seed + 31)
    prompts = [[int(t) for t in rng.integers(3, 32000, SHED_PROMPT)]
               for _ in range(SHED_FLOOD + 8)]
    srv, port = _sched_server(params, seed, max_queue_tokens=SHED_BOUND,
                              slo_tier_default='throughput')
    try:
        eng = srv.engine
        # The warm-up runs long enough (64 tokens a slot) for the
        # meter's output rate to be the engine's, not a start-up ramp.
        warm = [threading.Thread(target=_http, args=(
            port, '/generate', {'prompt': p, 'max_new_tokens': 64}))
            for p in prompts[SHED_FLOOD:]]
        for t in warm:
            t.start()
        for t in warm:
            t.join()
        steps0 = eng.decode_substeps
        pa.reset_launch_counts()
        lock = threading.Lock()
        refusals, done, errors = [], [], []

        def run(prompt):
            try:
                for attempt in range(8):
                    status, headers, body = _http(
                        port, '/generate', {'prompt': prompt,
                                            'max_new_tokens': SHED_NEW})
                    if status == 200:
                        with lock:
                            done.append((len(json.loads(body)['tokens']),
                                         attempt))
                        return
                    err = json.loads(body)['error']
                    retry = headers['Retry-After']
                    with lock:
                        refusals.append((status, retry, err['retry_after_s'],
                                         err['reason']))
                    require(status == 429 and retry.isdigit()
                            and int(retry) >= 1
                            and err['retry_after_s'] == int(retry),
                            f'refusal {status} Retry-After {retry!r} {err}')
                    time.sleep(int(retry))
                raise RuntimeError('refused 8 times')
            except Exception as e:  # pylint: disable=broad-except
                errors.append(f'{type(e).__name__}: {e}')

        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(p,))
                   for p in prompts[:SHED_FLOOD]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        launches = pa.launch_counts['paged_decode_attention[bf16]']
        steps = eng.decode_substeps - steps0
        _, _, text = _http(port, '/metrics')
        shed_series = sum(
            float(line.rsplit(' ', 1)[1]) for line in text.decode().splitlines()
            if line.startswith('skytpu_sched_shed_total{'))
        require(not errors, f'flood requests failed: {errors[:4]}')
        require(refusals, 'the flood overflowed no queue')
        require(len(done) == SHED_FLOOD
                and all(n == SHED_NEW for n, _ in done),
                f'completions {done}')
        require(shed_series == len(refusals),
                f'skytpu_sched_shed_total {shed_series} != '
                f'{len(refusals)} 429s')
        require(launches == eng.cfg.n_layers * steps > 0,
                f'K1 launches {launches} for {steps} decode steps')
        retries = [int(r[1]) for r in refusals]
        emit({'phase': 'sched_shed', 'card': _card_label(),
              'model': 'llama2-7b', 'max_queue_tokens': SHED_BOUND,
              'requests': SHED_FLOOD, 'reduced': SHED_REDUCED,
              'work_tokens_each':
                  SHED_PROMPT + SHED_NEW,
              'refused_429': len(refusals), 'shed_total_prometheus':
                  shed_series, 'retry_after_s': sorted(retries),
              'attempts_max': max(a for _, a in done) + 1,
              'completed': len(done), 'wall_s': wall,
              'decode_steps': steps, 'kernel_launches': launches})
    finally:
        srv.stop()
    del eng, srv
    _release(torch)
    return launches


def phase_sched_drain(torch, seed, params):
    """Graceful drain: 8 streamed requests (a shared KV_PREFIX-token
    prefix and KV_TAILS tails, DRAIN_NEW new tokens) in flight, then
    ``POST /drain``. Every one must finish with its full count, a new
    submit must get a 503 with ``Retry-After``, ``/readiness`` must say
    ``draining``, and the checkpoint must be written to
    ``checkpoint_path`` as the drain begins; a fresh server warm-booted
    from the file must hit the shared prefix on each prompt. K1 once per
    layer per decode step over the drained requests. Depth cut to
    CUT_LAYERS (``reduced``). Returns those launches."""
    import tempfile
    import threading
    import numpy as np
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg, params, cut = _cut_7b(params)
    rng = np.random.default_rng(seed + 37)
    prefix = [int(t) for t in rng.integers(3, 32000, KV_PREFIX)]
    prompts = [prefix + [int(t) for t in rng.integers(3, 32000, n)]
               for n in KV_TAILS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'kv.ckpt')
        srv, port = _sched_server(params, seed, cfg=cfg,
                                  checkpoint_path=path,
                                  drain_deadline_s=300)
        try:
            eng = srv.engine
            steps0 = eng.decode_substeps
            pa.reset_launch_counts()
            started = [threading.Event() for _ in prompts]
            results = [None] * len(prompts)

            def run(i, prompt):
                import urllib.request
                req = urllib.request.Request(
                    f'http://127.0.0.1:{port}/generate',
                    data=json.dumps({'prompt': prompt,
                                     'max_new_tokens': DRAIN_NEW,
                                     'stream': True}).encode(),
                    headers={'Content-Type': 'application/json'})
                events = []
                with urllib.request.urlopen(req, timeout=600) as r:
                    for raw in r:
                        line = raw.decode().strip()
                        if line.startswith('data:'):
                            events.append(json.loads(line[5:]))
                            started[i].set()
                results[i] = events

            threads = [threading.Thread(target=run, args=(i, p))
                       for i, p in enumerate(prompts)]
            for t in threads:
                t.start()
            for ev in started:
                require(ev.wait(300), 'a request never started')
            t0 = time.monotonic()
            status, _, body = _http(port, '/drain', {})
            drain = json.loads(body)
            inflight_at_drain = drain['inflight']
            shed = _http(port, '/generate', {'prompt': [5, 6, 7],
                                             'max_new_tokens': 4})
            ready = _http(port, '/readiness')
            for t in threads:
                t.join()
            while not json.loads(_http(port, '/drain')[2])['drained']:
                require(time.monotonic() - t0 < 300, 'drain never ended')
                time.sleep(0.05)
            drain_s = time.monotonic() - t0
            while not os.path.exists(path):
                require(time.monotonic() - t0 < 300, 'no checkpoint file')
                time.sleep(0.05)
            counts = [len(r[-1]['tokens']) if r and r[-1].get('done')
                      else None for r in results]
            launches = pa.launch_counts['paged_decode_attention[bf16]']
            steps = eng.decode_substeps - steps0
            require(status == 200 and drain['draining']
                    and inflight_at_drain == len(prompts),
                    f'POST /drain answered {status} {drain}')
            require(counts == [DRAIN_NEW] * len(prompts),
                    f'drained requests brought {counts}')
            require(shed[0] == 503 and shed[1]['Retry-After'].isdigit()
                    and json.loads(shed[2])['error']['reason'] == 'draining',
                    f'a submit during the drain: {shed[0]} {shed[2][:200]}')
            require(ready[0] == 503
                    and json.loads(ready[2])['status'] == 'draining',
                    f'/readiness during the drain: {ready[0]} {ready[2]}')
            require(launches == eng.cfg.n_layers * steps > 0,
                    f'K1 launches {launches} for {steps} decode steps')
            ckpt_bytes = os.path.getsize(path)
        finally:
            srv.stop()
        del eng, srv
        _release(torch)
        srv, port = _sched_server(params, seed, cfg=cfg,
                                  checkpoint_path=path)
        try:
            hits0 = srv.engine.alloc.prefix_hits
            replies = [None] * len(prompts)

            def send(i):
                replies[i] = _http(port, '/generate',
                                   {'prompt': prompts[i],
                                    'max_new_tokens': N_NEW})
            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            toks = [json.loads(r[2])['tokens'] for r in replies]
            hits = srv.engine.alloc.prefix_hits - hits0
            warm_boot = srv.warm_boot
        finally:
            srv.stop()
        _release(torch)
    require(warm_boot is not None and warm_boot['warmed_rows'] >= KV_PREFIX,
            f'warm boot landed {warm_boot}')
    require(hits >= len(prompts), f'{hits} prefix hits for {len(prompts)} '
            'prompts after the warm boot')
    require(all(len(t) == N_NEW for t in toks), 'warm server token counts')
    emit({'phase': 'sched_drain', 'card': _card_label(),
          'model': 'llama2-7b', 'reduced': cut,
          'requests_in_flight': inflight_at_drain,
          'new_tokens': DRAIN_NEW, 'completed_tokens': counts,
          'drain_s': drain_s, 'submit_during_drain': [
              shed[0], shed[1]['Retry-After']],
          'readiness_during_drain': ready[0], 'checkpoint_bytes': ckpt_bytes,
          'warm_boot': warm_boot, 'warm_prefix_hits': hits,
          'decode_steps': steps, 'kernel_launches': launches})
    return launches


TELEMETRY_TURNS = ('on', 'off')   # telemetry_tpot's servers, in turns


def phase_telemetry_audit(torch, seed, params):
    """Telemetry costs nothing at the device boundary:
    ``audit_telemetry_parity`` on both engines at llama2-7b's width,
    depth cut to AUDIT_LAYERS, under the sync debug mode (no unsanctioned
    sync, no steady-state capture, the same captures and the same
    streams bit for bit with telemetry off and on); then the ``serve``
    requests at full depth on a server with telemetry on and one with it
    off (``SKYTPU_TELEMETRY=0``), in turns (TELEMETRY_TURNS): the served
    TPOT and TTFT of each."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    cfg = _spec_cfg(torch, torch.bfloat16)
    saved = graphs._snapshot()
    for kind in ('paged', 'slot'):
        report = audit.audit_telemetry_parity(kind, cfg=cfg)
        emit({'phase': 'telemetry_audit', 'model': cfg.name,
              'reduced': {'n_layers': [32, AUDIT_LAYERS]},
              **report.as_dict()})
        require(report.ok() and report.streams_equal
                and report.captures_by_mode[0] > 0,
                f'{report.name}: {report.violations()}')
        _release(torch)
    graphs._restore(saved)
    served = {'on': [], 'off': []}
    for mode in TELEMETRY_TURNS:
        old = os.environ.get('SKYTPU_TELEMETRY')
        os.environ['SKYTPU_TELEMETRY'] = '1' if mode == 'on' else '0'
        try:
            srv, port = _sched_server(params, seed)
        finally:
            if old is None:
                os.environ.pop('SKYTPU_TELEMETRY', None)
            else:
                os.environ['SKYTPU_TELEMETRY'] = old
        try:
            require(srv.engine.telemetry_enabled == (mode == 'on'),
                    f'telemetry {mode}: engine says '
                    f'{srv.engine.telemetry_enabled}')
            saved = graphs._snapshot()
            _, ttfts, wall = _drive(port, srv.engine.cfg, seed, lambda: None)
            graphs._restore(saved)
            m = srv.metrics_json()
            served[mode].append({'tpot_ms_median': m['tpot_ms_median'],
                                 'ttft_ms_median_client':
                                     float(sorted(ttfts)[len(ttfts) // 2]),
                                 'wall_s': wall})
        finally:
            srv.stop()
        _release(torch)
    emit({'phase': 'telemetry_tpot', 'card': _card_label(),
          'model': 'llama2-7b', 'requests': len(PROMPT_LENS),
          'new_tokens': N_NEW, 'order': list(TELEMETRY_TURNS),
          'reduced': {'turns': [4, len(TELEMETRY_TURNS)]}, **served})


def _relay_streams(port, prompts, headers=None):
    """The prompts one by one, alternating a non-streamed
    ``/v1/completions`` and a streamed ``/generate`` (the routes a
    prefill worker hands off from): the completions' texts and the
    streams' token lists, and each streamed request's client TTFT."""
    out, ttfts = [], []
    for i, p in enumerate(prompts):
        if i % 2 == 0:
            status, _, body = _http(port, '/v1/completions',
                                    {'prompt': p, 'max_tokens': N_NEW,
                                     'temperature': 0.0, 'eos_id': None},
                                    headers)
            require(status == 200, f'/v1/completions: {status} {body[:200]}')
            body = json.loads(body)
            require(body['usage']['completion_tokens'] == N_NEW,
                    f'completion brought {body["usage"]}')
            out.append(body['choices'][0]['text'])
        else:
            status, events, first, _ = _sse_timed(
                port, '/generate', {'prompt': p, 'max_new_tokens': N_NEW,
                                    'temperature': 0.0, 'stream': True},
                headers)
            require(status == 200 and events[-1].get('done')
                    and len(events[-1]['tokens']) == N_NEW,
                    f'/generate stream: {status} {events[-1:]}')
            out.append(events[-1]['tokens'])
            ttfts.append(first)
    return out, ttfts


def phase_disagg_relay(torch, seed, params):
    """The prefill role's handoff relay with two llama2-7b servers on the
    one card over the same weights (the ``serve`` params, shared): a
    decode-role server, built first so that its auto-sized pool leaves
    room, and a prefill-role server whose static handoff target it is.
    The 8 prompts, one by one (a lone request's decode calls do not
    depend on other traffic), alternating non-streamed
    ``/v1/completions`` and streamed ``/generate``: first straight to the
    decode server (the colocated streams), then through the prefill
    server, whose every request must hand off (``sent == completed ==
    8``) and equal its colocated stream bit for bit. Then the decode
    server stops and one more request, named to it by
    ``X-Handoff-Target``, must fall back to local decoding
    (``fallback_local``) with its colocated tokens. K1 launches over the
    relayed requests (both servers). Depth cut to CUT_LAYERS
    (``reduced``). Returns them."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer
    from skypilot_tpu_torch.telemetry import registry
    cfg, params, cut = _cut_7b(params)
    prompts = _prompts(seed, 32000)
    _fresh_registry()
    torch.cuda.reset_peak_memory_stats()
    servers = []
    try:
        for role in ('decode', 'prefill'):
            port = _free_port()
            kw = ({'handoff_targets': [f'http://127.0.0.1:{servers[0][1]}']}
                  if role == 'prefill' else {})
            srv = ModelServer(cfg, max_batch=8, max_seq=2048,
                              port=port, seed=seed, params=params,
                              role=role, **kw)
            servers.append((srv, port))
            srv.start(block=False)
            srv.wait_ready(timeout=600)
        (dec, dport), (pre, pport) = servers
        pools = {name: s.engine.alloc.n_pages for name, s in
                 (('decode', dec), ('prefill', pre))}
        colo, colo_ttft = _relay_streams(dport, prompts)
        reg = registry.get_registry()

        def outcomes():
            return {o: int(reg.get('skytpu_disagg_handoff_total',
                                   outcome=o).value)
                    for o in ('sent', 'completed', 'failed',
                              'fallback_local', 'ingested')}
        before = outcomes()
        steps0 = dec.engine.decode_substeps + pre.engine.decode_substeps
        pa.reset_launch_counts()
        relayed, relay_ttft = _relay_streams(pport, prompts)
        launches = pa.launch_counts['paged_decode_attention[bf16]']
        steps = (dec.engine.decode_substeps + pre.engine.decode_substeps
                 - steps0)
        after = outcomes()
        delta = {k: after[k] - before[k] for k in after}
        kv_bytes = json.loads(_http(pport, '/metrics?format=json')[2])[
            'disagg']['kv_transfer_bytes']
        require(relayed == colo, 'a relayed stream differs from its '
                'colocated stream: ' + str([i for i, (a, b) in enumerate(
                    zip(relayed, colo)) if a != b]))
        require(delta['sent'] == delta['completed'] == delta['ingested']
                == len(prompts) and delta['failed'] == 0
                and delta['fallback_local'] == 0,
                f'handoff outcomes {delta}')
        require(launches == dec.engine.cfg.n_layers * steps > 0,
                f'K1 launches {launches} for {steps} decode steps')
        dec.stop()
        before = outcomes()
        local, _ = _relay_streams(
            pport, prompts[:1],
            headers={'X-Handoff-Target': f'http://127.0.0.1:{dport}'})
        fb = {k: outcomes()[k] - before[k] for k in before}
        require(local == colo[:1] and fb['fallback_local'] == 1
                and fb['sent'] == 0,
                f'fallback with the decode server down: {fb}')
        emit({'phase': 'disagg_relay', 'card': _card_label(),
              'model': 'llama2-7b', 'reduced': cut,
              'requests': len(prompts),
              'prompt_lens': PROMPT_LENS, 'new_tokens': N_NEW,
              'streams_equal': True, 'outcomes': delta,
              'fallback': fb, 'kv_transfer_bytes': kv_bytes,
              'n_pages': pools, 'page': pre.engine.page,
              'ttft_ms_colocated': colo_ttft, 'ttft_ms_relayed': relay_ttft,
              'decode_steps': steps, 'kernel_launches': launches,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9})
    finally:
        for srv, _ in servers:
            srv.stop()
    del servers
    _release(torch)
    return launches


# --------------------------------------------------------------------- 9
def _to_device(params, dev):
    """A copy of ``params`` on ``dev`` (always a copy: the trainer
    updates its params in place)."""
    from skypilot_tpu_torch.models.quantization import QUANT_LEAF_TYPES
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    if isinstance(params, QUANT_LEAF_TYPES):
        return type(params)(*(t.to(dev, copy=True) for t in params))
    return params.to(dev, copy=True)


def phase_reference(torch, seed):
    """A small fp32 model with head_dim 64 served on the card through
    the kernels and on the CPU through the plain paths, from the same
    weights (int8 codes quantized once on the CPU): the greedy tokens
    must be equal for each paged (weights, KV dtype, decode impl), and
    for the slot engine chunked (chunk 32: K4 and K3 on the card) and
    monolithic (K4)."""
    import dataclasses
    import numpy as np
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs, llama, quantization
    from skypilot_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(
        configs.TINY, name='smoke-d64', vocab_size=512, dim=256,
        n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256,
        dtype=torch.float32)
    cpu_params = llama.init_params(cfg, seed, device='cpu')
    trees = {None: cpu_params,
             'int8': quantization.quantize_params(cpu_params)}
    rng = np.random.default_rng(seed + 1)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, n)]
               for n in (9, 40, 75, 130)]
    prompts.append(prompts[3][:64] + [5, 6, 7])          # prefix hit
    results = []
    for quantize, kv, impl in ((None, 'bf16', 'pallas'),
                               ('int8', 'int8', 'pallas'),
                               ('int8', 'int8', 'cross_layer'),
                               ('int8', 'int4', 'cross_layer')):
        outs = {}
        for dev in ('cuda', 'cpu'):
            eng = PagedInferenceEngine(
                cfg, _to_device(trees[quantize], dev), max_batch=3,
                max_seq=256, page_size=16, prefill_chunk_tokens=32, n_pages=40,
                kv_cache_dtype=kv, decode_impl=impl, device=dev)
            rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
            done = eng.run_to_completion(horizon=8)
            outs[dev] = [done[r].output for r in rids]
        same = outs['cuda'] == outs['cpu']
        results.append({'weights': quantize or 'float32',
                        'kv_cache_dtype': kv, 'decode_impl': impl,
                        'greedy_equal_cuda_kernel_vs_cpu_plain': same})
        require(same, f'greedy streams differ ({quantize}, {kv}, {impl}): '
                      f'{outs}')
    for chunk in (32, 0):
        outs, launched = {}, None
        for dev in ('cuda', 'cpu'):
            before = dict(fa.launch_counts)
            eng = InferenceEngine(cfg, _to_device(cpu_params, dev),
                                  max_batch=3, max_seq=256,
                                  prefill_chunk_tokens=chunk, device=dev)
            rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
            done = eng.run_to_completion(horizon=8)
            outs[dev] = [done[r].output for r in rids]
            if dev == 'cuda':
                launched = {k: fa.launch_counts[k] - before[k]
                            for k in before}
                fa.launch_counts.update(before)    # not a main-path run
        same = outs['cuda'] == outs['cpu']
        results.append({'engine': 'slot', 'prefill_chunk_tokens': chunk,
                        'kernel_launches_cuda': launched,
                        'greedy_equal_cuda_kernel_vs_cpu_plain': same})
        require(same and launched['flash_fwd'] > 0
                and (chunk == 0 or launched['flash_fwd_chunk'] > 0),
                f'slot engine (chunk {chunk}): streams equal {same}, '
                f'launches {launched}: {outs}')
    emit({'phase': 'reference', 'model': cfg.name, 'dtype': 'float32',
          'prompts': len(prompts), 'new_tokens': 24, 'runs': results})
    for family in REF_FAMILIES:
        _reference_family(torch, seed, family, prompts)


# Small fp32 models at head_dim 64 (the tiny presets' 16 is below every
# kernel): Gemma's tied, scaled embeddings, x * (1 + w) norms and GeGLU
# with one kv head (group 4); Qwen2's q/k/v biases at group 7; a
# 4-expert top-2 MoE served at capacity factor 0.5, where decode drops
# expert choices; Llama with int4 weights (``quantize='int4'``, int4 KV
# on auto). ``gain`` multiplies the layers' v, o and FFN matrices: at
# gain 1 a random Gemma's sqrt(dim)-scaled, tied embedding dominates the
# residual stream and greedy decoding repeats the last prompt token
# whatever attention computes.
REF_FAMILIES = {
    'gemma': dict(preset='tiny-gemma', name='smoke-gemma-d64', dim=256,
                  n_heads=4, n_kv_heads=1, gain=3.0),
    'qwen2': dict(preset='tiny-qwen', name='smoke-qwen2-d64', dim=448,
                  n_heads=7, n_kv_heads=1, gain=1.0),
    'mixtral': dict(preset='tiny-moe', name='smoke-moe-d64', dim=256,
                    n_heads=4, n_kv_heads=2, gain=1.0, capacity=0.5),
    'int4': dict(preset='tiny', name='smoke-int4-d64', dim=256, n_heads=4,
                 n_kv_heads=2, gain=1.0, quantize='int4'),
}


def _perturbed_params(torch, cfg, seed, gain=1.0):
    """``llama.init_params`` on the CPU with every norm weight and q/k/v
    bias set to seeded random values (synthetic checkpoints hold unit
    norms and zero biases, which would hide a norm+1 or a bias that is
    never applied), and the v, o and FFN matrices times ``gain``."""
    from skypilot_tpu_torch.models import llama
    params = llama.init_params(cfg, seed, device='cpu')
    for k in ('wv', 'wo', 'w_gate', 'w_up', 'w_down'):
        if k in params['layers']:
            params['layers'][k] *= gain
    gen = torch.Generator().manual_seed(seed + 5)
    base = 0.0 if cfg.norm_plus_one else 1.0
    leaves = [(params, 'final_norm')] + [
        (params['layers'], k) for k in ('attn_norm', 'ffn_norm', 'bq', 'bk',
                                        'bv') if k in params['layers']]
    for tree, k in leaves:
        shift = base if 'norm' in k else 0.0
        tree[k] = torch.randn(tree[k].shape, generator=gen) * 0.3 + shift
    return params


def _reference_family(torch, seed, family, prompts):
    """One family's small fp32 model written as an HF checkpoint
    directory (``save_hf_checkpoint``), then loaded from it (int4 under
    ``quantize``; the MoE at its ``capacity`` factor) and served on the
    card (kernel paths) and on the CPU (plain paths): greedy tokens equal
    on the paged engine (``pallas``: K1) and the slot engine (chunked:
    K4 and K3; an int4 slot cache reads its chunks through the plain
    two-block softmax, as the reference does)."""
    import dataclasses
    import shutil
    import tempfile
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs, weights
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    spec = dict(REF_FAMILIES[family])
    gain = spec.pop('gain')
    capacity = spec.pop('capacity', None)
    quantize = spec.pop('quantize', None)
    cfg = dataclasses.replace(
        configs.get_config(spec.pop('preset')), vocab_size=512,
        ffn_dim=512, max_seq_len=256, dtype=torch.float32, **spec)
    require(cfg.head_dim == 64, f'{cfg.name}: head_dim {cfg.head_dim}')
    path = tempfile.mkdtemp(prefix='skt_smoke_ref_')
    try:
        weights.save_hf_checkpoint(path, cfg,
                                   _perturbed_params(torch, cfg, seed, gain))
        runs = []
        for engine, cls, kw in (
                ('paged', PagedInferenceEngine,
                 dict(page_size=16, prefill_chunk_tokens=32, n_pages=40,
                      decode_impl='pallas')),
                ('slot', InferenceEngine, dict(prefill_chunk_tokens=32))):
            outs, launched = {}, None
            for dev in ('cuda', 'cpu'):
                before = (dict(pa.launch_counts), dict(fa.launch_counts))
                loaded, params = weights.load_checkpoint(
                    path, dtype=torch.float32, quantize=quantize,
                    use_cache=False, device=dev)
                if capacity is not None:
                    loaded = dataclasses.replace(
                        loaded, moe_capacity_factor=capacity)
                eng = cls(loaded, params, max_batch=3, max_seq=256,
                          quantize=quantize, device=dev, **kw)
                require(eng.cfg.qkv_bias == (family == 'qwen2')
                        and eng.cfg.tie_embeddings == (family == 'gemma')
                        and eng.cfg.is_moe == (family == 'mixtral')
                        and eng.kv_cache_dtype == (quantize or 'bf16'),
                        f'{family}: loaded config {eng.cfg}, KV '
                        f'{eng.kv_cache_dtype}')
                rids = [eng.add_request(p, max_new_tokens=24)
                        for p in prompts]
                done = eng.run_to_completion(horizon=8)
                outs[dev] = [done[r].output for r in rids]
                if dev == 'cuda':
                    launched = {k: n - before[0][k] for k, n in
                                pa.launch_counts.items() if n > before[0][k]}
                    launched.update({k: n - before[1][k] for k, n in
                                     fa.launch_counts.items()
                                     if n > before[1][k]})
                    pa.launch_counts.update(before[0])    # not a main path
                    fa.launch_counts.update(before[1])
                del eng
            same = outs['cuda'] == outs['cpu']
            runs.append({'engine': engine, 'kernel_launches_cuda': launched,
                         'greedy_equal_cuda_kernel_vs_cpu_plain': same,
                         'distinct_tokens_per_stream': [
                             len(set(o)) for o in outs['cpu']]})
            pool = 'int4' if quantize == 'int4' else 'fp32'   # fp32 model
            want = ([f'paged_decode_attention[{pool}]'] if engine == 'paged'
                    else ['flash_fwd'] + (['flash_fwd_chunk'] if pool ==
                                          'fp32' else []))
            require(same and all(launched.get(k, 0) > 0 for k in want),
                    f'{family} {engine}: streams equal {same}, launches '
                    f'{launched}: {outs}')
        emit({'phase': 'reference', 'model': cfg.name, 'family': family,
              'dtype': 'float32', 'from_checkpoint': True,
              'weights': quantize or 'float32',
              'moe_capacity_factor': capacity,
              'heads': [cfg.n_heads, cfg.n_kv_heads],
              'head_dim': cfg.head_dim, 'prompts': len(prompts),
              'new_tokens': 24, 'runs': runs})
    finally:
        shutil.rmtree(path, ignore_errors=True)


# -------------------------------------------------------------------- 10
TRAIN_STEPS = 6
TRAIN_BATCH = TRAIN_ATTN['b']
TRAIN_SEQ = TRAIN_ATTN['sq']
TOL_TRAIN_REF = 1e-4           # card vs CPU, fp32 loss and grad norm,
                               # relative: the same fp32 math summed in
                               # other orders, through 3 Adam steps


def _write_corpus(path, seed, n_words=80000):
    """A seeded text corpus (random words from a fixed list)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = ('the of and to in is was for on that with as by at from his '
             'her it an were are which this be or has had not but their '
             'one all we they there been if more when will would who so '
             'no river mountain city music history science language '
             'village engine station winter summer garden letter').split()
    with open(path, 'w', encoding='utf-8') as f:
        for _ in range(0, n_words, 1000):
            f.write(' '.join(rng.choice(words, 1000)) + '.\n')
    return path


class _StepLog:
    """Callback recording each step's wall time (the step's metrics are
    read back before ``on_step_end``, so it covers the device work)."""

    def __init__(self):
        self.t0, self.times, self.metrics = None, [], []

    def on_step_begin(self, step):
        self.t0 = time.monotonic()

    def on_step_end(self, step, metrics):
        self.times.append(time.monotonic() - self.t0)
        self.metrics.append(metrics)

    def on_train_end(self):
        pass


def _kernel_class(name):
    """The class of a device kernel in the training profile."""
    for tag, cls in (('flash_fwd_kernel', 'K4'), ('flash_bwd_dkv', 'K5a'),
                     ('flash_bwd_dq', 'K5b')):
        if tag in name:
            return cls
    if any(t in name.lower() for t in ('gemm', 'xmma', 'cutlass', 'nvjet',
                                       'cublas', 'wgmma')):
        return 'matmul'
    return 'other'


def _train_breakdown(torch, trainer, state, batch, step_s):
    """Where a training step's time goes, measured after the main path's
    launch counts were read: one more step traced with torch.profiler
    (device time by kernel class, busy share of the unprofiled median
    step), then the optimizer update and the loss tail (argmax,
    log-softmax, gather, masked mean and its backward on fp32 logits of
    the step's shape) each timed alone with CUDA events."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import trainer as tr
    batch = trainer._batch(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
    device_ms, kernels = {}, []
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = getattr(evt, 'self_cuda_time_total', 0)
        if us and str(getattr(evt, 'device_type', '')).endswith('CUDA'):
            cls = _kernel_class(evt.key)
            device_ms[cls] = device_ms.get(cls, 0.0) + us / 1e3
            kernels.append((us / 1e3, evt.count, cls, evt.key[:100]))
    busy = sum(device_ms.values())
    _, _, grads = tr.value_and_grad(state.params, batch, trainer.cfg,
                                    trainer.tc.attn_impl)
    optimizer_ms = _cuda_ms(torch, lambda i: trainer.optimizer.update(
        grads, state.opt_state, state.params), 3, n_warm=1)
    cfg, (b, s) = trainer.cfg, batch['inputs'].shape
    del grads, state
    _release(torch)
    gen = torch.Generator(device='cuda').manual_seed(41)
    logits = torch.randn((b, s, cfg.vocab_size), generator=gen,
                         device='cuda').requires_grad_(True)
    tgt = batch['targets'].long()
    mask = batch['mask']

    def loss_tail(_):
        hits = torch.argmax(logits.detach(), -1) == tgt
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return torch.autograd.grad(loss, logits), (hits * mask).sum()
    ce_ms = _cuda_ms(torch, loss_tail, 3, n_warm=1)
    del logits
    _release(torch)
    return {'device_ms_by_class': device_ms if busy else 'not measured',
            'top_kernels_ms_calls_class_name': sorted(kernels,
                                                      reverse=True)[:20],
            'device_busy_ms': busy or None,
            'device_idle_share': 1 - busy / (step_s * 1e3) if busy else None,
            'optimizer_ms': optimizer_ms, 'loss_tail_fwd_bwd_ms': ce_ms}


def phase_train(torch, seed, times):
    """llama3-1b trained at full width through ``Trainer.fit``; returns
    the K4, K5a and K5b launch counts of the run."""
    import statistics
    import tempfile
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = configs.LLAMA3_1B
    require(cfg.remat == 'block' and cfg.dtype == torch.bfloat16,
            f'llama3-1b resolved to remat {cfg.remat}, {cfg.dtype}')
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                     total_steps=TRAIN_STEPS, mu_dtype='float32')
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'corpus.txt'),
                                           seed),
                             load_tokenizer(None, cfg.vocab_size))
    batch = TRAIN_BATCH
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer = Trainer(cfg, train_config=tc, device='cuda')
    state = trainer.init(seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    data = packed_batches(stream, batch=batch, seq=TRAIN_SEQ)
    log = _StepLog()
    pa.reset_launch_counts()             # counts to 0 just before the path
    fa.reset_launch_counts()
    state = trainer.fit(state, data, TRAIN_STEPS, [log])
    flash_after, paged_after = dict(fa.launch_counts), dict(pa.launch_counts)
    losses = [m['loss'] for m in log.metrics]
    L, n = cfg.n_layers, TRAIN_STEPS
    k4, k5a, k5b = (flash_after[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                              'flash_bwd_dq'))
    step_s = statistics.median(log.times[1:])
    tokens = batch * TRAIN_SEQ
    t = TRAIN_ATTN
    attn_flops = 3 * 4 * t['d'] * t['hq'] * batch * (
        TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * L      # causal, fwd + bwd
    flops = cfg.flops_per_token(training=True) * tokens + attn_flops
    kernel_ms = (k4 / n * times[('flash_fwd', 'train')]['ms']
                 + k5a / n * times[('flash_bwd_dkv', 'train')]['ms']
                 + k5b / n * times[('flash_bwd_dq', 'train')]['ms'])
    line = {'phase': 'train', 'model': cfg.name, 'n_params': cfg.num_params,
            'dtype': 'bfloat16', 'remat': cfg.remat, 'mu_dtype': tc.mu_dtype,
            'batch': batch, 'seq': TRAIN_SEQ,
            'steps': n, 'lr': tc.learning_rate, 'warmup_steps': 1,
            'init_s': init_s, 'losses': losses,
            'accuracy': [m['accuracy'] for m in log.metrics],
            'grad_norms': [m['grad_norm'] for m in log.metrics],
            'step_s': log.times, 'step_s_median_after_step_1': step_s,
            'tok_s': tokens / step_s,
            'model_flops_per_step': flops,
            'model_tflop_s': flops / step_s / 1e12,
            'mfu': flops / step_s / FLOP_PEAKS['bf16_tensor_cores'],
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'attn_kernel_ms_per_step': kernel_ms,
            'attn_kernel_share_of_step': kernel_ms / (step_s * 1e3),
            'kernel_launches': flash_after}
    emit(line)
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f'losses {losses}: not finite and falling')
    require(k4 == 2 * L * n and k5a == L * n and k5b == L * n,
            f'launches K4 {k4} (want {2 * L * n}), K5a {k5a}, K5b {k5b} '
            f'(want {L * n} each)')
    require(flash_after['flash_fwd_chunk'] == 0
            and not any(paged_after.values()),
            f'other kernels launched on the train path: {flash_after} '
            f'{paged_after}')
    breakdown = _train_breakdown(torch, trainer, state, next(data), step_s)
    fa.launch_counts.update(flash_after)     # not part of the main path
    emit({'phase': 'train_breakdown', 'model': cfg.name, 'batch': batch,
          'seq': TRAIN_SEQ, 'step_s_median': step_s,
          'attn_kernel_ms_per_step': kernel_ms, **breakdown})
    del trainer, state, log
    _release(torch)
    return k4, k5a, k5b


def phase_train_reference(torch, seed):
    """A 2-layer fp32 model with head_dim 64 trained 3 steps on the card
    (K4, K5a, K5b) and on the CPU (plain paths) from the same params on
    the same batches: losses and grad norms within TOL_TRAIN_REF."""
    import dataclasses
    import tempfile
    from skypilot_tpu_torch.models import configs, llama
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(
        configs.TINY, name='smoke-train-d64', vocab_size=512, dim=256,
        n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256,
        dtype=torch.float32, remat='block')
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'c.txt'),
                                           seed + 1, 4000),
                             load_tokenizer(None, cfg.vocab_size))
    cpu_params = llama.init_params(cfg, seed, device='cpu')
    runs, launched = {}, None
    for dev in ('cuda', 'cpu'):
        trainer = Trainer(cfg, train_config=tc, device=dev)
        state = trainer.state_from_params(_to_device(cpu_params, dev))
        data = packed_batches(stream, batch=2, seq=128)
        before = dict(fa.launch_counts)
        log = _StepLog()
        trainer.fit(state, data, 3, [log])
        if dev == 'cuda':
            launched = {k: fa.launch_counts[k] - before[k] for k in before}
            fa.launch_counts.update(before)      # not a main-path run
        runs[dev] = log.metrics
    errs = {key: max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                     for a, b in zip(runs['cuda'], runs['cpu']))
            for key in ('loss', 'grad_norm')}
    ok = (all(e <= TOL_TRAIN_REF for e in errs.values())
          and launched['flash_bwd_dkv'] == launched['flash_bwd_dq']
          == cfg.n_layers * 3 > 0)
    emit({'phase': 'train_reference', 'model': cfg.name, 'dtype': 'float32',
          'steps': 3, 'batch': 2, 'seq': 128,
          'loss_cuda': [m['loss'] for m in runs['cuda']],
          'loss_cpu': [m['loss'] for m in runs['cpu']],
          'grad_norm_cuda': [m['grad_norm'] for m in runs['cuda']],
          'grad_norm_cpu': [m['grad_norm'] for m in runs['cpu']],
          'max_rel_err': errs, 'tol_rel': TOL_TRAIN_REF,
          'kernel_launches_cuda': launched, 'ok': ok})
    require(ok, f'card vs CPU training differs: {errs}, launches {launched}')


# ------------------------------------------------------- training mesh
# train_mesh1: llama3-1b at full width, cut to TRAIN_MESH1['layers'] of
# 16 layers for time; the same seeded batch every step.
TRAIN_MESH1 = dict(layers=4, steps=2)
TOL_MESH1_FIRST = 1e-5         # step 1's loss and grad norm, mesh vs
                               # meshless, relative: the same bf16 model
                               # and fp32 logits; only the loss's sums
                               # differ (the vocab-parallel cross-entropy
                               # against log_softmax)
TOL_MESH1 = 2e-3               # later steps, relative: Adam divides each
                               # gradient by its own size, so the first
                               # step's last-bit differences move the
                               # near-zero gradients' updates by up to lr
                               # (measured 2.7e-5 loss, 6.5e-4 grad norm)
TOL_MESH1_PARAMS = 0.1         # rms(mesh - meshless params) over
                               # rms(meshless update): a wrong gradient
                               # (any sign, scale or missing sum) moves
                               # Adam's update as much as the update
                               # itself (~1); last-bit gradient
                               # differences flip rare bf16 roundings
                               # (read 0.036 on an H100, 700 W)
MULTI_CARD_UNSHOWN = ('several ranks', 'NCCL collective times',
                      'fsdp/tp/sp/pp across cards', 'pipeline bubbles')


def phase_train_mesh1(torch, seed):
    """The training mesh's path on one card (``parallel/mesh.py``,
    ``train/trainer.py``): llama3-1b at full width, bf16, remat 'block',
    ``attn_impl='auto'`` (K4 forward, K5a/K5b backward), trained
    TRAIN_MESH1['steps'] steps through a one-rank NCCL training mesh
    (``make_mesh(MeshSpec())``: the sharded step with every collective
    of world 1, the vocab-parallel cross-entropy and the global-norm
    clip), and the same steps meshless on the same batch. Returns the
    mesh run's K4, K5a and K5b launches."""
    import dataclasses
    import numpy as np
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train.optim import tree_leaves
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    from skypilot_tpu_torch.utils.device import host_scalars
    L, steps = TRAIN_MESH1['layers'], TRAIN_MESH1['steps']
    cfg = dataclasses.replace(configs.LLAMA3_1B, n_layers=L)
    # No warmup: the first step already moves the params, so step 2
    # holds the update too.
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=steps,
                     mu_dtype='float32')
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {'inputs': tokens[:, :-1].astype(np.int32),
             'targets': tokens[:, 1:].astype(np.int32)}

    def run(trainer, keep_init=False):
        state = trainer.init(seed)
        init = ([t.clone() for t in tree_leaves(state.params)]
                if keep_init else None)
        metrics, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = trainer.step(state, batch)
            metrics.append(host_scalars(m))
            secs.append(time.monotonic() - t0)
        return state, metrics, secs, init

    _release(torch)
    plain = Trainer(cfg, train_config=tc, device='cuda')
    plain_state, plain_m, plain_s, init = run(plain, keep_init=True)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), device='cuda')
    try:
        trainer = Trainer(cfg, mesh=mesh, train_config=tc)
        fa.reset_launch_counts()         # counts to 0 just before the path
        pa.reset_launch_counts()
        mesh_lib.reset_collective_counts()
        state, mesh_m, mesh_s, _ = run(trainer)
        launched = dict(fa.launch_counts)
        paged = dict(pa.launch_counts)
        census = dict(mesh_lib.collective_counts)
        worst, differing, total, diff_sq, update_sq = 0.0, 0, 0, 0.0, 0.0
        for a, b, b0 in zip(tree_leaves(state.params),
                            tree_leaves(plain_state.params), init):
            d = (a.float() - b.float()).abs()
            worst = max(worst, float(d.max()))
            differing += int((d > 0).sum())
            total += d.numel()
            diff_sq += float(d.pow(2).sum())
            update_sq += float((b.float() - b0.float()).pow(2).sum())
    finally:
        mesh.shutdown()
    del plain, plain_state, init
    _release(torch)
    param_rel = math.sqrt(diff_sq / max(update_sq, 1e-30))

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    errs = {k: [rel(m[k], p[k]) for m, p in zip(mesh_m, plain_m)]
            for k in ('loss', 'grad_norm')}
    k4, k5a, k5b = (launched[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                           'flash_bwd_dq'))
    emit({'phase': 'train_mesh1', 'model': cfg.name, 'dtype': 'bfloat16',
          'remat': cfg.remat, 'batch': TRAIN_BATCH, 'seq': TRAIN_SEQ,
          'steps': steps, 'mesh': 'one-rank NCCL MeshSpec()',
          'loss_mesh': [m['loss'] for m in mesh_m],
          'loss_meshless': [m['loss'] for m in plain_m],
          'grad_norm_mesh': [m['grad_norm'] for m in mesh_m],
          'grad_norm_meshless': [m['grad_norm'] for m in plain_m],
          'accuracy_mesh': [m['accuracy'] for m in mesh_m],
          'rel_err': errs, 'tol_first': TOL_MESH1_FIRST,
          'tol_later': TOL_MESH1,
          'param_max_abs_diff': worst,
          'params_differing': differing, 'params_total': total,
          'param_diff_rms_over_update_rms': param_rel,
          'tol_params': TOL_MESH1_PARAMS,
          'param_diff_reason': (
              'the vocab-parallel cross-entropy sums the loss in another '
              'order than log_softmax; Adam divides each gradient by its '
              'own size, so near-zero gradients move by up to lr'),
          'step_s_mesh': mesh_s, 'step_s_meshless': plain_s,
          'kernel_launches': launched, 'collectives': census,
          'reduced': {'n_layers': f'{L} of {configs.LLAMA3_1B.n_layers}'},
          'one_card_cannot_show': MULTI_CARD_UNSHOWN})
    require(all(math.isfinite(m['loss']) for m in mesh_m),
            f'mesh losses {[m["loss"] for m in mesh_m]} not finite')
    require(errs['loss'][0] <= TOL_MESH1_FIRST
            and errs['grad_norm'][0] <= TOL_MESH1_FIRST
            and max(errs['loss'] + errs['grad_norm']) <= TOL_MESH1,
            f'mesh step differs from the meshless step: {errs}')
    require(param_rel <= TOL_MESH1_PARAMS,
            f'mesh params differ from the meshless params: rms of the '
            f'difference {param_rel} of the update\'s (limit '
            f'{TOL_MESH1_PARAMS})')
    require(k4 == 2 * L * steps and k5a == L * steps and k5b == L * steps,
            f'launches K4 {k4} (want {2 * L * steps}), K5a {k5a}, K5b {k5b} '
            f'(want {L * steps} each)')
    require(launched['flash_fwd_chunk'] == 0 and not any(paged.values()),
            f'other kernels launched on the mesh path: {launched} {paged}')
    require(census.get('all_gather[fsdp]', 0) > 0
            and census.get('all_reduce_max[tp]', 0) == steps,
            f'the mesh step issued no fsdp gather or vocab-parallel max: '
            f'{census}')
    return k4, k5a, k5b


# seq_parallel: llama3-8b's attention widths over a whole sequence of
# 8192, sp 4 (2048 a rank), through the lock-step runner on one card.
SEQ_PAR = dict(b=1, s=8192, hq=32, hkv=8, d=128, sp=4)
# Each error is read two ways (``_seq_err``): the rms of the difference
# over the rms of the whole-sequence result (the tensor), and the largest
# per-token max |difference| over that token's rms (the row: a causal
# output's rows shrink as 1/sqrt(position), so an error confined to a
# late block is not hidden behind the early rows' large values).
# Each limit is about three times the reading on an H100 (700 W).
TOL_SEQ_OUT = 4e-3             # bf16 output, tensor (read 1.2e-3-1.4e-3):
                               # the ring merges fp32 block results and
                               # rounds once to bf16 (2^-8), against the
                               # whole-sequence kernel's own rounding
TOL_SEQ_OUT_ROW = 1.5e-1       # bf16 output, worst row (read 0.045-0.050):
                               # one or two bf16 roundings of a row's
                               # largest element, ~4x its rms
TOL_SEQ_GRAD = 1e-2            # bf16 gradients, tensor (read 1.7e-3-
                               # 3.4e-3): each block's K5a/K5b result is
                               # rounded to bf16 and autograd sums up to
                               # 2 sp of them in bf16
TOL_SEQ_GRAD_ROW = 3e-1        # bf16 gradients, worst row (read 0.04-0.11)


def _seq_err(torch, got, want):
    """``got`` against ``want`` ([b, s, h, d]): {'tensor': rms of the
    difference over the rms of ``want``, 'row': the largest per-token
    max |difference| over that token's rms of ``want`` (floored at 1%
    of the tensor's rms: a causal dq's first row is 0)}."""
    got, want = got.detach().float(), want.detach().float()
    diff = got - want
    rms = want.pow(2).mean().sqrt()
    row_diff = diff.abs().flatten(2).amax(-1)
    row_rms = want.pow(2).flatten(2).mean(-1).sqrt()
    return {'tensor': float(diff.pow(2).mean().sqrt() / rms),
            'row': float((row_diff / (row_rms + 1e-2 * rms)).max())}


def phase_seq_parallel(torch, seed):
    """Ring attention (zigzag and contiguous, causal) and Ulysses at sp
    SEQ_PAR['sp'] through the lock-step runner (``ops/ring_attention.py``
    ``LockstepComm``: every rank's blocks in this process, a rotation a
    reassignment) at llama3-8b's attention widths, bf16, a whole
    sequence of SEQ_PAR['s']. Each variant's forward is held against K4
    over the whole sequence and against the plain version; its q, k and
    v gradients (K5a/K5b per block, the lse cotangent folded into delta)
    against the whole sequence's K5a/K5b. K4's launches are held to the
    count ``ring_block_calls`` predicts. Returns the K4, K5a and K5b
    launches of the three variants together."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ring
    from skypilot_tpu_torch.ops.ulysses import ulysses_attention
    c = SEQ_PAR
    sp = c['sp']
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(h):
        return torch.randn((c['b'], c['s'], h, c['d']), generator=gen,
                           device='cuda', dtype=torch.bfloat16)
    q, k, v, do = rnd(c['hq']), rnd(c['hkv']), rnd(c['hkv']), rnd(c['hq'])
    for t in (q, k, v):
        t.requires_grad_(True)
    whole = fa.flash_attention(q, k, v, causal=True)
    whole_grads = torch.autograd.grad(whole, (q, k, v), do)
    with torch.no_grad():
        plain = fa.flash_attention_reference(q.detach(), k.detach(),
                                             v.detach(), causal=True)[0]

    def err(got, want):
        return _seq_err(torch, got, want)
    variants = {
        'ring_zigzag': lambda: ring.ring_attention(
            q, k, v, sp, causal=True, layout='zigzag'),
        'ring_contiguous': lambda: ring.ring_attention(
            q, k, v, sp, causal=True, layout='contiguous'),
        'ulysses': lambda: ulysses_attention(q, k, v, sp, causal=True)}
    predicted = {
        'ring_zigzag': sum(ring.ring_block_calls(sp, r, 'zigzag')
                           for r in range(sp)),
        'ring_contiguous': sum(ring.ring_block_calls(sp, r, 'contiguous')
                               for r in range(sp)),
        'ulysses': sp}
    total = {'flash_fwd': 0, 'flash_bwd_dkv': 0, 'flash_bwd_dq': 0}
    lines = {}
    for name, fn in variants.items():
        torch.cuda.synchronize()
        fa.reset_launch_counts()         # counts to 0 just before the path
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        fwd_s = time.monotonic() - t0
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        got = {key: fa.launch_counts[key] for key in total}
        for key in total:
            total[key] += got[key]
        lines[name] = {
            'out_err_vs_k4_whole': err(out, whole),
            'out_err_vs_plain': err(out, plain),
            'grad_err_vs_k5_whole': [err(g, w) for g, w in
                                     zip(grads, whole_grads)],
            'launches': got, 'k4_predicted': predicted[name],
            'fwd_s': fwd_s, 'fwd_bwd_s': secs}
        del out, grads
    emit({'phase': 'seq_parallel', 'sp': sp, 'batch': c['b'],
          'seq': c['s'], 'seq_per_rank': c['s'] // sp,
          'heads': [c['hq'], c['hkv']], 'head_dim': c['d'],
          'dtype': 'bfloat16', 'runner': 'lock-step (one process, one card)',
          'block_backward': 'K5a/K5b with delta - dlse',
          'variants': lines,
          'tol_out': {'tensor': TOL_SEQ_OUT, 'row': TOL_SEQ_OUT_ROW},
          'tol_grad': {'tensor': TOL_SEQ_GRAD, 'row': TOL_SEQ_GRAD_ROW},
          'one_card_cannot_show': MULTI_CARD_UNSHOWN})
    for name, line in lines.items():
        outs = (line['out_err_vs_k4_whole'], line['out_err_vs_plain'])
        grads = line['grad_err_vs_k5_whole']
        require(all(e['tensor'] <= TOL_SEQ_OUT
                    and e['row'] <= TOL_SEQ_OUT_ROW for e in outs)
                and all(e['tensor'] <= TOL_SEQ_GRAD
                        and e['row'] <= TOL_SEQ_GRAD_ROW for e in grads),
                f'{name}: {line}')
        n = line['k4_predicted']
        require(line['launches'] == {'flash_fwd': n, 'flash_bwd_dkv': n,
                                     'flash_bwd_dq': n},
                f'{name}: launches {line["launches"]}, predicted {n} each')
    del q, k, v, do, whole, whole_grads, plain
    _release(torch)
    return total['flash_fwd'], total['flash_bwd_dkv'], total['flash_bwd_dq']


# ---------------------------------------------------------------- 12-15
CKPT_DISK_MARGIN = 4e9         # free bytes kept on the checkpoint's disk
# Depths the synthetic checkpoints are written at (full width): half of
# gemma-2b's 18 and 8 of qwen2-7b's 28 layers keep chip_smoke.py inside
# its time limit; the load path, the families' layers and every kernel
# at their geometries run all the same.
CKPT_LAYERS = {'gemma-2b': 9, 'qwen2-7b': 8}
# Depths of serve_moe and serve_int4, cut from mixtral-8x7b's 32 and
# llama3-70b's 80 layers for the time limit (their lines' ``reduced``):
# their time is their prefill and decode steps, each through every
# layer; every layer runs the same kernels at the same widths.
BIG_SERVE_LAYERS = {'mixtral-8x7b': 8, 'llama3-70b': 20}


def _big_serve_cfg(name):
    """``name`` at full width and BIG_SERVE_LAYERS depth, and the
    ``reduced`` record of the cut."""
    import dataclasses
    from skypilot_tpu_torch.models import configs
    full = configs.get_config(name)
    cut = BIG_SERVE_LAYERS[name]
    return (dataclasses.replace(full, n_layers=cut),
            {'n_layers': [full.n_layers, cut],
             'why': "chip_smoke.py's time limit"})
CKPT_TRAIN = dict(batch=2, seq=2048, steps=2)


def _checkpoint_bytes(cfg):
    """Bytes of the synthetic checkpoint ``synth.py`` writes for ``cfg``
    (fp16 matrices, fp32 norms and biases)."""
    from skypilot_tpu_torch.models import weights
    return sum(math.prod(shape) * (4 if k.endswith(('norm.weight', '.bias'))
                                   else 2)
               for k, shape in weights.hf_shapes(cfg).items())


def _plan_checkpoint(cfg, extra_bytes, n_layers):
    """Where and at what depth ``_synthetic_checkpoint`` writes ``cfg``:
    (path, the config to write, its ``reduced``, the free disk bytes)."""
    import dataclasses
    import shutil
    import tempfile
    path = tempfile.mkdtemp(prefix=f'skt_smoke_{cfg.name}_')
    free = shutil.disk_usage(path).free
    room = free - CKPT_DISK_MARGIN - extra_bytes
    written, reduced = cfg, None
    if n_layers is not None and n_layers < cfg.n_layers:
        written = dataclasses.replace(cfg, n_layers=n_layers)
        reduced = {'n_layers': [cfg.n_layers, n_layers],
                   'why': "chip_smoke.py's time limit"}
    if _checkpoint_bytes(written) > room:
        one = dataclasses.replace(cfg, n_layers=1)
        per_layer = _checkpoint_bytes(dataclasses.replace(
            cfg, n_layers=2)) - _checkpoint_bytes(one)
        n = int((room - (_checkpoint_bytes(one) - per_layer)) // per_layer)
        require(n >= 1, f'{cfg.name}: {free} free bytes hold no layer')
        written = dataclasses.replace(cfg, n_layers=min(
            n, written.n_layers))
        reduced = {'n_layers': [cfg.n_layers, written.n_layers],
                   'why': f'free disk {free} bytes'}
    return path, written, reduced, free


def _synthetic_checkpoint(torch, cfg, seed, extra_bytes=0, n_layers=None):
    """``cfg`` written by the port's ``synth.py`` into a new temporary
    directory at full width, at the depth ``n_layers`` (full depth when
    None) unless the disk's free bytes (less CKPT_DISK_MARGIN and
    ``extra_bytes``, room for what the phase writes beside it) cannot
    hold it: then depth only is cut further. Returns (path, the config
    written, a JSON dict of the write)."""
    from skypilot_tpu_torch.models import synth
    path, written, reduced, free = _plan_checkpoint(cfg, extra_bytes,
                                                    n_layers)
    t0 = time.monotonic()
    synth.write_synthetic_hf_checkpoint(path, written, seed=seed)
    info = {'preset': cfg.name, 'bytes': _checkpoint_bytes(written),
            'write_s': time.monotonic() - t0, 'free_disk_bytes': free,
            'n_params': written.num_params, 'reduced': reduced}
    return path, written, info


def _start_synthetic_checkpoint(cfg, seed, extra_bytes=0, n_layers=None):
    """``_synthetic_checkpoint``'s write started in a child process, so
    that it overlaps other phases (the write is host-bound: the random
    draw and the disk). ``_finish_synthetic_checkpoint`` waits for it."""
    path, written, reduced, free = _plan_checkpoint(cfg, extra_bytes,
                                                    n_layers)
    code = ('import dataclasses, sys\n'
            'from skypilot_tpu_torch.models import configs, synth\n'
            'cfg = dataclasses.replace(configs.get_config(sys.argv[1]), '
            'n_layers=int(sys.argv[2]))\n'
            'synth.write_synthetic_hf_checkpoint(sys.argv[3], cfg, '
            'seed=int(sys.argv[4]))\n')
    proc = subprocess.Popen(
        [sys.executable, '-c', code, cfg.name, str(written.n_layers), path,
         str(seed)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    info = {'preset': cfg.name, 'bytes': _checkpoint_bytes(written),
            'free_disk_bytes': free, 'n_params': written.num_params,
            'reduced': reduced, 'written_beside_earlier_phases': True}
    return proc, path, written, info, time.monotonic()


def _finish_synthetic_checkpoint(started):
    """Wait for a write ``_start_synthetic_checkpoint`` started: (path,
    config written, info with ``write_s`` from its start and
    ``waited_s``, the part no other phase overlapped)."""
    proc, path, written, info, t0 = started
    t_wait = time.monotonic()
    _, err = proc.communicate(timeout=600)
    require(proc.returncode == 0, f'checkpoint write of {info["preset"]} '
            f'failed: {err[-2000:]}')
    now = time.monotonic()
    return path, written, dict(info, write_s=now - t0, waited_s=now - t_wait)


def phase_ckpt_int8(torch, seed, path, info):
    """``quantize='int8'`` from the checkpoint directory twice: the
    first load quantizes on the host and writes the int8 cache, the
    second maps the cache. Both must give the same leaves bit for bit
    and answer 4 requests (int8 weights, int8 KV through K1); each load
    reports its own launches."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import weights
    from skypilot_tpu_torch.ops import paged_attention as pa
    cache = os.path.join(path, '.int8_cache.bin')
    require(not os.path.exists(cache), 'int8 cache present before load 1')
    first = None
    for load in (1, 2):
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        eng = PagedInferenceEngine.from_pretrained(
            path, quantize='int8', max_batch=8, max_seq=2048)
        require(os.path.exists(cache + '.meta.json'),
                'the int8 cache was not written')
        cfg = eng.cfg
        leaves = dict(weights._flatten_leaves(eng.params))
        if first is None:
            first = {k: v.cpu() for k, v in leaves.items()}
            same = None
        else:
            same = (sorted(leaves) == sorted(first) and all(
                leaves[k].dtype == first[k].dtype
                and torch.equal(leaves[k].cpu(), first[k]) for k in first))
            require(same, 'the cached int8 tree differs from the first load')
        require(eng.kv_cache_dtype == 'int8' and eng.decode_impl == 'pallas',
                f'engine resolved to {eng.kv_cache_dtype}/{eng.decode_impl}')
        key = 'paged_decode_attention[int8]'
        eng.add_request([1, 2, 3], max_new_tokens=2)       # warm-up
        eng.run_to_completion(horizon=4)
        pa.reset_launch_counts()
        steps0 = eng.decode_substeps
        t0 = time.monotonic()
        rids = [eng.add_request(p, max_new_tokens=N_NEW)
                for p in _prompts(seed + 3, cfg.vocab_size)[:4]]
        done = eng.run_to_completion(horizon=32)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        toks = [done[r].output for r in rids]
        steps = eng.decode_substeps - steps0
        launches = pa.launch_counts[key]
        require(all(len(t) == N_NEW for t in toks)
                and all(0 <= t < cfg.vocab_size for o in toks for t in o),
                f'int8 load {load}: tokens {toks}')
        require(launches == cfg.n_layers * steps > 0
                and sum(pa.launch_counts.values()) == launches,
                f'int8 load {load}: launches {dict(pa.launch_counts)}, '
                f'{steps} decode steps')
        emit({'phase': 'serve_ckpt_int8', 'model': info['preset'],
              'load': load, 'from_cache': load == 2, 'load_s': eng.load_s,
              'cache_bytes': os.path.getsize(cache),
              'leaves_equal_to_load_1': same, 'requests': len(rids),
              'new_tokens': N_NEW, 'decode_steps': steps,
              'kernel_launches': {key: launches},
              'split_plans': _split_plans(pa, key), 'wall_s': wall,
              'output_tok_s': sum(len(t) for t in toks) / wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
              'param_bytes': eng._param_bytes, **eng.graph_stats()})
        del eng, done, leaves
    del first
    _release(torch)


def phase_train_ckpt(torch, seed, path, info):
    """``Trainer.init_from_pretrained`` on the checkpoint (gemma-2b:
    tied embeddings, GeGLU, d 256, group 8), then CKPT_TRAIN steps of
    ``trainer.fit``: finite losses, K4 twice and K5a/K5b once per layer
    per step and no other kernel; then, outside the counted run, the
    gradient of ``embed`` must be non-zero on rows of tokens that are
    not in the batch (they get it only through the tied unembedding)."""
    import dataclasses
    import tempfile
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.train import trainer as tr
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    cfg = configs.get_config(info['preset'])
    if info['reduced']:
        cfg = dataclasses.replace(cfg, n_layers=info['reduced']['n_layers'][1])
    b, sq, n = CKPT_TRAIN['batch'], CKPT_TRAIN['seq'], CKPT_TRAIN['steps']
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'corpus.txt'),
                                           seed + 2, 20000),
                             load_tokenizer(None, cfg.vocab_size))
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    trainer = tr.Trainer(cfg, device='cuda', train_config=tr.TrainConfig(
        learning_rate=1e-4, warmup_steps=1, total_steps=n + 1))
    t0 = time.monotonic()
    state = trainer.init_from_pretrained(path)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    data = packed_batches(stream, batch=b, seq=sq)
    log = _StepLog()
    pa.reset_launch_counts()             # counts to 0 just before the path
    fa.reset_launch_counts()
    state = trainer.fit(state, data, n, [log])
    flash_after, paged_after = dict(fa.launch_counts), dict(pa.launch_counts)
    losses = [m['loss'] for m in log.metrics]
    L = cfg.n_layers
    require(all(math.isfinite(x) for x in losses), f'losses {losses}')
    require(flash_after['flash_fwd'] == 2 * L * n
            and flash_after['flash_bwd_dkv'] == L * n
            and flash_after['flash_bwd_dq'] == L * n
            and flash_after['flash_fwd_chunk'] == 0
            and not any(paged_after.values()),
            f'train_ckpt launches {flash_after} {paged_after}')
    batch = trainer._batch(next(data))
    _, _, grads = tr.value_and_grad(state.params, batch, cfg)
    fa.launch_counts.update(flash_after)     # not part of the main path
    unseen = torch.ones(cfg.vocab_size, dtype=torch.bool, device='cuda')
    unseen[batch['inputs'].reshape(-1).long()] = False
    g_embed = grads['embed'].float()
    seen_max = g_embed[~unseen].abs().max().item()
    unseen_max = g_embed[unseen].abs().max().item()
    require('unembed' not in state.params and unseen_max > 0
            and math.isfinite(seen_max) and seen_max > 0,
            f'embed gradient: rows in the batch {seen_max}, other rows '
            f'{unseen_max}')
    step_s = log.times[-1]               # step 1 pays the first-call costs
    emit({'phase': 'train_ckpt', 'model': info['preset'],
          'n_params': cfg.num_params, 'n_layers': L,
          'heads': [cfg.n_heads, cfg.n_kv_heads], 'head_dim': cfg.head_dim,
          'tie_embeddings': cfg.tie_embeddings,
          'activation': cfg.activation, 'dtype': 'bfloat16',
          'remat': cfg.remat, 'batch': b, 'seq': sq, 'steps': n,
          'load_s': load_s, 'losses': losses,
          'grad_norms': [m['grad_norm'] for m in log.metrics],
          'step_s': log.times, 'tok_s_last_step': b * sq / step_s,
          'embed_grad_max_abs_rows_in_batch': seen_max,
          'embed_grad_max_abs_other_rows': unseen_max,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
          'kernel_launches': flash_after, 'reduced': info['reduced']})
    del trainer, state, grads, log
    _release(torch)


def phase_checkpoints(torch, seed):
    """The checkpoint phases: gemma-2b written by the port's synth.py at
    full width, depth cut to CKPT_LAYERS, served from its directory (serve_ckpt: paged,
    bf16 KV, K1; serve_ckpt_slot: K4/K3 at d 256, group 8), loaded int8
    twice (serve_ckpt_int8) and trained (train_ckpt); then qwen2-7b at
    full width, depth cut the same way, served on the paged engine
    (serve_qwen2: K1 at group 7).
    Each directory is deleted after its phases."""
    import dataclasses
    import shutil
    from skypilot_tpu_torch.models import configs
    gemma, qwen = configs.GEMMA_2B, configs.QWEN2_7B
    gemma_bytes = _checkpoint_bytes(dataclasses.replace(
        gemma, n_layers=CKPT_LAYERS['gemma-2b']))
    # qwen2-7b is written in a child process while the gemma phases run
    # (its embedding and unembedding, 152064 x 3584 each, make it the
    # slower write whatever its depth).
    qwen_started = _start_synthetic_checkpoint(
        qwen, seed, extra_bytes=gemma_bytes * 3 // 2,
        n_layers=CKPT_LAYERS['qwen2-7b'])
    try:
        path, written, info = _synthetic_checkpoint(
            torch, gemma, seed,
            extra_bytes=gemma_bytes // 2 + qwen_started[3]['bytes'],
            n_layers=CKPT_LAYERS['gemma-2b'])
    except BaseException:
        qwen_started[0].kill()
        qwen_started[0].communicate()
        shutil.rmtree(qwen_started[1], ignore_errors=True)
        raise
    emit({'phase': 'checkpoint_write', **info})
    try:
        require(written.n_heads // written.n_kv_heads == 8
                and written.head_dim == 256, f'{written}')
        extra = {'checkpoint': info['preset'], 'reduced': info['reduced']}
        phase_serve(torch, seed, 'serve_ckpt', model_path=path,
                    kv_cache_dtype='bf16', decode_impl='pallas',
                    want_split=True, extra=extra)
        phase_serve_slot(torch, seed, phase='serve_ckpt_slot',
                         model_path=path, extra=extra)
        phase_ckpt_int8(torch, seed, path, info)
        phase_train_ckpt(torch, seed, path, info)
    except BaseException:
        qwen_started[0].kill()
        qwen_started[0].communicate()
        shutil.rmtree(qwen_started[1], ignore_errors=True)
        raise
    finally:
        shutil.rmtree(path, ignore_errors=True)
    try:
        path, written, info = _finish_synthetic_checkpoint(qwen_started)
    except BaseException:
        shutil.rmtree(qwen_started[1], ignore_errors=True)
        raise
    emit({'phase': 'checkpoint_write', **info})
    try:
        require(qwen.n_heads // qwen.n_kv_heads == 7, f'{qwen}')
        phase_serve(torch, seed, 'serve_qwen2', model_path=path,
                    kv_cache_dtype='bf16', decode_impl='pallas',
                    extra={'checkpoint': info['preset'],
                           'reduced': info['reduced']})
    finally:
        shutil.rmtree(path, ignore_errors=True)


# ------------------------------------------------------------------ 16-19
TOL_MOE = 2e-2                 # bf16 MoE layer and int4 product, card vs
                               # CPU: max abs error over max |output|
                               # (bf16 roundings of fp32 sums in another
                               # order, 2^-8 relative each)
MOE_TRAIN = dict(layers=2, batch=2, seq=2048, steps=3)


def phase_moe_int4_check(torch, seed):
    """One mixtral-8x7b MoE layer (int8 experts, bf16 activations, 8 and
    64 tokens: decode and prefill widths) and llama3-70b's int4 w_gate
    product (per channel and with groups of 128) on the card against the
    same functions on the CPU. Neither is a kernel of its own (the
    reference computes both in XLA outside any Pallas kernel): they run
    cuBLAS products and plain torch on the card."""
    import dataclasses
    from skypilot_tpu_torch.models import configs, moe, quantization
    gen = torch.Generator(device='cuda').manual_seed(seed + 16)
    cfg = dataclasses.replace(configs.MIXTRAL_8X7B, n_layers=1)
    layer = {k: v[0] for k, v in moe.init_moe_params(
        cfg, gen, torch.device('cuda')).items()}
    layer = {k: (quantization.quantize_slice(k, v) if k.startswith('moe_')
                 else v) for k, v in layer.items()}
    cpu_layer = _to_device(layer, 'cpu')
    lines = []
    for tokens in (8, 64):
        x = torch.randn((1, tokens, cfg.dim), generator=gen,
                        device='cuda').to(cfg.dtype)
        out, aux = moe.moe_ffn(layer, x, cfg)
        torch.cuda.synchronize()
        want, want_aux = moe.moe_ffn(cpu_layer, x.cpu(), cfg)
        err = (out.float().cpu() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-6)
        lines.append({'function': 'moe.moe_ffn', 'tokens': tokens,
                      'capacity': moe.expert_capacity(tokens, cfg),
                      'max_abs_err': err, 'err_over_max_abs': rel,
                      'aux_err': abs(float(aux) - float(want_aux))})
        require(rel <= TOL_MOE and bool(torch.isfinite(out).all()),
                f'moe_ffn card vs CPU: {lines[-1]}')
    del layer, cpu_layer
    big = configs.LLAMA3_70B
    w = (torch.randn((big.dim, big.ffn_dim), generator=gen, device='cuda')
         * big.dim ** -0.5).to(big.dtype)
    x = torch.randn((1, 8, big.dim), generator=gen,
                    device='cuda').to(big.dtype)
    for group in (0, 128):
        w4 = quantization.quantize_array4(w, (0,), group)
        out = quantization.qeinsum('bsd,df->bsf', x, w4)
        torch.cuda.synchronize()
        want = quantization.qeinsum('bsd,df->bsf', x.cpu(),
                                    _to_device(w4, 'cpu'))
        err = (out.float().cpu() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-6)
        lines.append({'function': 'quantization._qeinsum4',
                      'shape': [8, big.dim, big.ffn_dim], 'group': group,
                      'max_abs_err': err, 'err_over_max_abs': rel})
        require(rel <= TOL_MOE and bool(torch.isfinite(out).all()),
                f'_qeinsum4 card vs CPU: {lines[-1]}')
    emit({'phase': 'moe_int4_check', 'checks': lines,
          'tol_over_max_abs': TOL_MOE})
    del w, w4
    _release(torch)


def phase_train_moe(torch, seed):
    """mixtral-8x7b at full width trained through ``Trainer.fit``, depth
    cut to MOE_TRAIN['layers']; returns the K4, K5a and K5b launch
    counts of the run."""
    import dataclasses
    import statistics
    import tempfile
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.train import trainer as tr
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    full = configs.MIXTRAL_8X7B
    L, batch, seq, n = (MOE_TRAIN[k] for k in ('layers', 'batch', 'seq',
                                                'steps'))
    cfg = dataclasses.replace(full, n_layers=L)
    require(cfg.remat == 'block' and cfg.dtype == torch.bfloat16,
            f'{cfg.name} resolved to remat {cfg.remat}, {cfg.dtype}')
    # lr 1e-5, a fine-tuning rate for this model class: at 1e-4 with no
    # warmup, Adam's first steps move every router weight by ~lr and
    # the router collapses within two steps (PERF.md §6).
    tc = tr.TrainConfig(learning_rate=1e-5, warmup_steps=1, total_steps=n,
                        mu_dtype='float32')
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'corpus.txt'),
                                           seed),
                             load_tokenizer(None, cfg.vocab_size))
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer = tr.Trainer(cfg, train_config=tc, device='cuda')
    state = trainer.init(seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    data = packed_batches(stream, batch=batch, seq=seq)
    log = _StepLog()
    pa.reset_launch_counts()             # counts to 0 just before the path
    fa.reset_launch_counts()
    state = trainer.fit(state, data, n, [log])
    flash_after, paged_after = dict(fa.launch_counts), dict(pa.launch_counts)
    k4, k5a, k5b = (flash_after[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                              'flash_bwd_dq'))
    losses = [m['loss'] for m in log.metrics]
    auxs = [m['moe_aux_loss'] for m in log.metrics]
    # One more gradient (after the counts were read) for the expert
    # leaves' gradient norms.
    _, _, grads = tr.value_and_grad(state.params, trainer._batch(next(data)),
                                    cfg, tc.attn_impl, tc.moe_aux_weight)
    grad_norms = {k: float(grads['layers'][k].float().norm())
                  for k in ('router', 'moe_gate', 'moe_up', 'moe_down')}
    del grads
    fa.launch_counts.update(flash_after)     # not part of the main path
    step_s = statistics.median(log.times[1:])
    tokens = batch * seq
    attn_flops = 3 * 4 * cfg.head_dim * cfg.n_heads * batch * (
        seq * (seq + 1) // 2) * L            # causal, fwd + bwd
    flops = cfg.flops_per_token(training=True) * tokens + attn_flops
    emit({'phase': 'train_moe', 'model': full.name,
          'reduced': {'n_layers': [full.n_layers, L],
                      'why': 'AdamW state for 32 layers does not fit one '
                             'card'},
          'n_params': cfg.num_params, 'active_params': cfg.active_params,
          'dtype': 'bfloat16', 'remat': cfg.remat, 'mu_dtype': tc.mu_dtype,
          'batch': batch, 'seq': seq, 'steps': n, 'lr': tc.learning_rate,
          'moe_aux_weight': tc.moe_aux_weight,
          'moe_capacity_factor': cfg.moe_capacity_factor,
          'init_s': init_s, 'losses': losses, 'moe_aux_loss': auxs,
          'grad_norms': [m['grad_norm'] for m in log.metrics],
          'expert_grad_norms_after_fit': grad_norms,
          'step_s': log.times, 'step_s_median_after_step_1': step_s,
          'tok_s': tokens / step_s, 'model_flops_per_step': flops,
          'model_tflop_s': flops / step_s / 1e12,
          'mfu': flops / step_s / FLOP_PEAKS['bf16_tensor_cores'],
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
          'kernel_launches': flash_after})
    require(all(math.isfinite(x) for x in losses + auxs)
            and losses[-1] <= losses[0],
            f'losses {losses}, aux {auxs}: not finite, or rising')
    require(all(g > 0 and math.isfinite(g) for g in grad_norms.values()),
            f'expert gradients {grad_norms}')
    require(k4 == 2 * L * n and k5a == L * n and k5b == L * n,
            f'launches K4 {k4} (want {2 * L * n}), K5a {k5a}, K5b {k5b} '
            f'(want {L * n} each)')
    require(flash_after['flash_fwd_chunk'] == 0
            and not any(paged_after.values()),
            f'other kernels launched on the train_moe path: {flash_after} '
            f'{paged_after}')
    del trainer, state, log
    _release(torch)
    return k4, k5a, k5b


# --------------------------------------------------------------------- main
# ------------------------------------------------------- multi-tenant
LORA_RANK = 8                  # the bank rank and every adapter's rank
LORA_SLOTS = 4                 # serve_lora's bank: 3 adapters + 1 warm
LORA_SIGMA = 0.03              # adapter factors ~ N(0, sigma): the delta
                               # is ~15% of a projection at 7B width
LORA_NEW = 16                  # greedy tokens the lora_check streams hold
TOL_LORA_LOGITS = 1e-3         # fp32 logits, bank-served vs merged, max
                               # abs: the two fold the same product in
                               # another order (fp32 rounding, ~1e-5)
GRAMMAR_IDS = 64               # allowed ids of the token-id grammar


def _lora_tree(cfg, seed):
    """A rank-LORA_RANK adapter over every default target (numpy fp32,
    trainer layout), drawn from ``seed``."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.models import multilora
    return audit._random_adapter(cfg, multilora.default_targets(cfg),
                                 LORA_RANK, seed, LORA_SIGMA)


def _merged_params(torch, cfg, params, tree):
    """``params`` with ``tree`` folded in offline (``W += A @ B``, fold
    scale 1: alpha = rank), new target stacks beside the shared rest."""
    import dataclasses
    from skypilot_tpu_torch.models import lora
    lcfg = dataclasses.replace(cfg, lora_rank=LORA_RANK,
                               lora_alpha=float(LORA_RANK),
                               lora_targets=tuple(tree))
    dev_tree = {t: {k: torch.from_numpy(v).cuda() for k, v in ab.items()}
                for t, ab in tree.items()}
    return lora.merge(lcfg, lora.with_lora(params, dev_tree))[1]


def _write_adapters(cfg, seed, adapter_dir, n=5):
    """``n`` rank-LORA_RANK adapters ``tenant<i>.npz`` (fold scale 1)
    written from the seed into ``adapter_dir`` by the port's
    ``save_adapter``."""
    from skypilot_tpu_torch.models import multilora
    t0 = time.monotonic()
    for i in range(n):
        multilora.save_adapter(os.path.join(adapter_dir, f'tenant{i}.npz'),
                               cfg, _lora_tree(cfg, seed * 1000 + i),
                               scale=1.0)
    emit({'phase': 'adapter_write', 'adapters': n, 'rank': LORA_RANK,
          'bytes': sum(os.path.getsize(os.path.join(adapter_dir, f))
                       for f in os.listdir(adapter_dir)),
          'write_s': time.monotonic() - t0})


def _lora_engine(torch, kind, cfg, params, **kw):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    _release(torch)
    if kind == 'paged':
        return PagedInferenceEngine(cfg, params, max_batch=8, max_seq=2048,
                                    n_pages=SPEC_N_PAGES, **kw)
    return InferenceEngine(cfg, params, max_batch=8, max_seq=2048, **kw)


def _streams(eng, reqs, n_new=LORA_NEW):
    """Greedy streams of ``reqs`` ((prompt, request kwargs) pairs) run
    together on ``eng``."""
    rids = [eng.add_request(list(p), max_new_tokens=n_new, **kw)
            for p, kw in reqs]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids]


def phase_lora_check_fp32(torch, seed):
    """At llama2-7b's width in fp32, depth cut to AUDIT_LAYERS: the
    logits of a bank-served adapter against the offline-merged model's
    (``llama.forward``, K4), within TOL_LORA_LOGITS; then the first
    LORA_NEW greedy tokens of an adapter request, batched with a base
    request, equal to the merged model's on both engines (K1 in graphs
    on the paged engine, K4/K3 prefill on the slot engine), and the base
    request's equal to a bankless engine's."""
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.models import llama, multilora
    cfg = _spec_cfg(torch, torch.float32)
    saved = graphs._snapshot()
    params = llama.init_params(cfg, seed)
    tree = _lora_tree(cfg, seed * 100 + 7)
    merged = _merged_params(torch, cfg, params, tree)
    prompts = _prompts(seed, cfg.vocab_size)
    bank = multilora.init_bank(cfg, 2, LORA_RANK, dtype=torch.float32)
    multilora.set_bank_row(bank, multilora.adapter_row_from_tree(
        cfg, tree, LORA_RANK, 1.0,
        targets=multilora.default_targets(cfg)), 1)
    banked = dict(params, layers=dict(params['layers'], mlora=bank))
    tokens = torch.tensor([prompts[0][:256]], device='cuda')
    with torch.no_grad():
        got = llama.forward(banked, tokens, cfg,
                            mlora_idx=torch.tensor([1], device='cuda'))
        want = llama.forward(merged, tokens, cfg)
        base = llama.forward(banked, tokens, cfg,
                             mlora_idx=torch.tensor([-1], device='cuda'))
        plain = llama.forward(params, tokens, cfg)
    err = float((got - want).abs().max())
    require(err <= TOL_LORA_LOGITS,
            f'bank vs merged fp32 logits differ by {err}')
    require(torch.equal(base, plain), 'a -1 row is not the base model')
    require(float((got - plain).abs().max()) > 10 * TOL_LORA_LOGITS,
            'the adapter does not move the logits')
    reqs = [(prompts[0], {'adapter': 'acme'}), (prompts[1], {})]
    streams = {}
    for kind in ('paged', 'slot'):
        eng = _lora_engine(torch, kind, cfg, params, adapter_slots=2,
                           adapter_rank=LORA_RANK)
        eng.adapters.register('acme', tree, scale=1.0)
        got_s = _streams(eng, reqs)
        ref = _streams(_lora_engine(torch, kind, cfg, merged),
                       [(prompts[0], {})])[0]
        plain_s = _streams(_lora_engine(torch, kind, cfg, params),
                           [(prompts[1], {})])[0]
        require(got_s[0] == ref,
                f'{kind}: fp32 adapter stream != merged: {got_s[0]} {ref}')
        require(got_s[1] == plain_s,
                f'{kind}: fp32 base row != bankless engine')
        streams[kind] = {'adapter_equal_merged': True,
                         'base_equal_bankless': True,
                         'graph_replays': eng.graph_stats()['graph_replays']}
        del eng
        _release(torch)
    graphs._restore(saved)
    emit({'phase': 'lora_check', 'dtype': 'float32', 'model': cfg.name,
          'reduced': {'n_layers': [32, AUDIT_LAYERS]}, 'rank': LORA_RANK,
          'logits_max_abs_err': err, 'tolerance': TOL_LORA_LOGITS,
          'greedy_tokens': LORA_NEW, **streams})
    del params, merged, banked, bank
    _release(torch)


def phase_lora_check(torch, seed, params):
    """llama2-7b at full width in bf16 (the ``serve`` weights),
    decode replayed from CUDA graphs, on both engines: the 8 prompts as a
    mixed batch (two base rows, six over three adapters) on a bank
    engine, and all eight on a bankless engine: the base rows bit for
    bit equal, each adapter row's stream different from the base stream
    of its prompt. Then the same plan on new prompts of the same lengths
    (the same graph keys, no prefix hit) with a fourth adapter in place
    of the first, loaded AFTER the capture into the slot the first held
    (an eviction): no graph is captured, and every replayed stream
    equals a fresh engine's that loaded the fourth adapter first. The
    share of the adapter rows' tokens equal to the offline-merged
    model's is printed (bf16: no identity is asserted), and one replayed
    decode call's ms and device time a step with the mixed batch on the
    bank engine beside the 8 base requests on the bankless one (the
    bank's decode cost, measured in one process on one state). Depth cut
    to CUT_LAYERS (``reduced``)."""
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.models import multilora
    cfg, params, cut = _cut_7b(params)
    saved = graphs._snapshot()
    prompts = _prompts(seed, cfg.vocab_size)
    trees = {f'ad{i}': _lora_tree(cfg, seed * 100 + i) for i in range(4)}
    plan = [None, 'ad0', 'ad1', 'ad2', None, 'ad0', 'ad1', 'ad2']
    for kind in ('paged', 'slot'):
        plain = _lora_engine(torch, kind, cfg, params)
        base = _streams(plain, [(p, {}) for p in prompts])
        eng = _lora_engine(torch, kind, cfg, params, adapter_slots=3,
                           adapter_rank=LORA_RANK)
        for name, tree in trees.items():
            eng.adapters.register(name, tree, scale=1.0)
        mixed = _streams(eng, [(p, {'adapter': a} if a else {})
                               for p, a in zip(prompts, plan)])
        for i, a in enumerate(plan):
            if a is None:
                require(mixed[i] == base[i],
                        f'{kind}: base row {i} of the mixed batch differs '
                        'from the bankless engine')
            else:
                require(mixed[i] != base[i],
                        f'{kind}: adapter {a} did not move row {i}')
        stats = eng.graph_stats()
        require(stats['graph_replays'] > 0, f'{kind}: no graph replayed')
        after = [(p, {'adapter': 'ad3' if a == 'ad0' else a} if a else {})
                 for p, a in zip(_prompts(seed + 1, cfg.vocab_size), plan)]
        got = _streams(eng, after)                    # ad3 evicts ad0
        require(eng.adapters.evictions_total == 1,
                f'{kind}: ad3 did not evict ({eng.adapters.stats()})')
        require(eng.graph_stats()['graph_captures']
                == stats['graph_captures'],
                f'{kind}: the load after capture captured a graph')
        fresh = _lora_engine(torch, kind, cfg, params, adapter_slots=3,
                             adapter_rank=LORA_RANK)
        for name in ('ad3', 'ad1', 'ad2'):
            fresh.adapters.register(name, trees[name], scale=1.0)
        want = _streams(fresh, after)
        require(got == want, f'{kind}: the replayed graph did not follow '
                             f'the adapter loaded after capture')
        del fresh
        _release(torch)
        timing = {
            'bank_off': _decode_timing(torch, plain,
                                       [(p, {}) for p in prompts], 8),
            'bank_on': _decode_timing(torch, eng, [
                (p, {'adapter': a} if a else {})
                for p, a in zip(prompts, plan)], 8)}
        bank_bytes = multilora.bank_bytes(eng.adapters.bank)
        replays = eng.graph_stats()['graph_replays']
        del plain, eng
        # The merged weights (a second copy of every target stack) are
        # built only once the engines are gone, so the phase never holds
        # the merged copy beside its three engines.
        merged = _merged_params(torch, cfg, params, trees['ad0'])
        ref = _streams(_lora_engine(torch, kind, cfg, merged),
                       [(prompts[i], {}) for i in (1, 5)])
        del merged
        same = sum(a == b for i, r in zip((1, 5), ref)
                   for a, b in zip(mixed[i], r))
        emit({'phase': 'lora_check', 'dtype': 'bfloat16', 'kind': kind,
              'model': cfg.name, 'reduced': cut, 'rank': LORA_RANK,
              'sigma': LORA_SIGMA,
              'plan': plan, 'greedy_tokens': LORA_NEW,
              'base_rows_bit_identical': True,
              'adapter_rows_differ_from_base': True,
              'loaded_after_capture_followed': True,
              'adapter_tokens_equal_merged_share':
                  same / (2 * LORA_NEW),
              'bank_bytes': bank_bytes,
              'card': _card_label(), 'decode_call': timing,
              'graph_captures': stats['graph_captures'],
              'graph_replays': replays})
        _release(torch)
    graphs._restore(saved)


def _lora_drive(port, cfg, seed, reset, plan, late):
    """The 8 ``_drive`` requests with ``plan[i]`` merged into request
    i's body, and ``late`` (one more ``/generate`` body) sent 0.3 s into
    the run. Returns ``_drive``'s result and the late request's
    tokens."""
    import threading
    out = {}

    def send_late():
        time.sleep(0.3)
        res, _ = _post(f'http://127.0.0.1:{port}/generate', late, False)
        out['late'] = res['tokens']

    th = threading.Thread(target=send_late)

    def reset_and_start():
        reset()
        th.start()
    res = _drive(port, cfg, seed, reset_and_start, extras=plan)
    th.join()
    require(len(out.get('late', [])) == N_NEW,
            f'the late adapter request brought {out.get("late")}')
    return res, out['late']


def phase_serve_lora(torch, seed, params, adapter_dir, kv_cache='paged',
                     baseline=True):
    """The ``serve`` requests with a bank of LORA_SLOTS slots over
    ``adapter_dir`` (five rank-LORA_RANK ``.npz`` adapters written from
    the seed): two base requests and six over three adapters (one named
    as ``model: "llama2-7b:<name>"``), after a warm request has loaded a
    fourth adapter, and a late fifth-adapter request sent into the run,
    which evicts the fourth mid-run. The path's kernels: K1 once per
    layer per decode step (paged), K4/K3 once per layer per prefill call
    (slot). Before them (``baseline``), the same 9 requests at the same
    times, all on the base model, on a bankless server: TTFT and TPOT
    with the bank on and off. Returns the launch counts."""
    from skypilot_tpu_torch.models import configs, multilora
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    phase = 'serve_lora' if kv_cache == 'paged' else 'serve_lora_slot'
    late = {'prompt': _prompts(seed + 1, configs.LLAMA2_7B.vocab_size)[0],
            'max_new_tokens': N_NEW}
    off = 'not measured (reduced: no bankless baseline)'
    if baseline:
        srv, port = _sched_server(params, seed, kv_cache=kv_cache)
        try:
            # The same requests and timing, every one on the base model.
            (_, ttfts, wall), _ = _lora_drive(port, srv.engine.cfg, seed,
                                              lambda: None, [{}] * 8, late)
            m = srv.metrics_json()
            off = {'tpot_ms_median': m['tpot_ms_median'],
                   'ttft_ms_median_client': float(sorted(ttfts)[
                       len(ttfts) // 2]), 'wall_s': wall}
        finally:
            srv.stop()
        del srv
        _release(torch)
    torch.cuda.reset_peak_memory_stats()
    srv, port = _sched_server(params, seed, kv_cache=kv_cache,
                              adapter_slots=LORA_SLOTS,
                              adapter_dir=adapter_dir,
                              adapter_rank=LORA_RANK)
    try:
        eng = srv.engine
        cfg = eng.cfg
        reg = eng.adapters
        require(reg is not None and reg.slots == LORA_SLOTS, 'no bank')
        _post(f'http://127.0.0.1:{port}/generate',
              {'prompt': [1, 2, 3], 'max_new_tokens': 2,
               'adapter': 'tenant3'}, False)
        plan = [{}, {'adapter': 'tenant0'},
                {'model': 'llama2-7b:tenant1'}, {'adapter': 'tenant2'},
                {}, {'adapter': 'tenant0'}, {'adapter': 'tenant1'},
                {'adapter': 'tenant2'}]
        late = dict(late, adapter='tenant4')
        loads0, evict0 = reg.loads_total, reg.evictions_total
        steps0 = eng.decode_substeps
        calls0 = dict(getattr(eng, 'prefill_calls', {}))

        def reset():                     # counts to 0 just before the path
            pa.reset_launch_counts()
            fa.reset_launch_counts()
        (counts, ttfts, wall), _ = _lora_drive(port, cfg, seed, reset,
                                               plan, late)
        paged_after = dict(pa.launch_counts)
        flash_after = dict(fa.launch_counts)
        steps = eng.decode_substeps - steps0
        stats = reg.stats()
        require(reg.loads_total - loads0 == 4
                and reg.evictions_total - evict0 == 1,
                f'{phase}: loads/evictions {stats}')
        require(stats['pinned'] == {} and stats['used'] == LORA_SLOTS,
                f'{phase}: pins left {stats}')
        if kv_cache == 'paged':
            key = 'paged_decode_attention[bf16]'
            launches = {key: paged_after[key]}
            require(paged_after[key] == cfg.n_layers * steps and steps > 0,
                    f'{key} launches {paged_after[key]} != n_layers x '
                    f'decode steps {steps}')
            require(sum(paged_after.values()) == paged_after[key]
                    and not any(flash_after.values()),
                    f'other kernels on the {phase} path: {paged_after} '
                    f'{flash_after}')
        else:
            calls = {k: eng.prefill_calls[k] - calls0[k] for k in calls0}
            k4, k3 = flash_after['flash_fwd'], flash_after['flash_fwd_chunk']
            launches = {'flash_fwd': k4, 'flash_fwd_chunk': k3}
            require(k4 == cfg.n_layers * calls['uncached'] and k4 > 0
                    and k3 == cfg.n_layers * calls['cached'] and k3 > 0,
                    f'K4/K3 launches {launches} != {cfg.n_layers} x '
                    f'prefill calls {calls}')
            require(not any(paged_after.values()),
                    f'paged kernels on the slot path: {paged_after}')
        emit(_serve_line(
            torch, phase, cfg, srv, counts, ttfts, wall, weights='bfloat16',
            kv_cache=kv_cache, card=_card_label(),
            plan=[p.get('adapter') or p.get('model') for p in plan],
            late_adapter='tenant4', lora=stats,
            bank_bytes=multilora.bank_bytes(reg.bank),
            decode_steps=steps, kernel_launches=launches,
            bank_off=off,
            reduced=(None if baseline else
                     {'bank_off': 'no bankless baseline run'})))
    finally:
        srv.stop()
    del eng, srv, reg
    _release(torch)
    return launches


def phase_grammar_check(torch, seed, params):
    """Grammar masks on llama2-7b at full width in bf16, both engines,
    speculation off and at k = SPEC_K (spec prompts, so the proposer
    drafts): a ``"json"`` request, a token-id-list request and an
    unconstrained one batched together; every token of a grammar request
    lies inside its mask."""
    import numpy as np
    from skypilot_tpu_torch.inference import adapters, graphs
    from skypilot_tpu_torch.models import configs
    cfg = configs.LLAMA2_7B
    saved = graphs._snapshot()
    prompts = _spec_prompts(seed, cfg.vocab_size)
    rng = np.random.default_rng(seed + 31)
    ids = sorted(int(t) for t in rng.choice(cfg.vocab_size, GRAMMAR_IDS,
                                            replace=False))
    json_mask = adapters.compile_grammar('json', cfg.vocab_size)
    for kind in ('paged', 'slot'):
        for k in (0, SPEC_K):
            eng = _lora_engine(torch, kind, cfg, params, speculate_k=k)
            out = _streams(eng, [(prompts[0], {'grammar': 'json'}),
                                 (prompts[1], {'grammar': ids}),
                                 (prompts[2], {})], n_new=N_NEW)
            require(all(json_mask[t] for t in out[0]),
                    f'{kind} k={k}: json tokens outside the mask {out[0]}')
            require(set(out[1]) <= set(ids),
                    f'{kind} k={k}: id-list tokens outside it {out[1]}')
            require(len(out[0]) == len(out[1]) == N_NEW, 'short stream')
            emit({'phase': 'grammar_check', 'kind': kind, 'model': cfg.name,
                  'speculate_k': k, 'new_tokens': N_NEW,
                  'inside_mask': True, 'id_grammar_size': GRAMMAR_IDS,
                  'spec': eng.spec_metrics() if k else None,
                  'unconstrained_outside_json': sum(
                      not json_mask[t] for t in out[2])})
            del eng
            _release(torch)
    graphs._restore(saved)


def phase_lora_audit(torch):
    """``audit_adapters`` on the card at llama2-7b's width, depth cut to
    AUDIT_LAYERS, both engines, speculation off and at k = SPEC_K: a
    two-slot bank at rank LORA_RANK with grammar masks live, adapters
    loading and evicting in every audited wave: no capture after the
    warm-up, no unsanctioned sync, the bank's storage unmoved."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference import graphs
    cfg = _spec_cfg(torch, torch.bfloat16)
    saved = graphs._snapshot()
    for kind in ('paged', 'slot'):
        for k in (0, SPEC_K):
            report = audit.audit_adapters(kind, cfg=cfg, rank=LORA_RANK,
                                          speculate_k=k)
            emit({'phase': 'lora_audit', 'model': cfg.name,
                  'reduced': {'n_layers': [32, AUDIT_LAYERS]},
                  **report.as_dict()})
            require(report.ok() and report.captures[0] > 0,
                    f'{report.name}: {report.violations()}')
            _release(torch)
    graphs._restore(saved)


_TIME_KEYS = ('ms', 'device_ms', 'device_ms_source', 'host_us', 'plain_ms',
              'bound_ms', 'bound_by', 'library_ms')


# ------------------------------------------------ LoRA fine-tuning
LORA_TRAIN = dict(model='llama3-8b', rank=16, alpha=32.0,
                  targets=('wq', 'wk', 'wv', 'wo'), batch=2, seq=2048,
                  steps=6, lr=1e-3)            # 10 steps before the cut
LORA_REMAT_STEPS = 2           # lora_remat's steps under each policy (5
                               # before the cuts for time)
LORA_CHECK_LAYERS = 2          # depth of the bit-for-bit and fp32 checks
LORA_CLI = dict(batch=2, seq=1024, steps=(2, 4))         # run, then resume


def _lora_train_cfg(remat='block', n_layers=None):
    """llama3-8b with LORA_TRAIN's adapters under ``remat``; the depth
    cut to ``n_layers`` where given (the name then says so)."""
    import dataclasses
    from skypilot_tpu_torch.models import configs
    t = LORA_TRAIN
    cfg = dataclasses.replace(
        configs.get_config(t['model']), remat=remat, lora_rank=t['rank'],
        lora_alpha=t['alpha'], lora_targets=t['targets'])
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  name=f'{cfg.name}-depth{n_layers}')
    return cfg


def _lora_batch(torch, seed, cfg):
    """The first packed LORA_TRAIN batch of the seeded corpus, on the
    card."""
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'corpus.txt'),
                                           seed),
                             load_tokenizer(None, cfg.vocab_size))
    batch = next(packed_batches(stream, batch=LORA_TRAIN['batch'],
                                seq=LORA_TRAIN['seq']))
    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


def _base_leaves(params):
    """The frozen base's leaves (everything but ``layers['lora']``)."""
    from skypilot_tpu_torch.train.optim import tree_leaves
    return list(tree_leaves(dict(params, layers={
        k: v for k, v in params['layers'].items() if k != 'lora'})))


def _pinned_copy(torch, tensors):
    """Host copies of CUDA tensors in pinned memory."""
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        out.append(h)
    return out


def _bits_equal(torch, card, host):
    """Each card tensor equal byte for byte to its host copy (compared
    on the card, one leaf at a time)."""
    return all(torch.equal(a.view(torch.uint8),
                           b.to(a.device).view(torch.uint8))
               for a, b in zip(card, host))


def _tree_bytes(tree):
    from skypilot_tpu_torch.train.optim import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _lora_flops(cfg, tokens):
    """Model FLOPs of a step as ``phase_train`` counts them: 6 N a
    token (forward, the remat forward and the input gradients: a frozen
    base takes no weight gradient) plus the causal attention."""
    attn = 3 * 4 * cfg.head_dim * cfg.n_heads * LORA_TRAIN['batch'] * (
        LORA_TRAIN['seq'] * (LORA_TRAIN['seq'] + 1) // 2) * cfg.n_layers
    return cfg.flops_per_token(training=True) * tokens + attn


def phase_lora_train(torch, seed):
    """llama3-8b at full width and depth, bf16 base from the seed, rank-16
    adapters on q, k, v and o, remat 'block': LORA_TRAIN['steps'] steps
    of ``Trainer.fit`` on one repeated batch (2 x 2048). Every base leaf
    is bit for bit its copy from before training (kept in pinned host
    memory, compared as bytes), every ``b`` factor moved, the last loss is below the
    first; K4 2L and K5a, K5b L launches a step. Returns (K4, K5a, K5b
    launches, the trained params, the batch)."""
    import itertools
    import statistics
    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = _lora_train_cfg()
    L, n = cfg.n_layers, LORA_TRAIN['steps']
    tc = TrainConfig(learning_rate=LORA_TRAIN['lr'], warmup_steps=1,
                     total_steps=n)
    batch = _lora_batch(torch, seed, cfg)
    _release(torch)
    t0 = time.monotonic()
    trainer = Trainer(cfg, train_config=tc, device='cuda')
    state = trainer.init(seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    t0 = time.monotonic()
    base_copy = _pinned_copy(torch, _base_leaves(state.params))
    b0 = {t: ab['b'].clone() for t, ab in lora.split_lora(
        state.params).items()}
    copy_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    log = _StepLog()
    pa.reset_launch_counts()             # counts to 0 just before the path
    fa.reset_launch_counts()
    state = trainer.fit(state, itertools.repeat(batch), n, [log])
    flash_after, paged_after = dict(fa.launch_counts), dict(pa.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k4, k5a, k5b = (flash_after[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                              'flash_bwd_dq'))
    t0 = time.monotonic()
    base_same = _bits_equal(torch, _base_leaves(state.params), base_copy)
    compare_s = time.monotonic() - t0
    del base_copy
    moved = {t: float((ab['b'] - b0[t]).abs().max())
             for t, ab in lora.split_lora(state.params).items()}
    losses = [m['loss'] for m in log.metrics]
    step_s = statistics.median(log.times[1:])
    tokens = LORA_TRAIN['batch'] * LORA_TRAIN['seq']
    flops = _lora_flops(cfg, tokens)
    adapter_bytes = _tree_bytes(lora.split_lora(state.params))
    opt = state.opt_state
    emit({'phase': 'lora_train', 'model': cfg.name, 'card': _card_label(),
          'n_params': cfg.num_params, 'dtype': 'bfloat16',
          'remat': cfg.remat, 'rank': cfg.lora_rank,
          'alpha': cfg.lora_alpha, 'targets': list(cfg.lora_targets),
          'batch': LORA_TRAIN['batch'], 'seq': LORA_TRAIN['seq'],
          'steps': n, 'lr': tc.learning_rate,
          'lora_weight_decay': tc.lora_weight_decay, 'init_s': init_s,
          'losses': losses, 'grad_norms': [m['grad_norm']
                                           for m in log.metrics],
          'step_s': log.times, 'step_s_median_after_step_1': step_s,
          'tok_s': tokens / step_s, 'model_flops_per_step': flops,
          'model_tflop_s': flops / step_s / 1e12,
          'mfu': flops / step_s / FLOP_PEAKS['bf16_tensor_cores'],
          'peak_mem_gb': peak_gb,
          'launches_per_step': {'flash_fwd': k4 / n, 'flash_bwd_dkv': k5a / n,
                                'flash_bwd_dq': k5b / n},
          'adapter_params': sum(t.numel() for t in b0.values()) + sum(
              ab['a'].numel() for ab in lora.split_lora(
                  state.params).values()),
          'adapter_bytes': adapter_bytes,
          'optimizer_bytes': _tree_bytes(opt.mu) + _tree_bytes(opt.nu),
          'base_bit_identical': base_same, 'b_max_abs_move': moved,
          'base_copy_s': copy_s, 'base_compare_s': compare_s})
    require(base_same, 'a frozen base leaf changed during LoRA training')
    require(all(v > 0 for v in moved.values()), f'b did not move: {moved}')
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f'losses {losses}: not finite and falling')
    require(k4 == 2 * L * n and k5a == L * n and k5b == L * n,
            f'launches K4 {k4} (want {2 * L * n}), K5a {k5a}, K5b {k5b} '
            f'(want {L * n} each)')
    require(flash_after['flash_fwd_chunk'] == 0
            and not any(paged_after.values()),
            f'other kernels launched on the lora_train path: {flash_after} '
            f'{paged_after}')
    require(peak_gb < 80, f'peak memory {peak_gb} GB')
    params = state.params
    del trainer, state, log, opt
    _release(torch)
    return (k4, k5a, k5b), params, batch


def phase_lora_remat(torch, seed, params, batch):
    """The trained model (a copy of its adapters) under remat 'block',
    'attn' and 'dots', LORA_REMAT_STEPS steps each: peak memory, step
    time and K4 launches a step (L under 'attn', 2L under the others);
    then at llama3-8b's width, depth cut to LORA_CHECK_LAYERS, one
    ``value_and_grad`` under each policy equals 'none' bit for bit (K4,
    K5a and K5b sum in a fixed order). Returns the launches of the
    three runs (K4, K5a, K5b)."""
    import itertools
    import statistics
    from skypilot_tpu_torch.models import llama, lora
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer as tr
    from skypilot_tpu_torch.train.optim import tree_leaves, tree_map
    n = LORA_REMAT_STEPS
    tc = tr.TrainConfig(learning_rate=LORA_TRAIN['lr'], warmup_steps=1,
                        total_steps=n)
    runs, totals = {}, {'flash_fwd': 0, 'flash_bwd_dkv': 0,
                        'flash_bwd_dq': 0}
    for remat in ('block', 'attn', 'dots'):
        cfg = _lora_train_cfg(remat)
        trainer = tr.Trainer(cfg, train_config=tc, device='cuda')
        state = trainer.state_from_params(lora.with_lora(
            params, tree_map(torch.clone, lora.split_lora(params))))
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        log = _StepLog()
        fa.reset_launch_counts()         # counts to 0 just before the path
        trainer.fit(state, itertools.repeat(batch), n, [log])
        counts = dict(fa.launch_counts)
        for k in totals:
            totals[k] += counts[k]
        runs[remat] = {
            'step_s': log.times,
            'step_s_median_after_step_1': statistics.median(log.times[1:]),
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'k4_per_step': counts['flash_fwd'] / n,
            'k5a_per_step': counts['flash_bwd_dkv'] / n,
            'k5b_per_step': counts['flash_bwd_dq'] / n,
            'losses': [m['loss'] for m in log.metrics]}
        del trainer, state, log
        _release(torch)
    L = params['layers']['wq'].shape[0]
    for remat, want in (('block', 2 * L), ('attn', L), ('dots', 2 * L)):
        require(runs[remat]['k4_per_step'] == want
                and runs[remat]['k5a_per_step'] == L
                and runs[remat]['k5b_per_step'] == L,
                f'{remat}: launches a step {runs[remat]} (K4 want {want})')
    small = _lora_train_cfg('none', n_layers=LORA_CHECK_LAYERS)
    sp = llama.init_params(small, seed)
    gen = torch.Generator(device='cuda').manual_seed(seed + 5)
    for ab in lora.split_lora(sp).values():
        ab['b'].normal_(0.0, 0.01, generator=gen)   # a live delta
    grads, before = {}, dict(fa.launch_counts)
    for remat in ('none', 'block', 'attn', 'dots'):
        cfg = _lora_train_cfg(remat, n_layers=LORA_CHECK_LAYERS)
        grads[remat] = tr.value_and_grad(sp, batch, cfg)
    fa.launch_counts.update(before)  # the bit-for-bit check is no main path
    equal = {r: torch.equal(grads[r][0], grads['none'][0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(grads[r][2]),
                                          tree_leaves(grads['none'][2])))
        for r in ('block', 'attn', 'dots')}
    emit({'phase': 'lora_remat', 'model': LORA_TRAIN['model'],
          'card': _card_label(), 'steps': n, 'batch': LORA_TRAIN['batch'],
          'seq': LORA_TRAIN['seq'], 'policies': runs,
          'grads_equal_none_bit_for_bit': equal,
          'reduced': {'n_layers': [L, LORA_CHECK_LAYERS],
                      'what': 'the bit-for-bit gradient check only',
                      'steps': [5, n]}})
    require(all(equal.values()),
            f'remat policies change the gradients: {equal}')
    del sp, grads
    _release(torch)
    return tuple(totals[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                     'flash_bwd_dq'))


def _adapter_host(tree, n_layers=None):
    """An adapter tree on the card as host numpy, the first ``n_layers``
    layers where given."""
    return {t: {k: v[:n_layers].float().cpu().numpy() for k, v in ab.items()}
            for t, ab in tree.items()}


def phase_lora_serve(torch, seed, params):
    """The adapter lora_train trained, written by ``multilora.save_adapter``
    into a temporary ``adapter_dir`` and served on a paged llama3-8b
    engine with a 2-slot bank (K1 in the decode graphs): the 8 prompts,
    every other one over the adapter, LORA_NEW greedy tokens each. The
    base rows equal a bankless engine's bit for bit; the share of the
    adapter rows' tokens equal to the offline-merged model's
    (``lora.merge``) is reported (bf16: no identity is asserted). Then
    at fp32 with the depth cut to LORA_CHECK_LAYERS (the trained
    adapter's first layers): logits of the bank-served adapter within
    TOL_LORA_LOGITS of the merged model's and the greedy tokens equal to
    it on both engines. Returns the bank engine's K1 launches."""
    import dataclasses
    from skypilot_tpu_torch.inference import graphs
    from skypilot_tpu_torch.models import configs, llama, lora, multilora
    from skypilot_tpu_torch.ops import paged_attention as pa
    tcfg = _lora_train_cfg()
    cfg = configs.get_config(LORA_TRAIN['model'])
    saved = graphs._snapshot()
    tree = _adapter_host(lora.split_lora(params))
    base = dict(params, layers={k: v for k, v in params['layers'].items()
                                if k != 'lora'})
    prompts = _prompts(seed, cfg.vocab_size)
    plan = [None, 'trained'] * 4
    kw = dict(adapter_slots=2, adapter_rank=tcfg.lora_rank)
    with tempfile.TemporaryDirectory() as adapter_dir:
        multilora.save_adapter(os.path.join(adapter_dir, 'trained.npz'),
                               tcfg, tree)
        plain = _streams(_lora_engine(torch, 'paged', cfg, base),
                         [(p, {}) for p in prompts])
        _release(torch)
        eng = _lora_engine(torch, 'paged', cfg, base,
                           adapter_dir=adapter_dir, **kw)
        pa.reset_launch_counts()         # counts to 0 just before the path
        mixed = _streams(eng, [(p, {'adapter': a} if a else {})
                               for p, a in zip(prompts, plan)])
        k1 = pa.launch_counts['paged_decode_attention[bf16]']
        stats = eng.graph_stats()
        del eng
    _release(torch)
    for i, a in enumerate(plan):
        if a is None:
            require(mixed[i] == plain[i],
                    f'lora_serve: base row {i} differs from the bankless '
                    'engine')
    rows = [i for i, a in enumerate(plan) if a]
    _, merged = lora.merge(tcfg, params)
    ref = _streams(_lora_engine(torch, 'paged', cfg, merged),
                   [(prompts[i], {}) for i in rows])
    del merged
    _release(torch)
    same = sum(a == b for i, r in zip(rows, ref) for a, b in zip(mixed[i], r))
    moved = sum(a != b for i in rows for a, b in zip(mixed[i], plain[i]))
    require(k1 > 0 and stats['graph_replays'] > 0,
            f'lora_serve: K1 {k1}, graphs {stats}')
    # fp32, depth cut: the trained adapter's first layers.
    small = dataclasses.replace(cfg, n_layers=LORA_CHECK_LAYERS,
                                dtype=torch.float32,
                                name=f'{cfg.name}-depth{LORA_CHECK_LAYERS}')
    stcfg = dataclasses.replace(tcfg, n_layers=LORA_CHECK_LAYERS,
                                dtype=torch.float32)
    sp = llama.init_params(small, seed)
    stree = _adapter_host(lora.split_lora(params), LORA_CHECK_LAYERS)
    dev_tree = {t: {k: torch.from_numpy(v).cuda() for k, v in ab.items()}
                for t, ab in stree.items()}
    smerged = lora.merge(stcfg, lora.with_lora(sp, dev_tree))[1]
    scale = stcfg.lora_scale
    bank = multilora.init_bank(small, 2, stcfg.lora_rank,
                               dtype=torch.float32)
    multilora.set_bank_row(bank, multilora.adapter_row_from_tree(
        small, stree, stcfg.lora_rank, scale,
        targets=multilora.default_targets(small)), 1)
    banked = dict(sp, layers=dict(sp['layers'], mlora=bank))
    tokens = torch.tensor([prompts[0][:256]], device='cuda')
    with torch.no_grad():
        got = llama.forward(banked, tokens, small,
                            mlora_idx=torch.tensor([1], device='cuda'))
        want = llama.forward(smerged, tokens, small)
        unadapted = llama.forward(sp, tokens, small)
    err = float((got - want).abs().max())
    delta = float((want - unadapted).abs().max())
    require(err <= TOL_LORA_LOGITS,
            f'lora_serve fp32: bank vs merged logits differ by {err}')
    fp32 = {}
    for kind in ('paged', 'slot'):
        eng = _lora_engine(torch, kind, small, sp, **kw)
        eng.adapters.register('trained', stree, scale=scale)
        got_s = _streams(eng, [(prompts[0], {'adapter': 'trained'}),
                               (prompts[1], {})])
        ref_s = _streams(_lora_engine(torch, kind, small, smerged),
                         [(prompts[0], {})])[0]
        require(got_s[0] == ref_s,
                f'lora_serve fp32 {kind}: adapter stream != merged')
        fp32[kind] = {'adapter_equal_merged': True,
                      'graph_replays': eng.graph_stats()['graph_replays']}
        del eng
        _release(torch)
    graphs._restore(saved)
    emit({'phase': 'lora_serve', 'model': cfg.name, 'card': _card_label(),
          'rank': tcfg.lora_rank, 'fold_scale': tcfg.lora_scale,
          'plan': plan, 'greedy_tokens': LORA_NEW,
          'base_rows_bit_identical': True,
          'adapter_tokens_equal_merged_share': same / (len(rows) * LORA_NEW),
          'adapter_tokens_differing_from_base': moved,
          'k1_launches': k1, 'graph_captures': stats['graph_captures'],
          'graph_replays': stats['graph_replays'],
          'fp32': {'reduced': {'n_layers': [cfg.n_layers,
                                            LORA_CHECK_LAYERS]},
                   'logits_max_abs_err': err, 'tolerance': TOL_LORA_LOGITS,
                   'adapter_logit_delta_max': delta,
                   'greedy_tokens': LORA_NEW, **fp32}})
    del sp, smerged, banked, bank
    _release(torch)
    return k1


def phase_lora_cli(torch, seed):
    """``python -m skypilot_tpu_torch.train`` (its ``main``) with
    ``--lora-rank 16 --adapter-out`` on llama3-8b's width, depth cut to
    LORA_CHECK_LAYERS (a preset registered for the run), on a corpus
    written from the seed: LORA_CLI['steps'][0] steps with a checkpoint,
    then a relaunch that resumes from ``LATEST`` to the second count and
    writes the adapter; the adapter loads back (``load_adapter``) equal
    bit for bit to the last checkpoint's."""
    import contextlib
    import dataclasses
    import io
    from skypilot_tpu_torch.models import configs, lora
    from skypilot_tpu_torch.train.__main__ import main as train_main
    from skypilot_tpu_torch.train.optim import tree_leaves
    from skypilot_tpu_torch.train.trainer import Trainer
    t = LORA_TRAIN
    base = configs.get_config(t['model'])
    cfg = dataclasses.replace(base, n_layers=LORA_CHECK_LAYERS,
                              name=f'{base.name}-depth{LORA_CHECK_LAYERS}')
    first, last = LORA_CLI['steps']
    configs.PRESETS[cfg.name] = cfg
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck, out = os.path.join(tmp, 'ck'), os.path.join(tmp, 'adapter')
            argv = ['--model', cfg.name, '--data',
                    _write_corpus(os.path.join(tmp, 'corpus.txt'), seed),
                    '--batch', str(LORA_CLI['batch']),
                    '--seq', str(LORA_CLI['seq']), '--lr', str(t['lr']),
                    '--warmup-steps', '1', '--log-every', '1',
                    '--ckpt-dir', ck, '--lora-rank', str(t['rank']),
                    '--lora-alpha', str(t['alpha']),
                    '--lora-targets', ','.join(t['targets']),
                    '--adapter-out', out]
            logs = []
            t0 = time.monotonic()
            for steps in (first, last):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    train_main(argv + ['--steps', str(steps)])
                logs.append(buf.getvalue())
            run_s = time.monotonic() - t0
            lines = [json.loads(ln) for text in logs
                     for ln in text.splitlines() if ln.startswith('{')]
            lcfg = dataclasses.replace(
                cfg, lora_rank=t['rank'], lora_alpha=t['alpha'],
                lora_targets=t['targets'])
            trainer = Trainer(lcfg, device='cuda')
            resumed = trainer.restore_checkpoint(
                os.path.join(ck, f'step_{last}'))
            loaded = trainer.load_adapter(out, resumed)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(lora.split_lora(loaded.params)),
                tree_leaves(lora.split_lora(resumed.params))))
            with open(out + '.lora.json', encoding='utf-8') as f:
                sidecar = json.load(f)
            adapter_bytes = os.path.getsize(os.path.join(out, 'adapter.pt'))
    finally:
        del configs.PRESETS[cfg.name]
    resumed_ok = f'step_{first} at step {first}' in logs[1]
    emit({'phase': 'lora_cli', 'model': base.name, 'card': _card_label(),
          'reduced': {'n_layers': [base.n_layers, LORA_CHECK_LAYERS]},
          'batch': LORA_CLI['batch'], 'seq': LORA_CLI['seq'],
          'steps': [ln['step'] for ln in lines],
          'losses': [ln['loss'] for ln in lines],
          'resumed_from_latest': resumed_ok, 'adapter_bytes': adapter_bytes,
          'sidecar': sidecar, 'adapter_equal_checkpoint': same,
          'run_s': run_s})
    require(resumed_ok, f'the relaunch did not resume: {logs[1][:400]}')
    require([ln['step'] for ln in lines] == list(range(1, last + 1)),
            f'steps logged {lines}')
    require(all(math.isfinite(ln['loss']) for ln in lines),
            f'losses {lines}')
    require(same, 'the loaded adapter differs from the checkpoint')
    del trainer, resumed, loaded
    _release(torch)


# ------------------------------------------- W8A8 serving, fault surface
W8A8_PREFILL_REPS = 3           # (off, on, on, off) rounds of the timed
                                # prefill call
FAULT_WATCHDOG_S = 5.0          # the wedge phase's step deadline
FAULT_WEDGE_AT = 3              # engine_step invocation that wedges
FAULT_NAN_AT = 2                # engine_step invocation of the NaN eviction
FAULT_STREAMS = 4               # concurrent streams of the NaN eviction
MEMORY_CREEP_BYTES = 67e6       # live memory a 7B phase kept after
                                # collection in earlier runs
_HEALTHY_STEP_MAX = {'s': 0.0, 'phase': None}


def _beside(rec):
    """The latency and throughput of a recorded serve line, to stand
    beside another's."""
    return {k: rec[k] for k in ('ttft_ms_median', 'tpot_ms_median_server',
                                'output_tok_s', 'wall_s')}


def _w8a8_prefill_ms(torch, eng):
    """One paged prefill chunk call at the served batch (8 rows x the
    engine's chunk, from an empty context, into the pool's last pages,
    which this phase never allocates) with the W8A8 region off and on,
    in turns (off, on, on, off) x W8A8_PREFILL_REPS, each call between
    CUDA events; and the int8 GEMMs one call launches. Launches here are
    measurements, not the main path: the counts are put back."""
    from skypilot_tpu_torch.inference import paged
    from skypilot_tpu_torch.models import quantization as q
    n, chunk = 8, eng.chunk
    P = -(-chunk // eng.page)
    top = eng.alloc.n_pages
    require(top > 2 * n * P, f'pool of {top} pages too small to time')
    table = torch.arange(top - n * P, top, dtype=torch.int32,
                         device='cuda').reshape(n, P)
    g = torch.Generator(device='cuda')
    g.manual_seed(11)
    tokens = torch.randint(3, eng.cfg.vocab_size, (n, chunk), generator=g,
                           device='cuda', dtype=torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32, device='cuda')
    valid = torch.full((n,), chunk, dtype=torch.int32, device='cuda')
    want = torch.full((n,), chunk - 1, dtype=torch.int32, device='cuda')
    saved = dict(q.launch_counts)

    def call(w8a8):
        return paged.paged_prefill_chunk(eng.params, eng.cache, table,
                                         tokens, zeros, valid, want,
                                         eng.cfg, w8a8=w8a8)[0]
    firsts = {w: call(w) for w in (False, True)}
    torch.cuda.synchronize()
    q.reset_launch_counts()
    call(True)
    per_call = q.launch_counts['int_mm']
    times = {False: [], True: []}
    for _ in range(W8A8_PREFILL_REPS):
        for w in (False, True, True, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(w)
            end.record()
            torch.cuda.synchronize()
            times[w].append(start.elapsed_time(end))
    q.launch_counts.update(saved)
    require(per_call == W8A8_PRODUCTS * eng.cfg.n_layers,
            f'{per_call} int8 GEMMs a prefill call')
    return {'prefill_call': {'rows': n, 'chunk': chunk,
                             'ms_w8a16': sorted(times[False]),
                             'ms_w8a8': sorted(times[True]),
                             'int_mm_per_call': per_call,
                             'first_tokens_equal_share': float(
                                 (firsts[False] == firsts[True]).float()
                                 .mean())}}


def _token_share(a, b):
    """The share of positions where two lists of streams agree."""
    pairs = [(x, y) for sa, sb in zip(a, b) for x, y in zip(sa, sb)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def phase_serve_w8a8(torch, seed, params, int8_rec, int8_tokens):
    """The ``serve_int8`` weights and requests behind a paged server
    with ``prefill_w8a8`` (K1 decode on int8 KV, the int8 GEMM in every
    prefill layer product): latency and throughput beside
    ``serve_int8``'s, the served prefill call's device time with the
    region on and off, the share of ``/generate`` tokens equal to
    ``serve_int8``'s (reported, not asserted). Returns the K1 launches."""
    tokens = []

    def after(srv, eng):
        require(eng.prefill_w8a8, 'prefill_w8a8 did not reach the engine')
        return dict(_w8a8_prefill_ms(torch, eng),
                    serve_int8=_beside(int8_rec),
                    tokens_equal_serve_int8_share=_token_share(
                        tokens, int8_tokens))
    launches, _ = phase_serve(torch, seed, 'serve_w8a8', params=params,
                              quantize='int8', prefill_w8a8=True,
                              tokens=tokens, after_drive=after,
                              extra={'prefill_w8a8': True,
                                     'card': _card_label()})
    return launches


def _memory_diff(before, after):
    """Active blocks of two ``torch.cuda.memory_snapshot()`` calls: the
    bytes held in each, and the blocks only the second holds (largest
    first) with the Python frames that allocated them (recorded while
    the memory history was on)."""
    def blocks(snap):
        out = {}
        for seg in snap:
            addr = seg['address']
            for b in seg['blocks']:
                if b['state'] == 'active_allocated':
                    out[b.get('address', addr)] = b
                addr += b['size']
        return out
    b0, b1 = blocks(before), blocks(after)
    new = sorted((b for a, b in b1.items() if a not in b0),
                 key=lambda b: -b['size'])
    return {'active_bytes_before': sum(b['size'] for b in b0.values()),
            'active_bytes_after': sum(b['size'] for b in b1.values()),
            'new_blocks': [{'size': b['size'], 'frames': [
                f"{f['filename'].split('/')[-1]}:{f['line']} {f['name']}"
                for f in b.get('frames', [])[:6]]} for b in new[:6]]}


def _fault_server(params, seed, **kw):
    from skypilot_tpu_torch.serve.server import ModelServer
    _fresh_registry()
    srv = ModelServer('llama2-7b', max_batch=8, max_seq=2048,
                      port=_free_port(), seed=seed, params=params, **kw)
    srv.start(block=False)
    srv.wait_ready(timeout=600)
    return srv


def phase_fault_watchdog(torch, seed, params):
    """The fault surface on a llama2-7b bf16 paged server at full width
    (the ``serve`` weights, K1 decode): a ``wedged_step`` injected at
    ``engine_step`` #3 under a 5 s step watchdog must flip /readiness to
    a 503 ``degraded``, end the stream in flight with a retryable error,
    refuse a new submit with 503 + Retry-After, count
    ``skytpu_gray_failures_total{kind="wedged_step"}`` once and capture
    no graph after the wedge; detection (watchdog clock, from the wedge's
    stamp to the degrade) must lie in (5.0, 6.9] s. Then a fresh server
    with ``nan_logits`` at ``engine_step`` #2: of 4 concurrent streams
    exactly one is evicted retryably, the others complete, the replica
    stays ready and serves on. Live card memory before and after, and
    the blocks a growth above MEMORY_CREEP_BYTES holds. Returns the K1
    launches of both servers' requests."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve import faults
    key = 'paged_decode_attention[bf16]'
    _release(torch)
    alloc0 = torch.cuda.memory_allocated()
    snap0 = torch.cuda.memory_snapshot()
    # Python stacks of the allocations from here on, to name what a
    # growth holds.
    torch.cuda.memory._record_memory_history(
        enabled='all', context='alloc', stacks='python', max_entries=200000)
    card = _card_label()
    prompts = _prompts(seed, 32000)
    srv = _fault_server(params, seed, step_watchdog_s=FAULT_WATCHDOG_S,
                        fault_spec={'seed': seed, 'rules': [
                            {'kind': 'wedged_step', 'site': 'engine_step',
                             'at': FAULT_WEDGE_AT}]})
    try:
        eng = srv.engine
        cfg = eng.cfg
        steps0 = eng.decode_substeps
        pa.reset_launch_counts()
        status, events, first_ms, _ = _sse_timed(
            srv.port, '/generate', {'prompt': prompts[3], 'stream': True,
                                    'max_new_tokens': 512})
        t_err = time.monotonic()
        launches = pa.launch_counts[key]
        steps = eng.decode_substeps - steps0
        captures = eng.graph_stats()['graph_captures']
        wedge_stamp = srv._step_started
        require(status == 200 and events and 'error' in events[-1],
                f'the wedge never surfaced on the stream: {events[-1:]}')
        err = events[-1]
        require(err.get('retryable') is True,
                f'stream error not retryable: {err}')
        n_tokens = sum('token' in e for e in events)
        require(wedge_stamp is not None and srv.degraded_at is not None,
                'no wedge stamp or degrade time')
        detect_s = srv.degraded_at - wedge_stamp
        require(FAULT_WATCHDOG_S < detect_s <= 6.9,
                f'detection took {detect_s} s, outside (5.0, 6.9]')
        code, _, body = _http(srv.port, '/readiness')
        ready = json.loads(body)
        require(code == 503 and ready.get('status') == 'degraded'
                and 'wedged_step' in ready.get('cause', ''),
                f'/readiness {code} {ready}')
        code2, headers2, body2 = _http(
            srv.port, '/generate', {'prompt': prompts[0],
                                    'max_new_tokens': 4})
        require(code2 == 503 and headers2.get('Retry-After'),
                f'a new submit got {code2} {dict(headers2)}')
        _, _, prom = _http(srv.port, '/metrics')
        gray_line = 'skytpu_gray_failures_total{kind="wedged_step"} 1'
        require(gray_line in prom.decode(),
                'the wedged_step gray counter is not 1')
        require(faults.gray_failure_counter('wedged_step').value == 1,
                'the wedged_step gray counter moved more than once')
        time.sleep(1.0)
        require(eng.graph_stats()['graph_captures'] == captures
                and eng.decode_substeps - steps0 == steps,
                'a graph was captured or a step ran after the wedge')
        require(launches == cfg.n_layers * steps and steps > 0,
                f'{key} launches {launches} != {cfg.n_layers} x {steps}')
        healthy = srv.step_age_max_s
        wedge = {'deadline_s': FAULT_WATCHDOG_S, 'wedge_at': FAULT_WEDGE_AT,
                 'detect_s': detect_s,
                 'client_error_after_stamp_s': t_err - wedge_stamp,
                 'stream_tokens_before_error': n_tokens,
                 'stream_error': err, 'readiness': ready,
                 'new_submit': {'status': code2,
                                'retry_after': headers2.get('Retry-After')},
                 'gray_wedged_step': 1, 'graph_captures': captures,
                 'healthy_step_age_max_s': healthy,
                 'healthy_step_age_max_s_serve_phases':
                     _HEALTHY_STEP_MAX['s'],
                 'healthy_step_age_max_phase': _HEALTHY_STEP_MAX['phase'],
                 'decode_steps': steps, 'kernel_launches': {key: launches}}
    finally:
        srv.stop()
    del eng, srv
    _release(torch)

    srv = _fault_server(params, seed, nan_alarm_threshold=100,
                        fault_spec={'seed': seed, 'rules': [
                            {'kind': 'nan_logits', 'site': 'engine_step',
                             'at': FAULT_NAN_AT}]})
    try:
        eng = srv.engine
        steps0 = eng.decode_substeps
        pa.reset_launch_counts()
        import threading
        results = [None] * FAULT_STREAMS

        def run(i):
            results[i] = _sse_timed(srv.port, '/generate', {
                'prompt': prompts[i], 'stream': True,
                'max_new_tokens': N_NEW})
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(FAULT_STREAMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errors = [r[1][-1] for r in results if 'error' in r[1][-1]]
        done = [r[1][-1] for r in results if r[1][-1].get('done')]
        require(len(errors) == 1 and len(done) == FAULT_STREAMS - 1,
                f'{len(errors)} evicted and {len(done)} completed streams')
        require(errors[0].get('retryable') is True
                and 'non-finite' in str(errors[0].get('error')),
                f'eviction event {errors[0]}')
        require(all(len(d['tokens']) == N_NEW for d in done),
                'a surviving stream came back short')
        require(eng.nan_evictions == 1 and srv._degraded is None,
                f'{eng.nan_evictions} evictions, degraded {srv._degraded}')
        require(faults.gray_failure_counter('nan_logits').value == 1,
                'the nan_logits gray counter is not 1')
        code, _, body = _http(srv.port, '/readiness')
        require(code == 200, f'/readiness {code} after one eviction')
        code3, _, body3 = _http(srv.port, '/generate', {
            'prompt': prompts[5], 'max_new_tokens': 8})
        require(code3 == 200 and len(json.loads(body3)['tokens']) == 8,
                f'the replica stopped serving: {code3}')
        nan_launches = pa.launch_counts[key]
        nan_steps = eng.decode_substeps - steps0
        require(nan_launches == cfg.n_layers * nan_steps,
                f'{key} launches {nan_launches} != {cfg.n_layers} x '
                f'{nan_steps}')
        nan = {'at': FAULT_NAN_AT, 'streams': FAULT_STREAMS,
               'evicted': 1, 'completed': len(done),
               'eviction_event': errors[0], 'gray_nan_logits': 1,
               'readiness_after': json.loads(body)['status'],
               'decode_steps': nan_steps,
               'kernel_launches': {key: nan_launches},
               'step_age_max_s': srv.step_age_max_s}
    finally:
        srv.stop()
    del eng, srv
    _release(torch)
    alloc1 = torch.cuda.memory_allocated()
    memory = {'cuda_alloc_gb_before': alloc0 / 1e9,
              'cuda_alloc_gb_after': alloc1 / 1e9,
              'growth_bytes': alloc1 - alloc0}
    if alloc1 - alloc0 >= MEMORY_CREEP_BYTES:
        memory['snapshot_diff'] = _memory_diff(snap0,
                                               torch.cuda.memory_snapshot())
    torch.cuda.memory._record_memory_history(enabled=None)
    emit({'phase': 'fault_watchdog', 'card': card, 'model': cfg.name,
          'weights': 'bfloat16', 'kv_cache_dtype': 'bf16',
          'wedged_step': wedge, 'nan_logits': nan, 'memory': memory})
    return launches + nan_launches


def _kernel_entry(name, source, replaces, launches, worst, timing):
    return {'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{source}',
            'replaces': f'skypilot_tpu/ops/{replaces}',
            'launches': launches, 'max_abs_err': worst,
            **{k: timing[k] for k in _TIME_KEYS}}


def _times_by_shape(flash_times, kernel, labels):
    """A flash kernel's timings at several shapes, for its entry in
    the ``kernels`` line beside the main-path shape's."""
    return {label: {k: flash_times[(kernel, label)][k] for k in _TIME_KEYS}
            for label in labels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    try:
        import skypilot_tpu_torch  # noqa: F401
        from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
        from skypilot_tpu_torch.models import configs
    except ImportError as e:
        print(f'chip_smoke: the skypilot_tpu_torch package is missing '
              f'({e}); run from the root of the repository',
              file=sys.stderr)
        return 2
    # fp32 comparisons run in full fp32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    page = PagedInferenceEngine._auto_page_size(configs.LLAMA2_7B,
                                                max_seq=2048)
    try:
        dev = phase_device(torch)
        phase_build()
        worst = phase_kernel_checks(torch, page)
        worst.update(phase_flash_checks(torch))
        worst.update(phase_flash_bwd_checks(torch))
        phase_autograd_check(torch)
        times = phase_kernel_times(torch, page)
        flash_times = phase_flash_times(torch)
        flash_times.update(phase_flash_bwd_times(torch))
        phase_weight_path(torch)
        phase_w8a8_check(torch)
        k6_launches, k6_worst, k6_times = phase_kv_probe(torch, page)
        bf16_launches, bf16_params = phase_serve(torch, args.seed, 'serve',
                                                 keep_params=True)
        slot_rec = {}
        k4_launches, k3_launches = phase_serve_slot(torch, args.seed,
                                                    bf16_params,
                                                    record=slot_rec)
        phase_decode_graphs(torch, args.seed, bf16_params, 'bfloat16',
                            (('pallas', 'bf16'),), timed=True)
        phase_decode_graphs(torch, args.seed, bf16_params, 'bfloat16',
                            (('gather', 'bf16'),),
                            horizons=GRAPH_CUT_HORIZONS)
        phase_costmodel_check(torch, args.seed, bf16_params, 'bfloat16',
                              'bf16')
        pinned_launches, _ = phase_serve(torch, args.seed, 'serve_pinned',
                                         params=bf16_params,
                                         decode_steps_per_call=4)
        phase_serve_spec(torch, args.seed, bf16_params, 'serve_spec')
        phase_serve_spec(torch, args.seed, bf16_params, 'serve_spec_fused',
                         decode_steps_per_call=SPEC_ROUNDS)
        k3_verify_launches = phase_serve_spec(
            torch, args.seed, bf16_params, 'serve_slot_spec',
            kv_cache='slot')
        kv_launches = phase_kv_handoff(torch, args.seed, bf16_params)
        kv_k4, kv_k3 = phase_kv_handoff_slot(torch, args.seed, bf16_params)
        ckpt_k1 = phase_kv_checkpoint(torch, args.seed, bf16_params)
        sched_k1 = phase_serve_sched(torch, args.seed, bf16_params,
                                     scale=2)[
            'paged_decode_attention[bf16]']
        sched_slot = phase_serve_sched(torch, args.seed, bf16_params,
                                       kv_cache='slot',
                                       phase='serve_sched_slot', scale=4,
                                       cut=True)
        shed_k1 = phase_sched_shed(torch, args.seed, bf16_params)
        drain_k1 = phase_sched_drain(torch, args.seed, bf16_params)
        relay_k1 = phase_disagg_relay(torch, args.seed, bf16_params)
        phase_telemetry_audit(torch, args.seed, bf16_params)
        with tempfile.TemporaryDirectory() as adapter_dir:
            _write_adapters(configs.LLAMA2_7B, args.seed, adapter_dir)
            lora_k1 = phase_serve_lora(
                torch, args.seed, bf16_params, adapter_dir)[
                    'paged_decode_attention[bf16]']
            # Its bankless baseline is cut for time: serve_slot
            # and serve_sched_slot hold the slot engine without a bank.
            lora_slot = phase_serve_lora(torch, args.seed, bf16_params,
                                         adapter_dir, kv_cache='slot',
                                         baseline=False)
        phase_lora_check(torch, args.seed, bf16_params)
        phase_grammar_check(torch, args.seed, bf16_params)
        fault_k1 = phase_fault_watchdog(torch, args.seed, bf16_params)
        mesh1_k1 = phase_serve_mesh1(torch, args.seed, bf16_params)
        mesh_opts = phase_serve_mesh1_opts(torch, args.seed, 'bank',
                                           bf16_params)
        mesh_opts.update(phase_serve_mesh1_opts(torch, args.seed,
                                                'spec_slot', bf16_params))
        del bf16_params
        _release(torch)
        gang_k1 = phase_serve_gang(torch, args.seed)
        phase_decode_audits(torch)
        phase_audit_presets(torch)
        worst['flash_fwd_chunk'] = max(worst['flash_fwd_chunk'],
                                       phase_spec_check(torch, args.seed))
        phase_spec_audit(torch)
        phase_kv_audit(torch)
        phase_lora_check_fp32(torch, args.seed)
        phase_lora_audit(torch)
        int8_rec, int8_tokens = {}, []
        int8_launches, int8_params = phase_serve(
            torch, args.seed, 'serve_int8', keep_params=True,
            quantize='int8', record=int8_rec, tokens=int8_tokens)
        variants = phase_decode_variants(torch, args.seed, int8_params)
        phase_decode_graphs(torch, args.seed, int8_params, 'int8',
                            (('pallas', 'int8'), ('pallas', 'int4'),
                             ('cross_layer', 'int8')),
                            horizons=GRAPH_CUT_HORIZONS)
        phase_costmodel_check(torch, args.seed, int8_params, 'int8', 'int8')
        w8a8_k1 = phase_serve_w8a8(torch, args.seed, int8_params, int8_rec,
                                   int8_tokens)
        w8a8_k4, w8a8_k3 = phase_serve_slot(
            torch, args.seed, int8_params, phase='w8a8_slot',
            weights='int8', prefill_w8a8=True, kv_cache_dtype='bf16',
            extra={'prefill_w8a8': True, 'card': _card_label(),
                   'serve_slot': _beside(slot_rec)})
        mesh_int8_k1 = phase_serve_mesh1_opts(
            torch, args.seed, 'w8a8', int8_params)[
                'paged_decode_attention[int8]']
        del int8_params
        _release(torch)
        phase_reference(torch, args.seed)
        train_k4, k5a_launches, k5b_launches = phase_train(
            torch, args.seed, flash_times)
        phase_train_reference(torch, args.seed)
        mesh1_k4, mesh1_k5a, mesh1_k5b = phase_train_mesh1(torch,
                                                           args.seed)
        sp_k4, sp_k5a, sp_k5b = phase_seq_parallel(torch, args.seed)
        phase_checkpoints(torch, args.seed)
        phase_moe_int4_check(torch, args.seed)
        moe_cfg, moe_cut = _big_serve_cfg('mixtral-8x7b')
        moe_launches, moe_params = phase_serve(
            torch, args.seed, 'serve_moe', model=moe_cfg,
            quantize='int8', decode_impl='pallas', keep_params=True,
            extra={'weights_built_on_card_from_seed': True,
                   'reduced': moe_cut})
        mesh_int8_k1 += phase_serve_mesh1_opts(
            torch, args.seed, 'moe', moe_params, cfg=moe_cfg,
            reduced=moe_cut)['paged_decode_attention[int8]']
        del moe_params
        _release(torch)
        int4_cfg, int4_cut = _big_serve_cfg('llama3-70b')
        int4_launches, _ = phase_serve(
            torch, args.seed, 'serve_int4', model=int4_cfg,
            quantize='int4', decode_impl='pallas',
            extra={'weights_built_on_card_from_seed': True,
                   'int4_group': 0, 'reduced': int4_cut})
        moe_k4, moe_k5a, moe_k5b = phase_train_moe(torch, args.seed)
        lora_train, lora_params, lora_batch = phase_lora_train(torch,
                                                               args.seed)
        lora_remat = phase_lora_remat(torch, args.seed, lora_params,
                                      lora_batch)
        lora_serve_k1 = phase_lora_serve(torch, args.seed, lora_params)
        del lora_params, lora_batch
        _release(torch)
        phase_lora_cli(torch, args.seed)
        emit({'kernels': [
            dict(_kernel_entry('paged_decode', 'paged_decode.cu',
                               'paged_attention.py:131',
                               bf16_launches + pinned_launches
                               + kv_launches['paged_decode_attention[bf16]']
                               + ckpt_k1 + sched_k1 + shed_k1 + drain_k1
                               + relay_k1 + lora_k1 + lora_serve_k1
                               + fault_k1 + mesh1_k1
                               + mesh_opts['paged_decode_attention[bf16]']
                               + gang_k1,
                               worst['paged_decode'], times['paged_decode']),
                 launches_by_path={
                     'serve': bf16_launches,
                     'serve_pinned': pinned_launches,
                     'kv_handoff':
                         kv_launches['paged_decode_attention[bf16]'],
                     'kv_checkpoint': ckpt_k1,
                     'serve_sched': sched_k1,
                     'sched_shed': shed_k1,
                     'sched_drain': drain_k1,
                     'disagg_relay': relay_k1,
                     'serve_lora': lora_k1,
                     'lora_serve': lora_serve_k1,
                     'fault_watchdog': fault_k1,
                     'serve_mesh1': mesh1_k1,
                     'serve_mesh1_opts':
                         mesh_opts['paged_decode_attention[bf16]'],
                     'serve_gang': gang_k1}),
            dict(_kernel_entry('paged_decode_int8', 'paged_decode.cu',
                               'paged_attention.py:103',
                               int8_launches + moe_launches
                               + kv_launches['paged_decode_attention[int8]']
                               + w8a8_k1 + mesh_int8_k1,
                               worst['paged_decode_int8'],
                               times['paged_decode_int8']),
                 launches_by_path={
                     'serve_int8': int8_launches,
                     'serve_moe': moe_launches,
                     'kv_handoff':
                         kv_launches['paged_decode_attention[int8]'],
                     'serve_w8a8': w8a8_k1,
                     'serve_mesh1_opts': mesh_int8_k1}),
            dict(_kernel_entry('paged_decode_int4', 'paged_decode.cu',
                               'paged_attention.py:65',
                               variants['paged_decode_attention[int4]']
                               + int4_launches
                               + kv_launches['paged_decode_attention[int4]'],
                               worst['paged_decode_int4'],
                               times['paged_decode_int4']),
                 launches_by_path={
                     'decode_variants':
                         variants['paged_decode_attention[int4]'],
                     'serve_int4': int4_launches,
                     'kv_handoff':
                         kv_launches['paged_decode_attention[int4]']}),
            dict(_kernel_entry('paged_decode_all_layers', 'paged_decode.cu',
                               'paged_attention.py:193', k6_launches,
                               k6_worst, k6_times['paged_decode_all_layers']),
                 launches_by_path={'kv_probe': k6_launches}),
            dict(_kernel_entry(
                'paged_decode_fused', 'paged_decode_fused.cu',
                'paged_attention.py:246',
                variants['paged_decode_attention_fused[int8]']
                + kv_launches['paged_decode_attention_fused[int8]'],
                worst['paged_decode_fused'],
                times['paged_decode_fused[int8]']),
                launches_by_path={
                    'decode_variants':
                        variants['paged_decode_attention_fused[int8]'],
                    'kv_handoff':
                        kv_launches['paged_decode_attention_fused[int8]']}),
            dict(_kernel_entry('flash_fwd_chunk', 'flash_fwd.cu',
                               'flash_attention.py:159',
                               k3_launches + k3_verify_launches + kv_k3
                               + sched_slot['flash_fwd_chunk']
                               + lora_slot['flash_fwd_chunk'] + w8a8_k3
                               + mesh_opts['flash_fwd_chunk'],
                               worst['flash_fwd_chunk'],
                               flash_times[('flash_fwd_chunk', 'served')]),
                 launches_by_path={'serve_slot': k3_launches,
                                   'serve_slot_spec': k3_verify_launches,
                                   'kv_handoff_slot': kv_k3,
                                   'serve_sched_slot':
                                       sched_slot['flash_fwd_chunk'],
                                   'serve_lora_slot':
                                       lora_slot['flash_fwd_chunk'],
                                   'w8a8_slot': w8a8_k3,
                                   'serve_mesh1_opts':
                                       mesh_opts['flash_fwd_chunk']},
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_fwd_chunk',
                     ('served', 'long', 'verify'))),
            dict(_kernel_entry('flash_fwd', 'flash_fwd.cu',
                               'flash_attention.py:44',
                               k4_launches + train_k4 + moe_k4 + kv_k4
                               + sched_slot['flash_fwd']
                               + lora_slot['flash_fwd']
                               + lora_train[0] + lora_remat[0] + w8a8_k4
                               + mesh_opts['flash_fwd'] + mesh1_k4 + sp_k4,
                               worst['flash_fwd'],
                               flash_times[('flash_fwd', 'served')]),
                 launches_by_path={'serve_slot': k4_launches,
                                   'train': train_k4,
                                   'train_moe': moe_k4,
                                   'kv_handoff_slot': kv_k4,
                                   'serve_sched_slot':
                                       sched_slot['flash_fwd'],
                                   'serve_lora_slot':
                                       lora_slot['flash_fwd'],
                                   'lora_train': lora_train[0],
                                   'lora_remat': lora_remat[0],
                                   'w8a8_slot': w8a8_k4,
                                   'serve_mesh1_opts':
                                       mesh_opts['flash_fwd'],
                                   'train_mesh1': mesh1_k4,
                                   'seq_parallel': sp_k4},
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_fwd',
                     ('served', 'long', 'train', '7b', '8b_train'))),
            dict(_kernel_entry('flash_bwd_dkv', 'flash_bwd.cu',
                               'flash_attention.py:284',
                               k5a_launches + moe_k5a + lora_train[1]
                               + lora_remat[1] + mesh1_k5a + sp_k5a,
                               worst['flash_bwd_dkv'],
                               flash_times[('flash_bwd_dkv', 'train')]),
                 launches_by_path={'train': k5a_launches,
                                   'train_moe': moe_k5a,
                                   'lora_train': lora_train[1],
                                   'lora_remat': lora_remat[1],
                                   'train_mesh1': mesh1_k5a,
                                   'seq_parallel': sp_k5a},
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_bwd_dkv',
                     ('train', '7b', '8b_train'))),
            dict(_kernel_entry('flash_bwd_dq', 'flash_bwd.cu',
                               'flash_attention.py:341',
                               k5b_launches + moe_k5b + lora_train[2]
                               + lora_remat[2] + mesh1_k5b + sp_k5b,
                               worst['flash_bwd_dq'],
                               flash_times[('flash_bwd_dq', 'train')]),
                 launches_by_path={'train': k5b_launches,
                                   'train_moe': moe_k5b,
                                   'lora_train': lora_train[2],
                                   'lora_remat': lora_remat[2],
                                   'train_mesh1': mesh1_k5b,
                                   'seq_parallel': sp_k5b},
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_bwd_dq',
                     ('train', '7b', '8b_train')))]})
    except Exception as e:  # pylint: disable=broad-except
        import traceback
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {type(e).__name__}: {e}',
              file=sys.stderr)
        return 1
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': dev['name'],
                                 'count': dev['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
