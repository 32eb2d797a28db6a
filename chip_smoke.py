#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pygpukit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                    # every phase, as automation runs it
    python3 chip_smoke.py --phases ladder    # one or more phases alone

Phases:
 1. the card's name and power limit; torch, CUDA and nvcc versions;
 2. build the kernels from pygpukit_tpu_torch/csrc with nvcc (sm_90a), one
    nvcc per source, all started together;
 3. each kernel against its plain PyTorch version at the 1.1B slice's
    shapes (w4a8 GEMV at rows 1, 2, 5 and 8 on the four projection shapes
    and at a ragged N 1001, launched after its activation quantization and
    as its programmatic dependent, each bitwise and timed, graph replays at
    rows 1 and 8; GEMM at
    M = 32, 256, 300 and 2048 there, at a ragged N and at the reference's
    int4 GEMM cell M 8192, K 4096, N 14336 beside torch._int_mm of its int8
    operands, a graph replay and a second launch bitwise; the row write and
    the attention at batch 8, MAX 1024, and the two as the batch-rows step
    runs them (kv_write_attention: the rows written by the attention's own
    pass one; its pools bitwise kv_rows_write_plain's and its output
    bitwise the two kernels', on every storage; timed over 22 layers in
    PAIR_TURNS alternating turns beside the two kernels launched one after
    the other and the attention alone, each with its median and spread;
    the summary line's kv_rows_write_fused is the time the write adds to
    the attention),
    paged attention at batch 8, block 16, MAX 512 and 1024 over shuffled
    blocks with two dead slots on the trash table), bitwise where the math
    is integer or a copy; then kernel and plain times (CUDA events, warmed
    up, weights or layers cycled through more than the 50 MB L2); the four
    ladder GEMVs (w4a16, block w4a8, block w4a16, converting fp8) at the
    four projection shapes, rows 1 and 8: block w4a8 bitwise, the others
    within one bf16 ulp plus 1e-4 of max |y|, with GB/s of weight bytes;
    the w4a16 and block w4a16 GEMVs' C plans against their Python mirrors
    and their graph replays, the w4a16 GEMV's four projections at rows 1
    and 8 with bound, share and plain time;
    the converting GEMV on all four storages (e4m3, e5m2, int8, bf16) at
    rows 1 and 8, e4m3 and int8 timed with bound and share, its plan of at
    least 132 blocks, graph replays and second launches bitwise, a ragged
    N 2060 and a K 2052 off every split at rows 1, 5 and 8;
    block w4a8 also at rows 2 and 5, with its activation quantization fused
    and as a separate launch (both timed), at K 2080 (a block straddling
    K/2) and a ragged and a narrow N, a graph replay and a second launch;
    fused_decode (the whole-model decode step) at full width against its
    plain version at 2 and 22 layers, pos 1, 143 and 511 in cache 512 and
    pos 3000 in cache 4096 (relative L2 of h_out, k_new and v_new within
    1e-2 at 2 layers and FUSED_DEEP_TOL at 22, a bitwise second launch),
    timed at 22 layers, cache 512, pos 143 beside the unfused step and the
    head;
 4. the dense path: the TinyLlama-1.1B shape with random int4 weights and
    an int8 head, served by the batch-8 ContinuousBatchingEngine
    (max_seq_len 1024, 16 steps per dispatch) for 16 requests; every request
    must finish with its token count, every logit stay finite and every
    dense-path kernel's launch counter move (the row write's as the
    attention's fused write; kv_rows_write's own kernel never runs there);
 5. the same requests served again by the engine from a zeroed state, its
    programs replayed: identical token streams and bitwise-identical KV
    pools; single-stream generate against the engine's
    streams (reported); a two-layer full-width model on the card against the
    plain path on the CPU (relative L2 of the logits);
 6. one batch-8 decode step timed eagerly and as a CUDA-graph replay: the
    device's share of the eager step;
 7. the paged path, the reference's serving_1b_int4_paged row
    (bench.py:256-293) at full width and depth: pipelined, paged (block 16),
    max_seq_len 512, 128 steps per dispatch; warmup(), 8 warm-up requests,
    then 32 timed requests of a 16-token prompt (random, one per request,
    where the reference repeats one prompt) and 128 new tokens: tok/s and
    TTFT p50/p95. Every request finishes with its count and finite logits;
    paged_attention launches and the dense attention and row write do not;
    the engine served again from a zeroed state (warm-up requests and a
    fresh block allocator included) replays the streams and the pools
    outside block 0 (the trash block, whose duplicate writes are unordered) bit for bit; the
    non-pipelined paged engine gives the same streams; the dense pipelined
    engine's streams for the first 8 requests are reported; one paged decode step timed eagerly, as
    a CUDA-graph replay and under torch.profiler (kernels by device time);
    the two cross-checks run CROSS_STEPS steps a dispatch.
    Its 16-token prompts pad to 32 rows, which the int4 route sends to the
    dequant matmul (9 to 255 rows), so the w4a8 GEMM is the dense path's
    (its 200-token prompts pad to 256);
 8. a tight pool: 16 requests with 16- and 200-token prompts and 48-64 new
    tokens over a pool that holds at most 4 of them at once; admission
    waits instead of failing, every request finishes, and every block but
    the trash block is free at the end;
 9. the decode ladder, the reference's bench_decode (bench.py:172-253) at
    full width and depth: bf16, fp8, int8 (w8a8), int4, int4 under
    PYGPUKIT_INT4_MODE=w4a16, int4_block and int4_block under
    PYGPUKIT_INT4_BLOCK=w4a16, each a warm generate and a timed one of
    128 tokens after a 16-token prompt (cache 512, chunks of
    GEN_CHUNK, each a captured program the warm run captures): the
    timed run starts with the warm run's tokens, finite logits, 88
    launches per decode step of the rung's GEMV and none of any other;
    tok/s, one single-stream step's (decode_step_fn over [L, MAX, Hk, D]
    caches) eager wall ms and graph device ms, bytes streamed per step and
    GB/s; the fp8, bf16, int4 and int4_block steps' device ms on one line;
10. phase 4's workload on the int4_block model, replayed bitwise, against
    single-stream generate (reported), and its 2-layer model on the card
    against the CPU plain path;
11. the uncached forward on the 1.1B bf16 model (random weights, seed 0):
    get_logits on 2048 tokens (shape, finite, 22 flash_attention launches
    and no other attention kernel, a bitwise second call), tokens/s and
    device ms of one forward with its share of 989 TFLOP/s and a kernel
    profile; its last row against cached prefill (relative L2, reported);
    uncached greedy generation of 8 tokens after a 16-token prompt
    (replayed, launches checked, compared with cached generate: reported);
    a 2-layer full-width bf16 model's forward on the card against the CPU
    plain forward (relative L2 within FWD_TOL);
12. the Array API (``import pygpukit_tpu_torch as gp``) at full width:
    layer 0 of the 1.1B bf16 model (random weights, seed 0) written with
    Array ops (rmsnorm, matmul per projection under PYGPUKIT_GEMM=pallas,
    rope_inplace, flash_attention, add, swiglu) on 2048 seeded hidden rows,
    against the model's own layer (layer_stack_fn; relative L2 within
    FWD_TOL), one gemm launch per projection, a bitwise second call; the
    reference's GEMM cells through the API (bench.py:73-139): bf16 8192^3
    with the switch (the gemm kernel) and without (cuBLAS), checked against
    each other, fp8 (quantize_fp8 + matmul_fp8) and int8 (matmul_int8) at
    M 8192, K 4096, N 14336 (plain routes), TFLOP/s and TOP/s; gemv_quant
    through its library entry at the four projection shapes; kv_rows_write
    through its library entry on every layer of batch-8 pools at the 1.1B
    width, bitwise its plain version;
13. the single-stream fixed-cache decode on the 1.1B bf16 model with
    separate q/k/v and gate/up leaves (random weights, seed 0, no
    fuse_params), cache 512, the ladder's 16-token prompt: a warm and a
    timed generate of 128 tokens on the unfused step (flash_decode, 22
    launches a step, no serving kernel or GEMV) and under
    PYGPUKIT_DECODE=fused (one fused_decode launch a step, no
    flash_decode), identical tokens within each route, finite logits; one
    step's fused logits against the unfused step's at the same cache
    (relative L2 within FWD_TOL; token agreement reported); a snapshot
    after 100 tokens, 50 more, a restore and the same 50 again, identical;
    eager wall and graph device ms of both steps;
14. the MoE path on Mixtral-8x7B widths (hidden 4096, intermediate 14336,
    8 experts, top-2, 32/8 heads, head_dim 128, vocab 32000, rope theta
    1e6) at 8 of its 32 layers (about 24 GB of random bf16 weights, seed
    0, fuse_params): get_logits on 2048 tokens (shape, finite, 24 gmm and
    8 flash_attention launches, a bitwise second call, device ms, tok/s,
    a kernel profile); generate of 64 greedy tokens after a 512-token
    prompt, twice (identical tokens, finite logits, 24 gmm launches in the
    prefill and none in decode, 8 flash_decode a step), one decode step's
    eager and graph ms beside the gather route's device ms; the batch-8
    engine on 8 requests of 200 + 32 tokens (every request finishes, gmm
    in the prefills, 8 batch_decode_attention (the row write fused in) a
    decode step on the dense MoE route, the engine served again from a
    zeroed state replays streams and pools bitwise); a 2-layer full-width model drawn on the CPU, on the
    card (gmm) against the CPU plain path (dense route), held row by row
    (MOE_ROWS_Q);
15. the reference's bench_serving_kv (bench.py:390-428) at full width and
    depth: the 1.1B shape with int8 (w8a8) weights, the batch-8 pipelined
    engine at MAX 4096, 32 steps a dispatch, 8 warm-up requests, then 16
    timed requests of one 16-token prompt and 128 new tokens, on bf16,
    int8 and fp8 KV: every request finishes with finite logits, 22
    batch_decode_attention launches a step, each writing its rows, the int8
    run replayed bitwise (streams and pools) by the engine served again
    from a zeroed state; tok/s,
    TTFT, one step's eager and graph device ms, greedy tokens equal to the
    bf16 run's.

Phase 3 also checks the row write (bitwise) and the split-KV attention
kernels (within ATTN_TOL, F32_REL under f32 queries; a second launch
bitwise; the masks of BDA_MASKS) on f32, fp8 e4m3, fp8 e5m2 and int8 KV,
each timed, and gemm (bf16 at M 2048 on the four projection products
as [K, N] weights, each with its launch plan: tile width, grid, waves;
bf16 at 8192^3 in TFLOP/s beside cuBLAS; f32 at 2048^3) and gemv_quant (the four
projection shapes N-major, fp8 e4m3, int8 and bf16) against their plain
versions, and flash_attention (causal bf16 at S 1000, 2048 and 8192,
once full, at D 128 and S 1, 63, 129, 2048 and 8192, f32 at S 1000) and
flash_decode (DECODE_CASES: the 1.1B heads at MAX 8192, ctx 1, 700 and
8192, and ctx 144 and 512 in MAX 512, the decode phase's shape, bf16 and
f32; Mixtral's heads at phase 14's step; each beside SDPA, with its bound
and share; one launch captured in a CUDA graph with ctx_len on the card,
replayed at DECODE_GRAPH_CTX against the eager call, bitwise) against
their plain versions, gemv_quant's fp8, int8 and bf16 totals over the four
shapes (ms, GB/s, share, torch.mv for bf16) and at GEMV_UNALIGNED beside
the aligned gate_up, and gmm (GMM_CASES: Mixtral's expert
products at M 1024 and 4096 from a seeded top-2 routing, an empty group, a
one-row group, all rows in one group, M off the 128-row tile,
Qwen3-30B-A3B's 128 small experts, and on the CUDA-core route an f32
Mixtral layer's gate/up and down at M 256 and K, N 1001, 1003 on bf16 and
f32) against gmm_plain within GMM_REL of max |out|, a second launch
bitwise (torch._grouped_mm, which takes no f32 operands, is then "—"). For every kernel
it prints the least time the card could take for the same work (bound_ms:
the larger of the bytes each input and output moves once over the card's
HBM rate and the operations over the peak of their type, both from the
port's table core.device.CARD_PEAKS: on the H100 SXM 3.35 TB/s, 989
TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s f32) with the kernel's share of it, and, where one
PyTorch call computes the same function, that call's time (library_ms; the
port never calls it: torch.matmul for gemm, torch.mv for gemv_quant on a
bf16 weight with no scale, torch._grouped_mm for gmm, bf16 out).
16. the decode strategies and capture/replay on phase 13's model (cache
    512, the 16-token prompt): the greedy step captured once
    (core.capture through CausalTransformerModel._ensure_decode_exe, the
    position a device tensor), unfused and under PYGPUKIT_DECODE=fused,
    replayed at positions 17, 100, 300 and 511, each replay bitwise the
    eager step from the same cache state (logits and both caches), twice;
    the capture leaves the caches and counters as they were; another cache
    raises; node_count, cost_analysis (22 flash_decode, 1 fused_decode)
    and the pool's bytes printed; DecodeM1 and DecodeM1Graph for 128
    tokens (both replay the step now), identical, finite, replayed wall ms
    a token, and eager (decode_step_fn) against replayed wall ms a step
    (128 steps back-to-back); each strategy runs warm (capturing its
    programs), then timed; DecodeBatch over 8 prompts (slots 0 and
    5 one prompt: identical tokens; 22 batch_decode_attention and 22
    kv_rows_write_fused launches a step), DecodeJacobi (window 6),
    DecodeSpeculative self (2 draft layers, gamma 4) and with a 2-layer
    draft model made by slice_layers: tok/s, stats, agreement with
    DecodeM1 and launches; each strategy's tokens then fed to DecodeM1's
    program (teacher forcing, forced_m1): every token must be DecodeM1's
    argmax at each step whose top-2 gap exceeds STRAT_TIE of its largest
    |logit|, and the KV rows the strategy wrote must be DecodeM1's within
    STRAT_KV_TOL (relative L2, each layer), a check that rests on the
    context, so on attention and the KV pools; the top-2 gap where each
    strategy parts from DecodeM1's own run printed; then a peaked model
    (peaked_agreement) on which DecodeBatch's slot 0, Jacobi and both
    speculations must give DecodeM1's 128 tokens;
17. the captured programs (graphs_phase, ``--phases graphs``) on the 1.1B
    int4 model: the dense pipelined engine over phase 4's requests, the
    paged pipelined engine over phase 7's (block 16, MAX 512, 32 steps a
    dispatch), the non-pipelined dense engine, each warmed up (every
    program captured) and run twice, the second time replaying the same
    programs from a zeroed state: identical streams and pools (paged:
    outside block 0); every executable of each engine, of the model
    (prefill, decode_step, decode_window T 6, decode_chunk_device of 16
    steps greedy and at temperature 0.8, top-k 40), of DecodeBatch (8
    prompts) and of speculation with a separate 2-layer draft replayed
    against one eager call of its function on clones of its donated state
    at two random inputs: outputs and state bitwise; per executable its
    graph nodes, pool bytes, capture seconds, eager and replayed wall ms;
    tok/s, TTFT and the chunk's launches a step;
18. checkpoint loading and the chat path (load_phase, ``--phases load``):
    the 1.1B bf16 model from init_params (seed 0) written as a Hugging Face
    Llama checkpoint (HF names, [out, in] projections unfused, config.json
    with model_type llama, a byte-level BPE tokenizer.json with the ChatML
    specials, made by write_tokenizer) into build/, once as one
    model.safetensors and once as two shards with an index; each loaded
    by load_model_from_safetensors (pinned, double-buffered host-to-device
    copies; the single file once more with pageable copies), every leaf
    bitwise the source model's fused leaf, the load's wall seconds and
    GB/s (the file is in the page cache: no disk read) beside a pinned
    1 GiB host-to-device copy's rate; the loaded and the source model's
    2048-token forward logits bitwise (22 flash_attention launches each),
    64 greedy tokens identical (flash_decode); both quantized to int4
    through the params setter after those captures, a short generate
    identical, then 8 ChatML requests encoded by the port's Tokenizer (one
    of 256 tokens or more: w4a8_gemm on its prefill), 32 new tokens each,
    served by the batch-8 engine on each model: identical streams, each
    decoded to text; rows 1, 4, 6, 14 and 15 must show launches;
19. the model families (families_phase, ``--phases families``) with
    random weights (seed 0) at their published widths (FAMILIES: the
    config.json values of Qwen/Qwen2.5-0.5B at 6 of its 24 layers,
    Qwen/Qwen3-0.6B at 7 of 28, openai-community/gpt2 at full depth,
    google/gemma-2-2b at 4 of 26, google/gemma-3-1b-pt at 6 of 26,
    Qwen/Qwen3-30B-A3B at 4 of 48), the leaves
    init_params keeps constant drawn (norm weights, biases, Qwen2's and
    GPT-2's attention biases): per family a bf16 forward of 2048 tokens
    (GPT-2 1024) with one flash_attention launch a layer the route takes
    (none on Gemma-2, whose softcap takes the plain route; Gemma-3's four
    global layers), a bitwise second forward; a 64-token generate warm
    then replayed (identical tokens, flash_decode on the same layers);
    Gemma-3-1B and GPT-2 written as Hugging Face checkpoints by
    save_safetensors and loaded back (config and leaves bitwise, logits
    bitwise); the first 2 layers (Gemma-3 6) on the card against the CPU
    plain path (bf16 forward, prefill and decode steps within FWD_TOL,
    int4 within REF_TOL; MoE the forward's rows, MOE_ROWS_Q); the int4
    dense engine and the paged pipelined engine on 16 requests (Gemma-3:
    4 prompts of 600-700 tokens, past its 512 window; Gemma-2: MAX 8192
    and 2 prompts of about 4200 tokens, past its 4096 window) through
    phase 17's graphs_engine (streams and pools twice, every program's
    replay bitwise one eager call); the batch-8 step's device ms and the
    head's share of it. Then the D-256 rows (attention_rows) against their
    plain versions, timed beside SDPA with their bounds;
20. the rope variants (rope_phase, ``--phases rope``): phase 19's run per
    config of ROPE_FAMILIES, the config.json values of
    meta-llama/Llama-3.2-1B (llama3 tables; 4 of its 16 layers),
    google/gemma-3-4b-pt's text config (linear 8 on the global layers; 6
    of 34), microsoft/Phi-3.5-mini-instruct (longrope with stand-in factor
    lists, D 96; 4 of 32), THUDM/GLM-4-9B-0414 (interleaved partial
    rotary, sandwich norms, qkv biases; 4 of 40),
    baidu/ERNIE-4.5-0.3B-PT (interleaved pairs; 9 of 18),
    HuggingFaceTB/SmolLM3-3B (NoPE every fourth layer; 4 of 36) and
    Qwen3-0.6B with yarn (7 of 28); beyond it: Phi-3.5's engines at MAX 8192 with 2 prompts of
    4150-4250 tokens among short ones (rows on both sides of its 4096
    threshold in one batch; dense and paged streams identical) and its CPU
    slice past a scaled-down threshold, Llama-3.2-1B's generate under
    PYGPUKIT_DECODE=fused (row 18 on llama3 tables) against the unfused
    step (FUSED_DEEP_TOL), Llama-3.2-1B and Phi-3.5-mini written as Hugging
    Face checkpoints and loaded back (Phi-3's fused qkv_proj and
    gate_up_proj split at load), Gemma-3-4B's 4 prompts of 1100-1300
    tokens past its 1024 window; PoPE and ALiBi through the Array API on
    the card against the CPU; then the D-96 rows (attention_rows) at
    Phi-3.5's heads, each of which must have launched on its path;
21. the block, norm, activation and head conventions (conventions_phase,
    ``--phases conventions``): phase 19's run per config of CONV_FAMILIES,
    the config.json values of allenai/OLMo-2-0425-1B (post-norm-only
    blocks, whole-width q/k norms; 4 of its 16 layers),
    CohereForAI/aya-23-8B (parallel blocks off one LayerNorm, interleaved
    rope, tied head times logit_scale; 4 of 32),
    ibm-granite/granite-3.1-2b-instruct (embedding, attention and residual
    multipliers, logits_scaling; 4 of 40), nvidia/Nemotron-Mini-4B-Instruct
    (LayerNorm1P, relu2, partial rotary 0.5; 4 of 32),
    swiss-ai/Apertus-8B-2509 (xIELU, per-head q/k norms, llama3 tables; 4
    of 32) and microsoft/phi-2 (a parallel block off one biased LayerNorm,
    biased projections and lm head, partial rotary 0.4, D 80; 4 of 32),
    with the values recalled, not read from the files; beyond it: Phi-2's
    engines at MAX 2048 with 2 prompts of 1500-1900 tokens among short ones
    (dense and paged streams identical), Phi-2 and OLMo-2 written as
    Hugging Face checkpoints and loaded back (Phi-2's lm-head bias among
    the leaves); then the D-80 rows (attention_rows) at Phi-2's heads
    against their plain versions, timed beside SDPA with their bounds,
    each of which must have launched on Phi-2's path;
22. the standalone families (standalone_phase, ``--phases standalone``):
    first the attention shapes no kernel is built for (UNBUILT: D 32, D
    112, G 24), the route each takes printed and a 2-layer f32 model of
    each served on the card (forward, generate, the dense and paged
    engines' streams the generate's, no kernel launched for an unbuilt
    shape); then, one at a time with the card freed between them, random
    bf16 weights (seed 0) at the config.json values of STANDALONE
    (recalled, not read from the files): deepseek-ai/DeepSeek-V2-Lite at 9
    of 27 layers (MLA without q-lora, 64 experts top-6, greedy router; 31.5
    GB at 27), deepseek-ai/DeepSeek-V3 at 2 of 61 layers (one
    dense, one MoE: first_k_dense_replace cut from 3 to 1; 256 experts
    top-8, noaux_tc; about 28 GB) and openai/gpt-oss-20b at 8 of 24 layers
    (sinks, window 128 on alternate layers, 32 experts top-4, bf16
    experts; 41.9 GB at 24): per model a 2048-token forward (gmm
    launched by every MoE layer and nothing else, a bitwise second
    forward, device ms by graph replay, tok/s), gmm at the model's expert
    shape against gmm_plain and timed with its bound and
    torch._grouped_mm, a greedy generate replayed identical (32 tokens
    after a 512-token prompt; V3 32 after 64); V2-Lite and gpt-oss: the
    hybrid engine (4 slots, MAX 1024, 8 requests of 16 new tokens after a
    warm-up request a prompt bucket that captures its programs), each
    stream its prompt's generate on the card, tok/s and TTFT, and a 2-layer
    slice against the CPU plain path (MOE_ROWS_Q); V3: its MoE layer's gmm
    route against the gather formula on 16 rows (SA_GATHER_TOL);
23. Llama-4 and the families with one per-layer cache tree (trees_phase,
    ``--phases trees``): one at a time with the card freed between them,
    random bf16 weights (seed 0) at the config.json values of
    TREE_FAMILIES (recalled, not read from the files):
    meta-llama/Llama-Guard-4-12B's text model at 16 of 48 layers (NoPE
    every fourth, 40/8 heads, D 128; 20.3 GB at 48),
    state-spaces/mamba-2.8b-hf at 16 of 64 layers (5.5 GB at 64),
    tiiuae/falcon-mamba-7b's widths at 8 of 64 layers and
    LiquidAI/LFM2-1.2B at full depth (16 layers, attention at six): per
    model a 2048-token forward (no kernel launched: the attention and the
    scan are plain, as the reference's; a bitwise second forward, device
    ms by graph replay, tok/s) and a greedy generate run twice to the same
    tokens (Llama-4: 16 tokens after 32, a forward a token, no cache; the
    others 32 after 512 at MAX 1024, LFM2 launching flash_decode once an
    attention layer a step); Mamba: a 1024-token prefill in blocks of 512
    against one shot (the last logits' argmax, 16 greedy tokens equal; on
    an f32 copy of the weights the last logits within TR_BLOCKED_F32_TOL);
    Mamba and LFM2: the hybrid engine on phase 22's workload, each stream
    its prompt's generate on the card; all but FalconMamba: a 2-layer
    slice against the CPU plain path (FWD_TOL, the largest row); then row
    15 at LFM2-1.2B's attention against its plain version, timed beside
    SDPA with its bound;
24. Qwen3-Next (qwen3next_phase, ``--phases qwen3next``): random bf16
    weights (seed 0) at the config.json values of
    Qwen/Qwen3-Next-80B-A3B-Instruct (QWEN3NEXT, recalled, not read from
    the file; hidden 2048, 16/2 heads of 256 with a quarter rotated,
    DeltaNet 16 K / 32 V heads of 128, 512 experts top-10 of width 512 and
    a shared expert, vocab 151936, untied head) at 8 of 48 layers (full
    attention at layers 3 and 7; 27.75 GB of weights and tables): a
    2048-token forward (gmm three times a MoE layer and nothing else, a
    bitwise second forward, device ms by graph replay, tok/s, a kernel
    profile), gmm at the expert shape (512 groups at M 20480) against
    gmm_plain, timed with its bound and torch._grouped_mm, a greedy
    generate of 32 tokens after a 512-token prompt at MAX 1024 run twice
    to the same tokens (flash_decode once an attention layer a step; the
    prefill's experts on gmm), one decode step's kernel profile, the
    hybrid engine on phase 22's workload with each stream its prompt's
    generate, the chunked delta rule against the recurrent one at a
    layer's widths (Q3N_DELTA, the reference test's tolerance, padded rows
    identity steps), a 2-layer slice (a DeltaNet and an attention layer)
    against the CPU plain path at the card's routing (the largest row
    within FWD_TOL; the rows whose CPU routing differs counted), its MoE
    block on gmm against the gather formula (SA_GATHER_TOL), then row 15
    at its attention (16/2 heads, D 256) against its plain version, timed
    beside SDPA with its bound;
25. Whisper (whisper_phase, ``--phases whisper``): random weights (seed 0)
    at the config.json values of openai/whisper-large-v3 (WHISPER, recalled,
    not read from the file; 128 mel bins, width 1280, 32 + 32 layers of 20
    heads, FFN 5120, vocab 51866, the erf GELU) at full depth, written as a
    Hugging Face bf16 checkpoint under build/ and loaded by
    WhisperModel.from_safetensors in f32 (every leaf the written value):
    compute_mel of 30 s of seeded audio at 16 kHz and at 44.1 kHz
    (resampled), each against the CPU within WH_MEL_TOL and bitwise a
    second time; encode timed by graph replay (TFLOP/s against the f32
    peak, a kernel profile, a bitwise second encode); transcribe_tokens
    with the 4-token SOT prompt and 64 new tokens twice to the same tokens,
    its greedy loop's tok/s (the captured step replayed), one step's device
    ms by graph replay beside its bytes bound, eager ms and kernel
    profile, no port kernel launched (the path has none); the cached
    steps' logits against decoder_logits over the same tokens (WH_STEP_TOL
    a row); transcribe_streaming over six 5 s chunks; a 2 + 2-layer slice
    at full width against the CPU plain path (encoder output and decoder
    logits within FWD_TOL);
26. Kokoro (kokoro_phase, ``--phases kokoro``): Kokoro82M at
    hexgrad/Kokoro-82M's dims as KokoroDims records them (ALBERT 768 x 12
    shared layers, hidden 512, decoder 1024, generator 512 channels; 81.2 M
    f32 parameters) from a random checkpoint (init_random_flat, seed 0,
    scale 0.05) written in the reference test's layout (a nested .pth with
    module. prefixes, config.json with the vocabulary, voices/af_heart.pt)
    and loaded by Kokoro82M.from_pretrained (bitwise the written values):
    an 8-id phoneme string on the card and on the CPU with the same sine
    draws (float durations within KOK_DUR_RTOL with their margins to a
    rounding boundary, the rounded ones equal, the audio within
    KOK_AUDIO_TOL relative L2, a second card run bitwise, no port kernel
    launched); a 50-id text (1040 frames, 624 000 samples) synthesized
    twice bitwise, its captured program's device ms by replay, node
    count, the eager wall, audio seconds a wall second, the 12 LSTM
    directions alone by graph replay and one eager call's kernels by kind;
    synthesize_streaming over three sentences; the simple KokoroModel at
    its default config card vs CPU (KOK_SIMPLE_TOL); LLMTTSPipeline on the
    1.1B int4 LLM at 2 of 22 layers (greedy, 32 tokens through the
    reference test's character tokenizer) and VoicePipeline (Whisper at
    large-v3's widths, 2 + 2 layers f32, written by whisper_checkpoint, on
    silence, 0.5 s of a 220 Hz tone and silence: the four events, the
    transcript transcribe_tokens' of the utterance), the LLM's launches of
    rows 1 and 15 added to the summary line's.
Launches per decode step, prefill, forward or layer are counted in phases
6, 7, 9, 11, 12, 13, 14, 15, 16 and 17 and printed (phases 6-14, 16, 17)
on one line before the summary. A count is the wrappers' eager launches
(LAUNCHES) plus cost_analysis() x replays of every captured program
(launch_counts()): a replay ticks no wrapper counter.

Any failure exits non-zero. The last two lines are the kernel summary and
the device line read by automation; it exits 2 with no result when no CUDA
card is visible or the package is not beside this script.
"""

from __future__ import annotations

import functools
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (N, K) of the slice's four fused projections: qkv, o, gate_up, down
PROJ_SHAPES = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048),
               "down": (2048, 5632)}
ATTN_TOL = dict(atol=1e-2, rtol=1e-2)     # bf16 output, P rounded to bf16
# phase 3's batch attention case (B 8, MAX 1024): contexts from 1 to past
# MAX, and the masks: none, then a softcap with window 100, then window 300
# (slot 5's window starts at 400, inside a 64-row chunk of its split)
BDA_LENS = (1, 513, 1024, 1500, 37, 700, 1025, 256)
BDA_MASKS = ((None, None), (30.0, 100), (None, 300))
# phase 3's write-plus-attention timing: alternating turns of fused, two
# launches and the attention alone, each a 22-layer graph replayed PAIR_REPS
# times
PAIR_TURNS, PAIR_REPS = 10, 20
CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
              num_kv_heads=4, intermediate_size=5632, max_position_embeddings=2048,
              tie_word_embeddings=False)
# the kernels' TPU originals, for the summary line
SOURCES = {"w4a8_gemv": ("pygpukit_tpu_torch/csrc/w4a8_gemv.cu",
                         "pygpukit_tpu/kernels/gemv_quant.py:609"),
           "w4a16_gemv": ("pygpukit_tpu_torch/csrc/w4a16_gemv.cu",
                          "pygpukit_tpu/kernels/gemv_quant.py:158"),
           "block_w4a8_gemv": ("pygpukit_tpu_torch/csrc/block_w4a8_gemv.cu",
                               "pygpukit_tpu/kernels/gemv_quant.py:1137"),
           "block_w4a16_gemv": ("pygpukit_tpu_torch/csrc/block_w4a16_gemv.cu",
                                "pygpukit_tpu/kernels/gemv_quant.py:1260"),
           "conv_gemv": ("pygpukit_tpu_torch/csrc/conv_gemv.cu",
                         "pygpukit_tpu/kernels/gemv_quant.py:714"),
           "w4a8_gemm": ("pygpukit_tpu_torch/csrc/w4a8_gemm.cu",
                         "pygpukit_tpu/kernels/gemv_quant.py:830"),
           "kv_rows_write": ("pygpukit_tpu_torch/csrc/kv_row_write.cu",
                             "pygpukit_tpu/kernels/kv_row_write.py:116"),
           # the same row write as the batch-rows step runs it: in the
           # attention's pass one (with csrc/kv_row.cuh), no launch of its own
           "kv_rows_write_fused": ("pygpukit_tpu_torch/csrc/batch_decode_attention.cu",
                                   "pygpukit_tpu/kernels/kv_row_write.py:116"),
           "batch_decode_attention": (
               "pygpukit_tpu_torch/csrc/batch_decode_attention.cu",
               "pygpukit_tpu/kernels/batch_decode_attention.py:153"),
           "paged_attention": ("pygpukit_tpu_torch/csrc/paged_attention.cu",
                               "pygpukit_tpu/kernels/paged_attention.py:80"),
           "flash_attention": ("pygpukit_tpu_torch/csrc/flash_attention.cu",
                               "pygpukit_tpu/kernels/flash_attention.py:90"),
           "flash_decode": ("pygpukit_tpu_torch/csrc/flash_decode.cu",
                            "pygpukit_tpu/kernels/flash_attention.py:194"),
           "gemm": ("pygpukit_tpu_torch/csrc/gemm.cu", "pygpukit_tpu/kernels/gemm.py:58"),
           "gemv_quant": ("pygpukit_tpu_torch/csrc/gemv_quant.cu",
                          "pygpukit_tpu/kernels/gemv_quant.py:54"),
           "fused_decode": ("pygpukit_tpu_torch/csrc/fused_decode.cu",
                            "pygpukit_tpu/kernels/fused_decode.py:393"),
           "gmm": ("pygpukit_tpu_torch/csrc/gmm.cu", "pygpukit_tpu/ops/moe.py:60")}
DENSE_KERNELS = ("w4a8_gemv", "w4a8_gemm", "kv_rows_write_fused", "batch_decode_attention")
# no w4a8_gemm: the paged path's 16-token prompts pad to 32 rows, which the
# int4 route sends to the dequant matmul (the GEMM takes 256 rows and more)
PAGED_KERNELS = ("w4a8_gemv", "paged_attention")
GEMVS = ("w4a8_gemv", "w4a16_gemv", "block_w4a8_gemv", "block_w4a16_gemv", "conv_gemv")
# the reference's decode ladder (bench.py:469-486): rung -> (quant mode or
# None for bf16, route switches, the GEMV every decode projection launches)
LADDER = {"bf16": (None, {}, None), "fp8": ("fp8", {}, "conv_gemv"),
          "int8": ("int8", {}, None), "int4": ("int4", {}, "w4a8_gemv"),
          "int4 w4a16": ("int4", {"PYGPUKIT_INT4_MODE": "w4a16"}, "w4a16_gemv"),
          "int4_block": ("int4_block", {}, "block_w4a8_gemv"),
          "int4_block w4a16": ("int4_block", {"PYGPUKIT_INT4_BLOCK": "w4a16"},
                               "block_w4a16_gemv")}
# the ladder's and the decode phase's generate: 128 new tokens (the
# reference's bench_decode takes 256; cut to keep the script's time)
LADDER_PROMPT, LADDER_NEW, LADDER_MAX = list(range(1, 17)), 128, 512
# the warm run's tokens: a prefix of the timed run's (all of them: the warm
# run captures the prefill and the chunks the timed run replays)
LADDER_WARM = LADDER_NEW
# generate's chunk in phases 9 and 13: each chunk size is a captured
# program whose capture runs it eagerly once, so 16-step chunks (two
# programs, 15 and 16 steps) cost an eighth of one 127-step chunk's capture
GEN_CHUNK = 16
# the ladder GEMVs against their plain versions: one bf16 ulp plus 1e-4 of
# the largest |output| (the same exact f32 products summed in another
# order; the block w4a8 GEMV is held bitwise instead)
ULP_REL, NEAR_ZERO = 2.0 ** -7, 1e-4
PHASES = ("kernels", "dense", "paged", "tight", "ladder", "block", "parity",
          "forward", "ops", "decode", "moe", "kv", "strategies", "graphs", "load",
          "families", "rope", "conventions", "standalone", "trees", "qwen3next", "whisper",
          "kokoro")
# phase 17 (graphs): the model's window and chunk, the sampled chunk's
# temperature and top-k, the draft's tokens, the paged engine's requests
GRAPH_WINDOW, GRAPH_CHUNK, GRAPH_TEMP, GRAPH_TOPK = 6, 16, 0.8, 40
# phase 7's requests at 32 steps a dispatch (phase 7 runs 128): its chunk
# program is a fourth of phase 7's to capture and to run eagerly
GRAPH_DRAFT_NEW, GRAPH_PAGED_REQS, GRAPH_PAGED_STEPS = 64, 32, 32
# phase 18: the generate after the load (tokens, cache), the chat requests'
# new tokens and the least length of the long one (its prefill's rows take
# the w4a8 GEMM from 256), the host-to-device yardstick's bytes
LOAD_NEW, LOAD_MAX, LOAD_CHAT_NEW, LOAD_LONG, H2D_BYTES = 64, 1024, 32, 256, 1 << 30
# phase 19: the families at their published widths, the config.json values
# of each Hugging Face repository written here as numbers (nothing is
# downloaded): name -> (repository, config.json, layers run or None for all).
# Depth cut for the script's time since phase 22 came: Qwen2.5-0.5B 6 of
# 24 layers, Qwen3-0.6B 7 of 28, Gemma-2-2B 4 of 26, Gemma-3-1B 6 of 26
# (its global layer 6 among them); twice these since phase 21 came
FAMILIES = {
    "qwen2.5-0.5b": ("Qwen/Qwen2.5-0.5B", dict(
        model_type="qwen2", vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
        max_position_embeddings=32768, max_window_layers=24, rms_norm_eps=1e-6,
        rope_theta=1000000.0, sliding_window=32768, use_sliding_window=False,
        tie_word_embeddings=True, hidden_act="silu"), 6),
    "qwen3-0.6b": ("Qwen/Qwen3-0.6B", dict(
        model_type="qwen3", vocab_size=151936, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=40960, max_window_layers=28, rms_norm_eps=1e-6,
        rope_theta=1000000.0, sliding_window=None, use_sliding_window=False,
        tie_word_embeddings=True, hidden_act="silu"), 7),
    "gpt2": ("openai-community/gpt2", dict(
        model_type="gpt2", vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
        n_positions=1024, n_ctx=1024, layer_norm_epsilon=1e-5,
        activation_function="gelu_new"), None),
    "gemma-2-2b": ("google/gemma-2-2b", dict(
        model_type="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
        num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
        sliding_window=4096, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=256, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True), 4),
    "gemma-3-1b": ("google/gemma-3-1b-pt", dict(
        model_type="gemma3_text", vocab_size=262144, hidden_size=1152,
        intermediate_size=6912, num_hidden_layers=26, num_attention_heads=4,
        num_key_value_heads=1, head_dim=256, max_position_embeddings=32768,
        rms_norm_eps=1e-6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        rope_scaling=None, sliding_window=512, sliding_window_pattern=6,
        query_pre_attn_scalar=256, attn_logit_softcapping=None,
        final_logit_softcapping=None, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True), 6),
    # 4 of its 48 layers (128 experts of 768, top-8), for the phase's time
    "qwen3-30b-a3b": ("Qwen/Qwen3-30B-A3B", dict(
        model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, moe_intermediate_size=768, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128, num_experts=128,
        num_experts_per_tok=8, norm_topk_prob=True, decoder_sparse_step=1,
        mlp_only_layers=[], max_position_embeddings=40960, max_window_layers=48,
        rms_norm_eps=1e-6, rope_theta=1000000.0, use_sliding_window=False,
        sliding_window=None, tie_word_embeddings=False), 4),
}
# each family's engine capacity: GPT-2's 1024 learned positions bound it;
# Gemma-2's 8192 holds prompts past its 4096 window
FAM_MAX = {"gpt2": 1024, "gemma-2-2b": 8192}
FAM_MAX_DEFAULT = 1024
# prompts past the sliding windows: (count, least and most length)
FAM_LONG = {"gemma-3-1b": (4, 600, 700), "gemma-2-2b": (2, 4150, 4250)}
# forward tokens (GPT-2: its 1024 positions), generate's new tokens after
# FAM_PROMPT, the engines' requests and new tokens, the CPU slice's depth
# (Gemma-3: one global layer, its sixth) and prompt
FAM_FWD_S = {"gpt2": 1024}
FAM_NEW, FAM_PROMPT, FAM_REQS, FAM_REQ_NEW = 64, 16, 16, 32
FAM_SLICE = {"gemma-3-1b": 6}
FAM_SLICE_S = 64
# the round trip through a Hugging Face checkpoint written by save_safetensors
FAM_CHECKPOINT = ("gpt2", "gemma-3-1b")
# the D-256 variants on the kernels line: name -> the base kernel whose
# source and TPU original they share, and the family whose path they serve
D256_ROWS = {"batch_decode_attention_d256": ("batch_decode_attention", "gemma-2-2b"),
             "paged_attention_d256": ("paged_attention", "gemma-2-2b"),
             "flash_attention_d256": ("flash_attention", "gemma-3-1b"),
             "flash_decode_d256": ("flash_decode", "gemma-3-1b")}


def stand_in_factors(seed: int, top: float, n: int = 48) -> list:
    """``n`` LongRoPE factors ascending from 1.0 to under ``top``, drawn
    from ``seed``: Phi-3.5-mini's published short_factor / long_factor
    lists are not in the repository, so phase 20 runs these in their place
    (PERF.md names them stand-ins)."""
    rng = random.Random(seed)
    return [1.0] + sorted(1.0 + rng.uniform(0.0, top - 1.0) for _ in range(n - 1))


# phase 20 (rope): the families the rope variants brought, at their
# published widths, config.json values written as numbers as FAMILIES has
# them: name -> (repository, config.json, layers run or None for all).
# Depth cut for the script's time (phase 20 took 324-364 s at full depth
# but GLM-4's, 303.7 s after the first cuts): since phase 22 came,
# Llama-3.2-1B 4 of 16 layers, Gemma-3-4B 6 of 34 (its global layer 6
# among them), Phi-3.5-mini 4 of 32 (its 8192-row prefills took 136.5 s
# at full depth), GLM-4-9B 4 of 40, ERNIE-4.5-0.3B 9 of 18, SmolLM3-3B 4
# of 36 (NoPE layer 4), Qwen3-0.6B with yarn 7 of 28 (since phase 21
# came: 8, 6, 8, 4, 18, 8 and 14)
ROPE_FAMILIES = {
    "llama-3.2-1b": ("meta-llama/Llama-3.2-1B", dict(
        model_type="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8, head_dim=64,
        max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        tie_word_embeddings=True, hidden_act="silu"), 4),
    "gemma-3-4b": ("google/gemma-3-4b-pt (text config)", dict(
        model_type="gemma3_text", vocab_size=262208, hidden_size=2560,
        intermediate_size=10240, num_hidden_layers=34, num_attention_heads=8,
        num_key_value_heads=4, head_dim=256, max_position_embeddings=131072,
        rms_norm_eps=1e-6, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0}, sliding_window=1024,
        sliding_window_pattern=6, query_pre_attn_scalar=256, attn_logit_softcapping=None,
        final_logit_softcapping=None, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True), 6),
    "phi-3.5-mini": ("microsoft/Phi-3.5-mini-instruct", dict(
        model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=131072, original_max_position_embeddings=4096,
        rope_theta=10000.0, rope_scaling={"type": "longrope",
                                          "short_factor": stand_in_factors(35, 3.0),
                                          "long_factor": stand_in_factors(53, 64.0)},
        sliding_window=262144, rms_norm_eps=1e-5, tie_word_embeddings=False,
        hidden_act="silu"), 4),
    "glm-4-9b": ("THUDM/GLM-4-9B-0414", dict(
        model_type="glm4", vocab_size=151552, hidden_size=4096, intermediate_size=13696,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=2, head_dim=128,
        partial_rotary_factor=0.5, max_position_embeddings=32768, rope_theta=10000.0,
        attention_bias=True, rms_norm_eps=1e-5, tie_word_embeddings=False,
        hidden_act="silu"), 4),
    "ernie-4.5-0.3b": ("baidu/ERNIE-4.5-0.3B-PT", dict(
        model_type="ernie4_5", vocab_size=103424, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=18, num_attention_heads=16, num_key_value_heads=2, head_dim=128,
        max_position_embeddings=131072, rope_theta=500000.0, rms_norm_eps=1e-5,
        use_bias=False, tie_word_embeddings=True, hidden_act="silu"), 9),
    "smollm3-3b": ("HuggingFaceTB/SmolLM3-3B", dict(
        model_type="smollm3", vocab_size=128256, hidden_size=2048, intermediate_size=11008,
        num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=4,
        no_rope_layer_interval=4, max_position_embeddings=65536, rope_theta=5000000.0,
        rms_norm_eps=1e-6, use_sliding_window=False, sliding_window=None,
        tie_word_embeddings=True, hidden_act="silu"), 4),
    "qwen3-0.6b-yarn": ("Qwen/Qwen3-0.6B with its model card's yarn block", dict(
        FAMILIES["qwen3-0.6b"][1], rope_scaling={
            "rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32768}),
        7),
}
# the engines' capacity past Phi-3.5's 4096-token threshold and Gemma-3-4B's
# 1024 window, and the prompts past them (count, least and most length)
FAM_MAX.update({"phi-3.5-mini": 8192, "gemma-3-4b": 2048})
FAM_LONG.update({"phi-3.5-mini": (2, 4150, 4250), "gemma-3-4b": (4, 1100, 1300)})
# the CPU slice's depth: Gemma-3-4B's first global layer is its sixth,
# SmolLM3's first NoPE layer its fourth
FAM_SLICE.update({"gemma-3-4b": 6, "smollm3-3b": 4})
# LongRoPE's original_max in the CPU slice: below its FAM_SLICE_S prompt
FAM_SLICE_THRESHOLD = {"phi-3.5-mini": 32}
FAM_CHECKPOINT += ("llama-3.2-1b", "phi-3.5-mini")
# each round trip's Hugging Face layout (a MODEL_SPECS name)
FAM_SPEC = {"gpt2": "gpt2", "gemma-3-1b": "gemma3", "llama-3.2-1b": "llama",
            "phi-3.5-mini": "phi3"}
# the single-stream generate's cache rows
FAM_GEN_MAX = 256
# the fused step (row 18) on scaled tables, against the unfused step
FAM_FUSED = ("llama-3.2-1b",)
# the dense and paged engines must give the same streams: rows on both
# sides of LongRoPE's threshold in one batch
FAM_ENGINES_EQUAL = ("phi-3.5-mini",)
# the D-96 variants on the kernels line (Phi-3.5-mini's path), as D256_ROWS
D96_ROWS = {"batch_decode_attention_d96": ("batch_decode_attention", "phi-3.5-mini"),
            "paged_attention_d96": ("paged_attention", "phi-3.5-mini"),
            "flash_attention_d96": ("flash_attention", "phi-3.5-mini"),
            "flash_decode_d96": ("flash_decode", "phi-3.5-mini")}
# phase 21 (conventions): the families of the block, norm, activation and
# head conventions at their published widths, config.json values written
# as numbers as FAMILIES has them (as recalled: nothing is downloaded, so
# none could be checked against the files): name -> (repository,
# config.json, layers run or None for all). Depth cut for the script's
# time (phase 21 took 233.5 s at the depths 16, 8, 40, 12, 8 and 32):
# OLMo-2-1B 4 of 16 layers, Aya-23-8B 4 of 32, Granite-3.1-2B 4 of 40,
# Nemotron-Mini-4B 4 of 32, Apertus-8B 4 of 32, Phi-2 4 of 32 (Granite 8,
# Nemotron 6 and Phi-2 8 until phase 22 came)
CONV_FAMILIES = {
    "olmo-2-1b": ("allenai/OLMo-2-0425-1B", dict(
        model_type="olmo2", vocab_size=100352, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=4096, rope_theta=500000.0, rms_norm_eps=1e-6,
        attention_bias=False, tie_word_embeddings=False, hidden_act="silu"), 4),
    "aya-23-8b": ("CohereForAI/aya-23-8B", dict(
        model_type="cohere", vocab_size=256000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rope_theta=10000.0, layer_norm_eps=1e-5,
        logit_scale=0.0625, use_qk_norm=False, tie_word_embeddings=True,
        hidden_act="silu"), 4),
    "granite-3.1-2b": ("ibm-granite/granite-3.1-2b-instruct", dict(
        model_type="granite", vocab_size=49155, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=5000000.0, rms_norm_eps=1e-5,
        embedding_multiplier=12.0, attention_multiplier=0.015625,
        residual_multiplier=0.22, logits_scaling=8.0, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=True, hidden_act="silu"), 4),
    "nemotron-mini-4b": ("nvidia/Nemotron-Mini-4B-Instruct", dict(
        model_type="nemotron", vocab_size=256000, hidden_size=3072, intermediate_size=9216,
        num_hidden_layers=32, num_attention_heads=24, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=4096, rope_theta=10000.0, partial_rotary_factor=0.5,
        norm_eps=1e-5, attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
        hidden_act="relu2"), 4),
    "apertus-8b": ("swiss-ai/Apertus-8B-2509", dict(
        model_type="apertus", vocab_size=131072, hidden_size=4096, intermediate_size=21504,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=65536, rope_theta=12000000.0, rms_norm_eps=1e-5,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        qk_norm=True, attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
        hidden_act="xielu"), 4),
    "phi-2": ("microsoft/phi-2", dict(
        model_type="phi", vocab_size=51200, hidden_size=2560, intermediate_size=10240,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=2048, rope_theta=10000.0, partial_rotary_factor=0.4,
        layer_norm_eps=1e-5, qk_layernorm=False, tie_word_embeddings=False,
        hidden_act="gelu_new"), 4),
}
# Phi-2's engines at its whole context, 2 prompts of 1500-1900 tokens among
# short ones, dense and paged streams identical; the round trips of Phi-2
# (biased head) and OLMo-2 (no input norms, whole-width q/k norms)
FAM_MAX["phi-2"] = 2048
FAM_LONG["phi-2"] = (2, 1500, 1900)
FAM_ENGINES_EQUAL += ("phi-2",)
FAM_CHECKPOINT += ("phi-2", "olmo-2-1b")
FAM_SPEC.update({"phi-2": "phi", "olmo-2-1b": "olmo2"})
# the D-80 variants on the kernels line (Phi-2's path), as D256_ROWS
D80_ROWS = {"batch_decode_attention_d80": ("batch_decode_attention", "phi-2"),
            "paged_attention_d80": ("paged_attention", "phi-2"),
            "flash_attention_d80": ("flash_attention", "phi-2"),
            "flash_decode_d80": ("flash_decode", "phi-2")}
# the tokenizer's training text (write_tokenizer) and the chat requests
TOKENIZER_MERGES = 400
TOKENIZER_TEXT = (
    "A checkpoint is a directory of weights, a config and a tokenizer. The runtime "
    "maps the weights, copies them to the card through pinned memory, converts and "
    "transposes them there, and serves the model to many requests at once. Each "
    "request is a conversation: a system message, then the user's question, then "
    "the assistant's answer, token by token, until it has said enough. It's 2024; "
    "the numbers 0123456789 and the words that people write every day should cost "
    "few tokens, while rare words cost more.")
CHAT_QUESTIONS = ("What is a checkpoint?", "How many layers does the model have?",
                  "Say hello in three languages.", "Why copy through pinned memory?",
                  "What does the tokenizer do with rare words?", "Count to ten.",
                  "Summarise the text below in one line.")
# phase 16: the positions the captured step replays at (captured at 16),
# and the steps of the back-to-back eager and replayed step loops
STRAT_POSITIONS, STRAT_STEPS = (17, 100, 300, 511), 128
# phase 16's context check: a step is a near-tie when DecodeM1's top-2 gap
# is at most STRAT_TIE of its largest |logit| (eight bf16 roundings, 2^-8
# each), and a strategy's KV rows must be DecodeM1's within STRAT_KV_TOL
# (relative L2 a layer; FUSED_DEEP_TOL's bound for 22 bf16 layers)
STRAT_TIE, STRAT_KV_TOL = 2.0 ** -5, 5e-2
# phase 16's peaked model: the embedding scaled by PEAKED_EMBED and the head
# the scaled embedding's rows in a seeded permuted order, so the residual
# stream carries the token and the head maps it to its permuted successor
# with a wide margin: well-separated greedy choices on every route (128
# distinct tokens). The head x 20 of tests/test_torch_moe.py's peaked pair
# leaves every argmax where it was (a scale), and the permuted head alone
# (x 1) agreed in 1-2 of 128 tokens; x 30, 300 and 3000 in all 128 on an
# H100 80GB HBM3 at 700 W (PERF.md)
PEAKED_EMBED = 30.0
# phase 15, the reference's bench_serving_kv (bench.py:390-428): one 16-token
# prompt, 8 warm-up requests of one dispatch, 16 timed requests
KV_PROMPT, KV_WARM, KV_REQS, KV_NEW, KV_STEPS, KV_MAX = list(range(1, 17)), 8, 16, 128, 32, 4096
# the card's published peaks (dense): bytes/s of HBM and operations/s by
# operand type, read by main from the port's one table
# (pygpukit_tpu_torch.core.device.CARD_PEAKS); a bound is the larger of the
# two times
HBM_BYTES_S = 0.0
PEAK_OPS_S: dict = {}
# flash_attention against its plain version in f32: the same products summed
# in another order, so within 1e-4 of the largest |output|
F32_REL = 1e-4
# (S, Hq, Hk, D, dtype, causal) of the flash_attention checks; the summary
# line's numbers are the forward's layer shape, the second entry
FLASH_CASES = [(1000, 32, 4, 64, "bf16", True), (2048, 32, 4, 64, "bf16", True),
               (8192, 32, 4, 64, "bf16", True), (2048, 32, 4, 64, "bf16", False),
               (2048, 32, 8, 128, "bf16", True), (1, 32, 8, 128, "bf16", True),
               (63, 32, 8, 128, "bf16", True), (129, 32, 8, 128, "bf16", True),
               (8192, 32, 8, 128, "bf16", True), (1000, 32, 4, 64, "f32", True)]
# (Hq, Hk, D, MAX, ctx, dtypes) of the flash_decode checks: the 1.1B heads
# at MAX 8192 and in the decode phase's 512-row cache (the step at pos 143
# attends 144 rows, the summary row; at pos 511, 512), and Mixtral's heads
# as phase 14's decode step gives them (MOE_MAX 1024, the step at pos
# MOE_PROMPT + MOE_NEW // 2 = 544 attends 545 rows)
DECODE_CASES = ((32, 4, 64, 8192, 1, ("bf16", "f32")), (32, 4, 64, 8192, 700, ("bf16", "f32")),
                (32, 4, 64, 8192, 8192, ("bf16", "f32")), (32, 4, 64, 512, 144, ("bf16", "f32")),
                (32, 4, 64, 512, 512, ("bf16",)), (32, 8, 128, 1024, 545, ("bf16",)))
DECODE_ROW = (32, 4, 64, 512, 144, "bf16")
# contexts a flash_decode graph captured once (ctx_len on the card) replays
# at, against the eager call with an int: below 0, one row, chunk edges,
# the decode phase's 144, MAX and past it
DECODE_GRAPH_CTX = (0, 1, 64, 65, 144, 511, 512, 519, -3)
# (layers, pos, MAX) of the fused_decode checks; the summary row times the
# decode phase's shape, the last entry is past the reference's VMEM gate
FUSED_CASES = ((2, 1, 512), (2, 143, 512), (2, 511, 512), (22, 1, 512), (22, 143, 512),
               (22, 511, 512), (22, 3000, 4096))
FUSED_TIMED = (22, 143, 512)
FUSED_GRAPH_POS = (37, 511)               # a graph captured at FUSED_TIMED replays here
# fused_decode against its plain version at 22 layers, relative L2: every
# bf16 rounding of the residual stream that summation order flips moves the
# next layer's input, so two orders drift apart with depth. Phase 3 prints
# the drift of the plain version itself, on the card against on the CPU
# (cuBLAS against the CPU's BLAS), beside the kernel's; at 2 layers both
# stay under 1e-2. A wrong layout, offset or mask gives order 1.
FUSED_DEEP_TOL = 5e-2
SNAP_AT, SNAP_MORE = 100, 50             # decode phase: snapshot, then replay
DENSE_COMPARED = 8       # phase 7: the paged requests the dense pipelined engine reruns
# phase 7's cross-checks (the paged engine not pipelined, the dense
# pipelined engine) at 32 steps a dispatch: a 128-step chunk's capture
# runs it eagerly once (about 10 s), and a request's stream does not
# depend on the dispatch
CROSS_STEPS = 32
FWD_S, FWD_PROMPT, FWD_NEW = 2048, 16, 8
GEMM_BENCH_N = 8192                       # the reference's bf16 GEMM cell (bench.py:73)
QUANT_MKN = (8192, 4096, 14336)           # its fp8 and int8 cells (bench.py:92-139)
GEMV_STORAGE = ("e4m3", "int8", "bf16")
# gate_up's N with K off whole 16-byte vectors: every row but one in eight
# (bf16) starts off a 16-byte boundary (the kernel's head-and-tail walk)
GEMV_UNALIGNED = (11264, 2051)
FWD_PARITY_S = 1024      # past the CPU plain route's 512-key chunk
# 2-layer full-width bf16 forward, card against the CPU plain forward,
# relative L2 of the logits. Both round every matmul output to bf16, summed
# in another order; the card's attention rounds P to bf16 where the CPU's
# chunked route keeps it f32. Expected 1e-3 to 1e-2; a wrong layout, rope or
# mask gives order 1.
FWD_TOL = 5e-2
# card vs CPU plain path, relative L2 of the logits. Not a rounding-level
# match: the w4a8 and w8a8 matmuls requantize bf16 activations, and one bf16
# ulp is about a quarter of an int8 step, so last-bit differences between the
# attention kernel and its plain version (and between CUDA and CPU float ops)
# move int8 values and spread through the layers. Measured 2.9e-2 on an H100
# for this 2-layer model; a wrong layout, rope or mask gives order 1.
REF_TOL = 1e-1
# Mixtral-8x7B-v0.1 (huggingface.co/mistralai/Mixtral-8x7B-v0.1, config.json)
# at its published widths, 8 of its 32 layers: all 32 are 93 GB of bf16
# weights, more than the card's 80 GB; 16 ran until phase 22 came (47 GB),
# 8 are about 24 GB
CFG_MIXTRAL = dict(vocab_size=32000, hidden_size=4096, num_layers=8, num_heads=32,
                   num_kv_heads=8, intermediate_size=14336, num_experts=8,
                   num_experts_per_tok=2, max_position_embeddings=32768, rope_theta=1e6,
                   norm_eps=1e-5, tie_word_embeddings=False)
MOE_FWD_S, MOE_PROMPT, MOE_NEW, MOE_MAX = 2048, 512, 64, 1024
MOE_REQUESTS, MOE_REQ_PROMPT, MOE_REQ_NEW, MOE_ENGINE_MAX = 8, 200, 32, 512
MOE_PARITY_S = 256
# the 2-layer Mixtral, card (gmm) against the CPU (dense route), is held
# row by row: the routes round gate, up and down at different points, so a
# token whose router logits nearly tie can pick another expert on each
# side and its row moves by order 1. A wrong layout or offset moves every
# row, a fault in one expert of 8 about a quarter of the rows or more; so
# this quantile of the rows' relative L2 stays within FWD_TOL
MOE_ROWS_Q = 0.95
# gmm against gmm_plain: both sum exact bf16 products in f32, in another order
GMM_REL = 1e-4
# gmm checks: (name, tokens, top-k, K, N, groups, sizes or None for a seeded
# top-k routing of the tokens, timed). Mixtral's gate/up (K 4096, N 14336)
# and down (K 14336, N 4096) at a 512-token prefill (M 1024) and the
# 2048-token forward (M 4096); an empty group, a one-row group, all rows in
# one group and M off the 128-row tile at the gate/up shape; Qwen3-30B-A3B's
# experts (K 2048, N 768, 128 groups, top-8 of 512 tokens): many small groups
GMM_CASES = [("gate_up_M1024", 512, 2, 4096, 14336, 8, None, True),
             ("down_M1024", 512, 2, 14336, 4096, 8, None, True),
             ("gate_up_M4096", 2048, 2, 4096, 14336, 8, None, True),
             ("down_M4096", 2048, 2, 14336, 4096, 8, None, True),
             ("empty_groups", 0, 0, 4096, 14336, 8, (300, 0, 200, 0, 250, 250, 0, 24), False),
             ("one_row_group", 0, 0, 4096, 14336, 8, (1, 200, 1, 300, 100, 200, 22, 200),
              False),
             ("one_group", 0, 0, 4096, 14336, 8, (0, 0, 0, 1024, 0, 0, 0, 0), False),
             ("M_off_tile", 100, 2, 4096, 14336, 8, None, False),
             ("qwen3_30b_a3b", 512, 8, 2048, 768, 128, None, True),
             # the CUDA-core route: an f32 Mixtral's layer at M 256 (a 128-token
             # prefill at top-2: the smallest M the MoE route sends to gmm), and
             # K and N off 8 on bf16 and on f32 operands
             ("f32_gate_up_M256", 128, 2, 4096, 14336, 8, None, True),
             ("f32_down_M256", 128, 2, 14336, 4096, 8, None, True),
             ("bf16_K_N_off_8", 300, 2, 1001, 1003, 8, None, False),
             ("f32_K_N_off_8", 300, 2, 1001, 1003, 8, None, False)]


# row 4's cases beyond the summary's M 8 and 256 (bitwise each): a ragged M,
# the 2048-token prefill, a ragged N (odd, off the 128-column tile) and the
# reference's int4 GEMM cell (bench.py:142-170), QUANT_MKN
W4A8_MORE_M, W4A8_RAGGED = (300, 2048), (300, 1001, 2048)
# row 1 (the w4a8 GEMV): the rows held bitwise at the four projections, the
# kernel both as the activation quantization's programmatic dependent (pdl,
# the wrapper's) and launched after it (separate), each bitwise and timed;
# a ragged N (odd, off the 16-column tile); the rows whose graph replays
# are held bitwise
W4A8_GEMV_ROWS, W4A8_FORMS, W4A8_GEMV_RAGGED_N = (1, 2, 5, 8), ("separate", "pdl"), 1001
W4A8_GEMV_REPLAYED = (1, 8)
# row 10 (the converting GEMV): its storages at the four projections, rows
# 1 and 8, within the tolerance; e4m3 and int8 timed; a ragged N (a
# multiple of 4 off the 64-column tile and the 16-byte load) and a K off
# every split (K 2052) at rows 1, 5 and 8
CONV_STORAGE, CONV_TIMED = ("e4m3", "e5m2", "int8", "bf16"), ("e4m3", "int8")
CONV_EDGES = ((2060, 2048), (2048, 2052))
# row 11's cases beyond the ladder's rows 1 and 8 (bitwise each): rows 2
# and 5 at the four projections; B 32 straddling K/2 (K 2080), a ragged N
# (a multiple of 4 off every column tile) and a narrow N, at rows 1, 5, 8
BLOCK_MORE_ROWS, BLOCK_EDGES = (2, 5), ((2048, 2080), (2060, 2048), (100, 2048))
# the card's name and power limit (nvidia-smi), printed beside every time
CARD = ""


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def time_ms(fn, n_variants: int, reps: int = 10) -> float:
    """Device time per call of ``fn(i)``: the calls for i = 0..n_variants-1
    (different weights or layers, so repeats do not find their data in
    L2) are captured once in a CUDA graph and the graph is replayed
    ``reps`` times between CUDA events. Host launch cost is excluded."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_variants):          # warm-up outside the capture
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_variants):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_variants)


def eager_ms(fn, n_variants: int, iters: int = 40) -> float:
    """Wall time per eager call, host launch cost included."""
    import torch
    for i in range(n_variants):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_variants)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` once and do ``ops`` operations of type ``kind``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(err: float, ms: float, plain_ms: float, nbytes: float, ops: float,
               kind: str, library_ms: float | None) -> dict:
    """One kernel's numbers for the summary line."""
    bms, by = bound(nbytes, ops, kind)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms}


def sdpa(q, k, v, **kw):
    """The library yardstick: one scaled_dot_product_attention call over
    [B, H, S, D] views (timed only; the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def step_launches(step) -> dict:
    """Kernel launches of one call ``step(0)``, counted from zero."""
    import torch
    reset_counts()
    step(0)
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    return counts


def reset_counts() -> None:
    """Set every launch count to 0: the wrappers' LAUNCHES and the launches
    of replays (``core.replayed_launches``)."""
    from pygpukit_tpu_torch import reset_launches
    from pygpukit_tpu_torch.core import reset_replayed_launches
    reset_launches()
    reset_replayed_launches()


def launch_counts() -> dict:
    """Kernel launches since ``reset_counts()``: each wrapper's eager
    launches (LAUNCHES) plus cost_analysis() x replays of every captured
    executable (a replay ticks no wrapper counter)."""
    from pygpukit_tpu_torch import LAUNCHES
    from pygpukit_tpu_torch.core import replayed_launches
    out = dict(LAUNCHES)
    for name, n in replayed_launches().items():
        out[name] = out.get(name, 0) + n
    return out


def zero_cache(model, max_len: int) -> None:
    """The model's caches of ``max_len`` rows zeroed at position 0, in place
    when it has them (its captured programs stay bound; init_fixed_cache
    releases them)."""
    if model.k_cache is None or model.max_seq_len != max_len:
        model.init_fixed_cache(max_len)
        return
    for cache in (model.k_cache, model.v_cache):
        for t in (cache.values() if isinstance(cache, dict) else (cache,)):
            t.zero_()
    model.pos = 0
    model._nonfinite.zero_()


def bits(t):
    import torch
    return t.view(torch.int16) if t.element_size() == 2 else t


def replays_bitwise(fn, what: str) -> None:
    """``fn()`` launched twice gives the same bits, and a CUDA graph of it
    captured once and replayed twice gives the eager call's bits."""
    import torch
    ref = fn()
    check(torch.equal(bits(ref), bits(fn())), f"{what}: a second launch differs")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(bits(out), bits(ref)), f"{what}: a graph replay differs")


def check_w4a8_cell(dev, g, detail: dict) -> None:
    """Phase 3: row 4 at the reference's int4 GEMM cell (QUANT_MKN, bench.py:
    142-170), bitwise against its plain version, timed beside the plain
    version and beside ``torch._int_mm`` of the same int8 activations and
    the unpacked int8 weight: the integer product alone, which neither
    unpacks nor scales, so ``int_mm_ms`` is a yardstick and not a library
    time (the port never calls it)."""
    import torch
    from pygpukit_tpu_torch.kernels import w4a8_matmul, w4a8_matmul_plain
    from pygpukit_tpu_torch.kernels.gemv_quant import quantize_acts
    from pygpukit_tpu_torch.llm.quant import unpack_int4
    m, k, n = QUANT_MKN
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    y, ref = w4a8_matmul(x, w, sc), w4a8_matmul_plain(x, w, sc)
    torch.cuda.synchronize()
    check(torch.equal(bits(y), bits(ref)), f"w4a8_gemm M {m} K {k} N {n}: not bitwise")
    del y, ref
    kms = time_ms(lambda i: w4a8_matmul(x, w, sc), 1, 5)
    pms = time_ms(lambda i: w4a8_matmul_plain(x, w, sc), 1, 2)
    xq, _ = quantize_acts(x)
    wq = unpack_int4(w)                                   # [N, K] int8; .t() is column-major
    ims = time_ms(lambda i: torch._int_mm(xq, wq.t()), 1, 5)
    nbytes, ops = n * k // 2 + 4 * n + m * (k + n) * 2, 2 * m * n * k
    row = kernel_row(0.0, kms, pms, nbytes, ops, "int8", None)
    detail["w4a8_gemm_cell"] = dict(row, share=row["bound_ms"] / kms, int_mm_ms=ims,
                                    tops=ops / kms / 1e9, int_mm_tops=ops / ims / 1e9)
    print(f"phase 3: w4a8_gemm at M {m}, K {k}, N {n} (the reference's int4 GEMM cell): "
          f"kernel {kms:.4f} ms = {ops / kms / 1e9:.1f} TOP/s, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}) = share {row['bound_ms'] / kms:.3f}, plain {pms:.3f} ms; "
          f"int_mm_ms {ims:.4f} (torch._int_mm of the int8 operands alone, "
          f"{ops / ims / 1e9:.1f} TOP/s) [{CARD}]")


def check_kernels(dev) -> tuple[dict, dict]:
    """Phase 3, the serving path's kernels: the w4a8 GEMV and GEMM (also
    at W4A8_MORE_M, W4A8_RAGGED and the reference's GEMM cell), the row
    write, batch and paged attention. Returns ({name: kernel_row},
    detail)."""
    import torch
    from pygpukit_tpu_torch.kernels import (batch_decode_attention,
                                            batch_decode_attention_plain,
                                            kv_rows_write, kv_rows_write_plain,
                                            w4a8_matmul, w4a8_matmul_plain)
    from pygpukit_tpu_torch.kernels.gemv_quant import w4a8_gemv_launch
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    detail: dict = {}
    res: dict = {}
    n_var = 8
    # per route: err, ms, plain_ms, bytes and int8 operations, summed over
    # the four projections at rows 8 (GEMV) and 256 (GEMM); M 2048 beside;
    # the GEMV at rows 1 beside
    gemv = dict.fromkeys(("err", "ms", "plain_ms", "bytes", "ops"), 0.0)
    gemm = dict(gemv)
    m2048 = dict(gemv)
    gemv1 = dict(gemv)
    forms: dict = {}               # rows -> {form: ms over the four projections}

    def w4a8_cost(rows, n, k):        # weights and scales, x in, y out; int8 ops
        return n * k // 2 + 4 * n + rows * (k + n) * 2, 2 * rows * n * k
    for name, (n, k) in PROJ_SHAPES.items():
        w = torch.randint(0, 256, (n_var, n, k // 2), generator=g, device=dev,
                          dtype=torch.uint8)
        sc = torch.rand((n_var, n), generator=g, device=dev) * 1e-3 + 1e-4
        for rows in W4A8_GEMV_ROWS + (32, 256) + W4A8_MORE_M:
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            y = w4a8_matmul(x, w[0], sc[0])
            ref = w4a8_matmul_plain(x, w[0], sc[0])
            torch.cuda.synchronize()
            same = torch.equal(bits(y), bits(ref))
            err = (y.float() - ref.float()).abs().max().item()
            check(same, f"w4a8 {name} rows={rows}: not bitwise (max abs err {err})")
            acc = gemv if rows <= 8 else gemm
            acc["err"] = max(acc["err"], err)
            if rows in (1, 8, 256, 2048):
                kms = time_ms(lambda i: w4a8_matmul(x, w[i], sc[i]), n_var)
                pms = time_ms(lambda i: w4a8_matmul_plain(x, w[i], sc[i]), n_var)
                ems = eager_ms(lambda i: w4a8_matmul(x, w[i], sc[i]), n_var)
                detail[f"w4a8_{name}_rows{rows}"] = {"ms": kms, "plain_ms": pms,
                                                     "eager_ms": ems}
                tot = m2048 if rows == 2048 else gemv1 if rows == 1 else acc
                nbytes, ops = w4a8_cost(rows, n, k)
                for key, v in (("ms", kms), ("plain_ms", pms), ("bytes", nbytes), ("ops", ops)):
                    tot[key] += v
            if rows <= 8:
                # the kernel with and without its programmatic launch, bitwise and timed
                tf = forms.setdefault(rows, dict.fromkeys(W4A8_FORMS, 0.0))
                for form in W4A8_FORMS:
                    pdl = form == "pdl"
                    check(torch.equal(bits(w4a8_gemv_launch(x, w[0], sc[0], pdl)), bits(ref)),
                          f"w4a8_gemv {name} rows={rows} {form}: not bitwise")
                    tf[form] += time_ms(lambda i: w4a8_gemv_launch(x, w[i], sc[i], pdl), n_var)
            if rows in W4A8_GEMV_REPLAYED and name in ("o", "down"):
                replays_bitwise(lambda: w4a8_matmul(x, w[0], sc[0]), f"w4a8_gemv {name} rows {rows}")
            if rows == 256:
                replays_bitwise(lambda: w4a8_matmul(x, w[0], sc[0]), f"w4a8_gemm {name} M 256")
        del w
    for rows, tf in sorted(forms.items()):
        detail[f"w4a8_gemv_forms_rows{rows}"] = tf
        print(f"phase 3: w4a8_gemv, the four projections at rows {rows}, activation quant "
              f"included: launched after it {tf['separate']:.5f} ms, as its programmatic "
              f"dependent (the wrapper's) {tf['pdl']:.5f} ms [{CARD}]")
    for what, tot in (("rows 1", gemv1), ("rows 8", gemv)):
        bms, by = bound(tot["bytes"], tot["ops"], "int8")
        detail[f"w4a8_gemv_four_{what.replace(' ', '')}"] = dict(tot, bound_ms=bms,
                                                                 share=bms / tot["ms"])
        print(f"phase 3: w4a8_gemv, the four projections at {what} (activation quant "
              f"included): kernel {tot['ms']:.5f} ms, bound {bms:.5f} ms ({by}) = share "
              f"{bms / tot['ms']:.3f}, plain {tot['plain_ms']:.4f} ms [{CARD}]")
    n, k = W4A8_GEMV_RAGGED_N, PROJ_SHAPES["o"][1]
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    for rows in W4A8_GEMV_ROWS:
        x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
        ref = w4a8_matmul_plain(x, w, sc)
        for form in W4A8_FORMS:
            check(torch.equal(bits(w4a8_gemv_launch(x, w, sc, form == "pdl")), bits(ref)),
                  f"w4a8_gemv N {n} K {k} rows={rows} {form}: not bitwise")
    for what, tot in (("M 256", gemm), ("M 2048", m2048)):
        bms, by = bound(tot["bytes"], tot["ops"], "int8")
        detail[f"w4a8_gemm_four_{what.replace(' ', '')}"] = dict(tot, bound_ms=bms,
                                                                 share=bms / tot["ms"])
        print(f"phase 3: w4a8_gemm, the four projections at {what} (activation quant "
              f"included): kernel {tot['ms']:.5f} ms = {tot['ops'] / tot['ms'] / 1e9:.1f} TOP/s, "
              f"bound {bms:.5f} ms ({by}) = share {bms / tot['ms']:.3f}, plain "
              f"{tot['plain_ms']:.4f} ms [{CARD}]")
    m, n, k = W4A8_RAGGED
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    check(torch.equal(bits(w4a8_matmul(x, w, sc)), bits(w4a8_matmul_plain(x, w, sc))),
          f"w4a8_gemm M {m} N {n} K {k}: not bitwise")
    replays_bitwise(lambda: w4a8_matmul(x, w, sc), f"w4a8_gemm M {m} N {n} K {k}")
    check_w4a8_cell(dev, g, detail)
    # no single PyTorch call multiplies packed int4 by int8-quantized rows
    for name, acc in (("w4a8_gemv", gemv), ("w4a8_gemm", gemm)):
        res[name] = kernel_row(acc["err"], acc["ms"], acc["plain_ms"], acc["bytes"],
                               acc["ops"], "int8", None)

    b, nl, mx, lanes, hq, d = 8, 22, 1024, 256, 32, 64
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(torch.bfloat16)
    poss = torch.tensor([0, 5, 511, mx - 1, mx, mx + 37, 100, 2 * mx],
                        dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kv_rows_write(k1, v1, kn, vn, 3, poss)
    kv_rows_write_plain(k2, v2, kn, vn, 3, poss)
    torch.cuda.synchronize()
    check(torch.equal(bits(k1), bits(k2)) and torch.equal(bits(v1), bits(v2)),
          "kv_rows_write: not bitwise")
    for slot in (3, 4, 5, 7):            # positions MAX-1 and beyond clamp
        check(torch.equal(bits(k1[slot, 3, mx - 1]), bits(kn[slot].reshape(-1))),
              f"kv_rows_write: slot {slot} row not at MAX-1")
    del k2, v2
    slots = torch.arange(b, device=dev)
    rows_at = poss.clamp(0, mx - 1).long()           # the kernel's clamp, untimed

    def index_put(i):                                # one index_put_ per pool
        k1[slots, i, rows_at] = kn.reshape(b, lanes)
        v1[slots, i, rows_at] = vn.reshape(b, lanes)
    kms = time_ms(lambda i: kv_rows_write(k1, v1, kn, vn, i, poss), nl)
    pms = time_ms(lambda i: kv_rows_write_plain(k1, v1, kn, vn, i, poss), nl)
    lms = time_ms(index_put, nl)
    detail["kv_rows_write"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                               "eager_ms": eager_ms(
                                   lambda i: kv_rows_write(k1, v1, kn, vn, i, poss), nl)}
    # the B new K and V rows read once and written once, and the positions
    res["kv_rows_write"] = kernel_row(0.0, kms, pms, 4 * b * lanes * 2 + 4 * b, 0,
                                      "bf16", lms)
    del k1, v1

    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor(BDA_LENS, dtype=torch.int32, device=dev)
    err = 0.0
    for softcap, window in BDA_MASKS:
        o = batch_decode_attention(q, kp, vp, 5, lens, softcap=softcap, window=window)
        r = batch_decode_attention_plain(q, kp, vp, 5, lens, 0.125, softcap, window)
        torch.cuda.synchronize()
        err = max(err, _attn_err(o, r, "bf16", f"batch_decode_attention (softcap="
                                 f"{softcap}, window={window})"))
        check(torch.equal(o, batch_decode_attention(q, kp, vp, 5, lens, softcap=softcap,
                                                    window=window)),
              "batch_decode_attention: a second launch differs")
    live = lens.clamp(max=mx)
    live_mask = (torch.arange(mx, device=dev)[None, :] < live[:, None])[:, None, None, :]

    def library(i):                      # the layer's pools as [B, Hk, MAX, D] views
        kk = kp[:, i].view(b, mx, lanes // d, d).transpose(1, 2)
        vv = vp[:, i].view(b, mx, lanes // d, d).transpose(1, 2)
        sdpa(q.transpose(1, 2), kk, vv, attn_mask=live_mask, scale=0.125)
    kms = time_ms(lambda i: batch_decode_attention(q, kp, vp, i, lens), nl)
    pms = time_ms(lambda i: batch_decode_attention_plain(q, kp, vp, i, lens, 0.125),
                  nl)
    lms = time_ms(library, nl)
    detail["batch_decode_attention"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                                        "eager_ms": eager_ms(
        lambda i: batch_decode_attention(q, kp, vp, i, lens), nl)}
    n_live = int(live.sum())
    res["batch_decode_attention"] = kernel_row(
        err, kms, pms, 2 * n_live * lanes * 2 + 2 * q.numel() * 2 + 4 * b,
        4 * hq * d * n_live, "bf16", lms)
    detail["batch_decode_attention"].update(
        {k: res["batch_decode_attention"][k] for k in ("bound_ms", "bound_by")},
        share=res["batch_decode_attention"]["bound_ms"] / kms)
    res["kv_rows_write_fused"] = check_write_attention(kp, vp, kn, vn, q, detail)
    check_dense_storages(dev, kp, vp, kn, vn, poss, q, lens, detail)
    del kp, vp
    res["paged_attention"] = check_paged_attention(dev, g, detail)
    return res, detail


def check_write_attention(kp, vp, kn, vn, q, detail: dict) -> dict:
    """Phase 3, rows 5 and 6 as the batch-rows step runs them:
    kv_write_attention (one attention launch whose pass one stores the new
    rows) at positions BDA_LENS - 1 under the masks of BDA_MASKS: the pools
    bitwise kv_rows_write_plain's, the output bitwise kv_rows_write then
    batch_decode_attention. Timed over 22 layers in PAIR_TURNS alternating
    turns beside those two kernels launched one after the other and the
    attention alone (each form's median and spread), with the pair's bound
    (the write's and the attention's bytes and operations summed), share
    and plain time. Returns row 5's summary-line numbers as the step runs
    it: the time the fused write adds to the attention (the medians'
    difference), its bound (the new rows' bytes), the plain write's and the
    index_put_ pair's times."""
    import statistics
    import torch
    from pygpukit_tpu_torch.kernels import (batch_decode_attention,
                                            batch_decode_attention_plain, kv_rows_write,
                                            kv_rows_write_plain, kv_write_attention)
    b, nl, mx, lanes = kp.shape
    d = q.shape[3]
    poss = torch.tensor(BDA_LENS, dtype=torch.int32, device=kp.device) - 1
    lens = poss + 1
    for softcap, window in BDA_MASKS:
        base_k, base_v = kp[:, 4:7].clone(), vp[:, 4:7].clone()
        k1, v1 = base_k.clone(), base_v.clone()
        out = kv_write_attention(q, k1, v1, kn, vn, 1, poss, lens, softcap=softcap,
                                 window=window)
        k2, v2 = base_k.clone(), base_v.clone()
        kv_rows_write_plain(k2, v2, kn, vn, 1, poss)
        k3, v3 = base_k.clone(), base_v.clone()
        kv_rows_write(k3, v3, kn, vn, 1, poss)
        want = batch_decode_attention(q, k3, v3, 1, lens, softcap=softcap, window=window)
        torch.cuda.synchronize()
        check(torch.equal(bits(k1), bits(k2)) and torch.equal(bits(v1), bits(v2)),
              f"kv_write_attention (window={window}): pools not bitwise")
        check(torch.equal(bits(out), bits(want)),
              f"kv_write_attention (softcap={softcap}, window={window}): output not bitwise "
              f"the two kernels'")
        del base_k, base_v, k1, v1, k2, v2, k3, v3

    def separate(i):
        kv_rows_write(kp, vp, kn, vn, i, poss)
        batch_decode_attention(q, kp, vp, i, lens)
    forms = {"fused": lambda i: kv_write_attention(q, kp, vp, kn, vn, i, poss, lens),
             "separate": separate,
             "attention": lambda i: batch_decode_attention(q, kp, vp, i, lens)}
    turns: dict = {f: [] for f in forms}
    for _ in range(PAIR_TURNS):
        for f, fn in forms.items():
            turns[f].append(time_ms(fn, nl, reps=PAIR_REPS))
    med = {f: statistics.median(v) for f, v in turns.items()}
    # the fused write: what it adds to the attention's launch
    wms = med["fused"] - med["attention"]
    slots = torch.arange(b, device=kp.device)
    rows_at = poss.clamp(0, mx - 1).long()

    def index_put(i):                                # one index_put_ per pool
        kp[slots, i, rows_at] = kn.reshape(b, lanes)
        vp[slots, i, rows_at] = vn.reshape(b, lanes)

    def plain_pair(i):
        kv_rows_write_plain(kp, vp, kn, vn, i, poss)
        batch_decode_attention_plain(q, kp, vp, i, lens, 0.125)
    pms = time_ms(lambda i: kv_rows_write_plain(kp, vp, kn, vn, i, poss), nl)
    pair_pms = time_ms(plain_pair, nl)
    lms = time_ms(index_put, nl)
    write_bytes = 4 * b * lanes * 2 + 4 * b
    row = kernel_row(0.0, wms, pms, write_bytes, 0, "bf16", lms)
    row["includes"] = ["pygpukit_tpu_torch/csrc/kv_row.cuh"]
    # the pair's bound: the write's and the attention's bytes and operations
    n_live = int(lens.clamp(max=mx).sum())
    pair_bound, pair_by = bound(write_bytes + 2 * n_live * lanes * 2 + 2 * q.numel() * 2
                                + 4 * b, 4 * q.shape[2] * d * n_live, "bf16")
    detail["kv_write_attention"] = dict(
        turns=turns, median=med, spread={f: max(v) - min(v) for f, v in turns.items()},
        layers_ms={f: nl * v for f, v in med.items()}, pair_bound_ms=pair_bound,
        pair_share=pair_bound / med["fused"], pair_plain_ms=pair_pms,
        fused_write_ms=wms, plain_write_ms=pms, library_ms=lms)
    print(f"phase 3: row write plus batch attention a layer (B {b}, MAX {mx}, lens "
          f"BDA_LENS, graph of {nl} layers, {PAIR_TURNS} alternating turns), median "
          f"[min, max]: " + ", ".join(f"{f} {med[f]:.5f} [{min(v):.5f}, {max(v):.5f}]"
                                       for f, v in turns.items())
          + f" ms; over {nl} layers fused {nl * med['fused']:.4f}, separate "
          f"{nl * med['separate']:.4f} ms; the pair's bound {pair_bound:.6f} ms ({pair_by}) = "
          f"share {pair_bound / med['fused']:.3f} fused, plain pair {pair_pms:.4f} ms; the "
          f"fused write adds {wms:.6f} ms a layer to the attention (bound "
          f"{row['bound_ms']:.6f} ms, {row['bound_by']}), plain write {pms:.4f} ms, "
          f"index_put_ {lms:.4f} ms [{CARD}]")
    return row


def to_storage(rows, kind: str, n_red: int):
    """bf16 or f32 ``rows`` in pool storage ``kind``: int8 as the {"q", "s"}
    dict (amax over the last ``n_red`` dims), fp8 clamped."""
    import torch
    from pygpukit_tpu_torch.ops.embedding import kv_quant_rows, to_kv_dtype
    if kind == "int8":
        qq, sc = kv_quant_rows(rows, n_red)
        return {"q": qq, "s": sc}
    return to_kv_dtype(rows, {"bf16": torch.bfloat16, "f32": torch.float32,
                              "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[kind])


def pool_bits(pool) -> list:
    import torch
    leaves = [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]
    return [t.contiguous().view(-1).view(torch.uint8) for t in leaves]


def pool_nbytes(pool) -> int:
    leaves = [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]
    return sum(t.numel() * t.element_size() for t in leaves)


def check_dense_storages(dev, kp, vp, kn, vn, poss, q, lens, detail: dict) -> None:
    """Phase 3: kv_rows_write (bitwise) and batch_decode_attention (within
    ATTN_TOL under bf16 queries, F32_REL under f32, a second launch
    bitwise) on every other pool storage, made from the bf16 pools; each
    timed. fp8 and int8 read half the bytes of bf16."""
    import torch
    from pygpukit_tpu_torch.kernels import (batch_decode_attention,
                                            batch_decode_attention_plain,
                                            kv_rows_write, kv_rows_write_plain,
                                            kv_write_attention)
    b, nl, mx, lanes = kp.shape
    live = lens.clamp(max=mx)
    n_live = int(live.sum())
    out = {}
    for kind in ("f32", "e4m3", "e5m2", "int8"):
        qk = q.float() if kind == "f32" else q
        nk, nv = (kn.float(), vn.float()) if kind == "f32" else (kn, vn)
        src = (kp.float(), vp.float()) if kind == "f32" else (kp, vp)
        pools = [to_storage(t, kind, 1) for t in src]
        copies = [to_storage(t, kind, 1) for t in src]
        kv_rows_write(pools[0], pools[1], nk, nv, 3, poss)
        kv_rows_write_plain(copies[0], copies[1], nk, nv, 3, poss)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for a, c in zip(pools, copies)
                  for x, y in zip(pool_bits(a), pool_bits(c))),
              f"kv_rows_write {kind}: not bitwise")
        del copies
        # the step's form of the pair on this storage: the pools of the
        # write above and the attention over them, bit for bit
        fused = [to_storage(t, kind, 1) for t in src]
        o = kv_write_attention(qk, fused[0], fused[1], nk, nv, 3, poss, poss + 1)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for a, c in zip(fused, pools)
                  for x, y in zip(pool_bits(a), pool_bits(c))) and
              torch.equal(o, batch_decode_attention(qk, pools[0], pools[1], 3, poss + 1)),
              f"kv_write_attention {kind}: not bitwise the two kernels")
        del fused
        err = 0.0
        for softcap, window in BDA_MASKS:
            o = batch_decode_attention(qk, pools[0], pools[1], 5, lens, softcap=softcap,
                                       window=window)
            r = batch_decode_attention_plain(qk, pools[0], pools[1], 5, lens, 0.125,
                                             softcap, window)
            torch.cuda.synchronize()
            err = max(err, _attn_err(o, r, "f32" if kind == "f32" else "bf16",
                                     f"batch_decode_attention {kind} (softcap={softcap}, "
                                     f"window={window})"))
            check(torch.equal(o, batch_decode_attention(qk, pools[0], pools[1], 5, lens,
                                                        softcap=softcap, window=window)),
                  f"batch_decode_attention {kind}: a second launch differs")
        elt = pool_nbytes(pools[0]) / (b * nl * mx * lanes)
        wms = time_ms(lambda i: kv_rows_write(pools[0], pools[1], nk, nv, i, poss), nl)
        ams = time_ms(lambda i: batch_decode_attention(qk, pools[0], pools[1], i, lens), nl)
        nbytes = 2 * n_live * lanes * elt + 2 * qk.numel() * qk.element_size() + 4 * b
        out[kind] = {"kv_rows_write_ms": wms, "attention_ms": ams, "max_abs_err": err,
                     "bound_ms": bound(nbytes, 4 * q.shape[2] * q.shape[3] * n_live,
                                       "f32" if kind == "f32" else "bf16")[0]}
        del pools
        torch.cuda.empty_cache()
    detail["kv_storages_dense"] = out
    print("phase 3: row write and batch attention by storage " + json.dumps(out))


def paged_inputs(dev, g, max_len: int, n_layers: int, b: int = 8, bs: int = 16,
                 hq: int = 32, hk: int = 4, d: int = 64):
    """Batch-b paged attention inputs at the 1.1B shape: [L, NB, Hk, BS, D]
    pools, each slot on shuffled non-contiguous blocks, contexts spread from
    1 to max_len, the last two slots dead on the trash table (block 0)."""
    import torch
    mb = max_len // bs
    nb = b * mb + 2
    kp = torch.randn((n_layers, nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((n_layers, nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm[:b * mb].reshape(b, mb).contiguous()
    tables[-2:] = 0
    lens = torch.tensor([1, 17, max_len // 2 + 3, max_len - 1, max_len, 300, 5, 40],
                        dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def check_paged_attention(dev, g, detail: dict) -> dict:
    """Phase 3, paged attention: the kernel_row at MAX 512 (the paged path's
    shape); MAX 1024 is checked and timed into ``detail``. The library
    yardstick runs over a contiguous copy of each slot's blocks, made
    outside the timing."""
    import torch
    from pygpukit_tpu_torch.kernels import paged_attention, paged_attention_plain
    from pygpukit_tpu_torch.kernels.paged_attention import _paged_gather
    err, rows = 0.0, {}
    nl = 22
    for max_len in (512, 1024):
        q, kp, vp, tables, lens = paged_inputs(dev, g, max_len, nl)
        for softcap, window in ((None, None), (30.0, 100)):
            o = paged_attention(q, kp[5], vp[5], tables, lens, scale=0.125,
                                softcap=softcap, window=window)
            r = paged_attention_plain(q, kp[5], vp[5], tables, lens, 0.125,
                                      softcap, window)
            torch.cuda.synchronize()
            e = (o.float() - r.float()).abs().max().item()
            check(torch.allclose(o.float(), r.float(), **ATTN_TOL),
                  f"paged_attention MAX {max_len} (softcap={softcap}, "
                  f"window={window}): max abs err {e}")
            err = max(err, e)
        seqs = [(_paged_gather(kp[i], tables), _paged_gather(vp[i], tables))
                for i in range(nl)]                  # [B, Hk, MB*BS, D], untimed
        t = seqs[0][0].shape[2]
        live_mask = (torch.arange(t, device=dev)[None, :]
                     < lens[:, None])[:, None, None, :]
        kms = time_ms(lambda i: paged_attention(q, kp[i], vp[i], tables, lens,
                                                scale=0.125), nl)
        pms = time_ms(lambda i: paged_attention_plain(q, kp[i], vp[i], tables,
                                                      lens, 0.125), nl)
        lms = time_ms(lambda i: sdpa(q[:, :, None], seqs[i][0], seqs[i][1],
                                     attn_mask=live_mask, scale=0.125), nl)
        n_live = int(lens.sum())
        hk, d = kp.shape[2], kp.shape[4]
        rows[max_len] = kernel_row(
            err, kms, pms, 2 * n_live * hk * d * 2 + 2 * q.numel() * 2
            + tables.numel() * 4 + lens.numel() * 4, 4 * q.shape[1] * d * n_live,
            "bf16", lms)
        detail[f"paged_attention_max{max_len}"] = dict(rows[max_len], eager_ms=eager_ms(
            lambda i: paged_attention(q, kp[i], vp[i], tables, lens, scale=0.125), nl),
            share=rows[max_len]["bound_ms"] / kms)
        check(torch.equal(paged_attention(q, kp[5], vp[5], tables, lens, scale=0.125),
                          paged_attention(q, kp[5], vp[5], tables, lens, scale=0.125)),
              f"paged_attention MAX {max_len}: a second launch differs")
        del seqs
        if max_len == 512:
            check_paged_storages(q, kp, vp, tables, lens, detail)
        del kp, vp
    return dict(rows[512], max_abs_err=err)


def check_paged_storages(q, kp, vp, tables, lens, detail: dict) -> None:
    """Phase 3: paged_attention on every other block-pool storage (int8:
    [L, NB, BS] scales, one a (block, offset) row over its heads), made
    from the bf16 pools [L, NB, Hk, BS, D]: against the plain version
    (ATTN_TOL; F32_REL under f32 queries), a second launch bitwise, timed."""
    import torch
    from pygpukit_tpu_torch.kernels import paged_attention, paged_attention_plain
    nl, _, hk, _, d = kp.shape
    n_live = int(lens.sum())
    out = {}
    for kind in ("f32", "e4m3", "e5m2", "int8"):
        qk = q.float() if kind == "f32" else q
        pools = []
        for src in (kp, vp):
            t = to_storage(src.transpose(2, 3), kind, 2)      # rows [.., BS, Hk, D]
            pools.append({"q": t["q"].transpose(2, 3).contiguous(), "s": t["s"]}
                         if isinstance(t, dict) else t.transpose(2, 3).contiguous())
        layer = [{"q": p["q"][5], "s": p["s"][5]} if isinstance(p, dict) else p[5]
                 for p in pools]
        o = paged_attention(qk, *layer, tables, lens, scale=0.125, window=100)
        r = paged_attention_plain(qk, *layer, tables, lens, 0.125, None, 100)
        torch.cuda.synchronize()
        # the plain version dequantizes int8 blocks to bf16 (the reference
        # engine's gather); the kernel folds the exact scales in
        err = _attn_err(o, r, "f32" if kind == "f32" else "bf16",
                        f"paged_attention {kind} (window 100)")
        check(torch.equal(o, paged_attention(qk, *layer, tables, lens, scale=0.125,
                                             window=100)),
              f"paged_attention {kind}: a second launch differs")

        def at(i, pools=pools):
            return [{"q": p["q"][i], "s": p["s"][i]} if isinstance(p, dict) else p[i]
                    for p in pools]
        ms = time_ms(lambda i: paged_attention(qk, *at(i), tables, lens, scale=0.125), nl)
        elt = pool_nbytes(pools[0]) / kp.numel()
        nbytes = 2 * n_live * hk * d * elt + 2 * qk.numel() * qk.element_size()
        out[kind] = {"ms": ms, "max_abs_err": err,
                     "bound_ms": bound(nbytes, 4 * q.shape[1] * d * n_live,
                                       "f32" if kind == "f32" else "bf16")[0]}
        del pools, layer
    detail["kv_storages_paged_max512"] = out
    print("phase 3: paged attention (MAX 512) by storage " + json.dumps(out))


def ladder_weights(dev, g, n: int, k: int, n_var: int) -> dict:
    """``n_var`` weights of each ladder GEMV at [N, K] (distinct weights
    cycle through more than the L2): name -> (tuple of per-variant argument
    tuples, weight and scale bytes of one variant)."""
    import torch
    kmajor = torch.randint(0, 256, (n_var, k // 2, n), generator=g, device=dev,
                           dtype=torch.uint8)
    sblock = (torch.rand((n_var, k // 32, n), generator=g, device=dev) * 1e-3
              + 1e-4).to(torch.bfloat16)
    packed = torch.randint(0, 256, (n_var, n, k // 2), generator=g, device=dev,
                           dtype=torch.uint8)
    sc = torch.rand((n_var, n), generator=g, device=dev) * 1e-3 + 1e-4
    fp8 = (torch.randn((n_var, k, n), generator=g, device=dev) * 64).to(torch.float8_e4m3fn)
    block = [(kmajor[i], sblock[i]) for i in range(n_var)]
    block_bytes = k // 2 * n + k // 32 * n * 2
    return {"block_w4a8_gemv": (block, block_bytes),
            "block_w4a16_gemv": (block, block_bytes),
            "w4a16_gemv": ([(packed[i], sc[i]) for i in range(n_var)], k // 2 * n + 4 * n),
            "conv_gemv": ([(fp8[i], sc[i]) for i in range(n_var)], k * n + 4 * n)}


def check_ladder_kernels(dev, g, detail: dict) -> dict:
    """Phase 3, the four ladder GEMVs at the four projection shapes, rows 1
    and 8 (the block GEMVs also at BLOCK_MORE_ROWS and BLOCK_EDGES, the
    block w4a8 GEMV in both forms of its activation quantization, the
    block w4a16 GEMV's C plan against its Python mirror and its graph
    replays at every projection): the block w4a8 GEMV
    bitwise, the others within one bf16 ulp plus
    1e-4 of max |y| (max abs error and share of equal elements reported);
    kernel and plain device ms and GB/s of weight and scale bytes. Returns
    {name: (max_abs_err, ms, plain_ms)} with the times summed over the four
    shapes at one row (the decode step's projections, per layer), and the
    bytes (weights, scales, x and y once) and operations of those four
    calls; no single PyTorch call computes an int4, int4_block or
    converting GEMV, so there is no library time."""
    import torch
    from pygpukit_tpu_torch import kernels as K
    fns = {"block_w4a8_gemv": (K.block_w4a8_matmul, K.block_w4a8_matmul_plain),
           "block_w4a16_gemv": (K.block_w4a16_matmul, K.block_w4a16_matmul_plain),
           "w4a16_gemv": (K.w4a16_matmul, K.w4a16_matmul_plain),
           "conv_gemv": (K.conv_matmul, K.conv_matmul_plain)}
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import (block_w4a16_plan, block_w4a8_launch,
                                                       w4a16_plan)
    res = {name: [0.0, 0.0, 0.0, 0.0, 0.0] for name in fns}
    forms: dict = {}               # block w4a8, rows -> [fused ms, separate ms] over the shapes
    w16: dict = {}                 # block w4a16, rows -> ms over the shapes
    w4: dict = {}                  # w4a16, rows -> [ms, plain ms, bytes] over the shapes
    for n, k in PROJ_SHAPES.values():           # its C plan is the Python mirror, >= 132 blocks
        for rows in (1, 8):
            plan = (ctypes.c_int * 4)()
            check(library().pgk_w4a16_plan(rows, n, k // 2, plan) == 0,
                  "pgk_w4a16_plan refused a projection")
            want = w4a16_plan(n, k // 2, rows)
            check(list(plan) == [want[key] for key in ("tile_n", "blocks", "warps", "batch")]
                  and want["blocks"] >= 128, f"w4a16 plan {n} x {k} rows {rows}: C "
                  f"{list(plan)}, Python {want}")
            plan = (ctypes.c_int * 6)()
            check(library().pgk_block_w4a16_plan(rows, n, k // 2, plan) == 0,
                  "pgk_block_w4a16_plan refused a projection")
            want = block_w4a16_plan(n, k // 2, rows)
            check(list(plan) == [want[key] for key in ("tile_n", "tiles", "splits", "warps",
                                                       "rounds", "smem")] and
                  want["blocks"] >= 132, f"block_w4a16 plan {n} x {k} rows {rows}: C "
                  f"{list(plan)}, Python {want}")
    n_var = 8
    for shape, (n, k) in PROJ_SHAPES.items():
        weights = ladder_weights(dev, g, n, k, n_var)
        for rows in (1, 8) + BLOCK_MORE_ROWS:
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            for name, (fn, plain) in fns.items():
                if rows in BLOCK_MORE_ROWS and name not in ("block_w4a8_gemv",
                                                            "block_w4a16_gemv"):
                    continue
                args, nbytes = weights[name]
                y, ref = fn(x, *args[0]), plain(x, *args[0])
                torch.cuda.synchronize()
                diff = (y.float() - ref.float()).abs()
                err = diff.max().item()
                equal = torch.eq(bits(y), bits(ref)).float().mean().item()
                if name == "block_w4a8_gemv":
                    # torch.equal: the mean of the equal elements need not be
                    # exactly 1.0 in f32 when they all are
                    check(torch.equal(bits(y), bits(ref)), f"{name} {shape} rows={rows}: "
                          f"not bitwise (max abs err {err}, equal share {equal})")
                else:
                    tol = ref.float().abs() * ULP_REL + NEAR_ZERO * ref.float().abs().max()
                    check(bool((diff <= tol).all()), f"{name} {shape} rows={rows}: "
                          f"max abs err {err}")
                if name == "block_w4a8_gemv":
                    # both forms of the activation quantization, bitwise, timed;
                    # the wrapper takes the faster by rows (BLOCK_FUSED_MAX_ROWS)
                    tf = forms.setdefault(rows, [0.0, 0.0])
                    for j, fused in enumerate((True, False)):
                        check(torch.equal(bits(block_w4a8_launch(x, *args[0], fused)), bits(ref)),
                              f"{name} {shape} rows={rows} fused={fused}: not bitwise")
                        tf[j] += time_ms(lambda i: block_w4a8_launch(x, *args[i], fused), n_var)
                    if shape == "o" and rows in (1, 8):
                        replays_bitwise(lambda: fn(x, *args[0]), f"{name} {shape} rows {rows}")
                if name in ("block_w4a16_gemv", "w4a16_gemv") and rows in (1, 8):
                    replays_bitwise(lambda: fn(x, *args[0]), f"{name} {shape} rows {rows}")
                kms = time_ms(lambda i: fn(x, *args[i]), n_var)
                pms = time_ms(lambda i: plain(x, *args[i]), n_var)
                detail[f"{name}_{shape}_rows{rows}"] = {
                    "ms": kms, "plain_ms": pms, "GBps": nbytes / kms / 1e6,
                    "plain_GBps": nbytes / pms / 1e6, "max_abs_err": err,
                    "equal_share": equal}
                r = res[name]
                r[0] = max(r[0], err)
                if name == "block_w4a16_gemv":
                    w16[rows] = w16.get(rows, 0.0) + kms
                if name == "w4a16_gemv":
                    acc4 = w4.setdefault(rows, [0.0, 0.0, 0.0])
                    for j, v in enumerate((kms, pms, nbytes + rows * (k + n) * 2)):
                        acc4[j] += v
                if rows == 1:
                    r[1] += kms
                    r[2] += pms
                    r[3] += nbytes + (k + n) * 2
                    r[4] += 2 * n * k
        del weights
    for rows, (fms, sms) in sorted(forms.items()):
        detail[f"block_w4a8_forms_rows{rows}"] = {"fused_ms": fms, "separate_ms": sms}
        print(f"phase 3: block_w4a8_gemv, the four projections at rows {rows}: activation "
              f"quant fused {fms:.5f} ms, separate launch first {sms:.5f} ms [{CARD}]")
    b16 = res["block_w4a16_gemv"][3] / HBM_BYTES_S * 1e3
    print(f"phase 3: block_w4a16_gemv, the four projections: " + ", ".join(
        f"rows {r} {ms:.5f} ms" for r, ms in sorted(w16.items())) + f"; bound at rows 1 "
        f"{b16:.5f} ms (bytes) = share {b16 / w16[1]:.3f} [{CARD}]")
    detail["block_w4a16_rows"] = w16
    for rows, (kms, pms, nbytes) in sorted(w4.items()):
        bms = nbytes / HBM_BYTES_S * 1e3
        detail[f"w4a16_gemv_four_rows{rows}"] = {"ms": kms, "plain_ms": pms, "bound_ms": bms,
                                                 "share": bms / kms}
        print(f"phase 3: w4a16_gemv, the four projections at rows {rows}: kernel {kms:.5f} ms, "
              f"bound {bms:.5f} ms (bytes) = share {bms / kms:.3f}, plain {pms:.4f} ms [{CARD}]")
    bms = res["block_w4a8_gemv"][3] / HBM_BYTES_S * 1e3
    print(f"phase 3: block_w4a8_gemv, the four projections at rows 1: kernel "
          f"{res['block_w4a8_gemv'][1]:.5f} ms, bound {bms:.5f} ms (bytes) = share "
          f"{bms / res['block_w4a8_gemv'][1]:.3f} [{CARD}]")
    for n, k in BLOCK_EDGES:         # straddling, ragged and narrow N: both forms bitwise
        w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        sb = (torch.rand((k // 32, n), generator=g, device=dev) * 1e-3 + 1e-4).to(torch.bfloat16)
        for rows in (1, 5, 8):
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            ref = K.block_w4a8_matmul_plain(x, w, sb)
            for fused in (True, False):
                check(torch.equal(bits(block_w4a8_launch(x, w, sb, fused)), bits(ref)),
                      f"block_w4a8_gemv N {n} K {k} rows={rows} fused={fused}: not bitwise")
            # the block w4a16 GEMV on the same edges, within its tolerance
            y16, ref16 = K.block_w4a16_matmul(x, w, sb), K.block_w4a16_matmul_plain(x, w, sb)
            tol = ref16.float().abs() * ULP_REL + NEAR_ZERO * ref16.float().abs().max()
            check(bool(((y16.float() - ref16.float()).abs() <= tol).all()),
                  f"block_w4a16_gemv N {n} K {k} rows={rows}: off the tolerance")
    return {name: kernel_row(*r, "int8" if name == "block_w4a8_gemv" else "bf16", None)
            for name, r in res.items()}


def conv_weights(storage: str, shape: tuple, g, dev):
    """Seeded K-major converting-GEMV weights: int8 in [-127, 127], else
    64 * N(0, 1) in fp8 e4m3 or e5m2 or bf16."""
    import torch
    if storage == "int8":
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2, "bf16": torch.bfloat16}
    return (torch.randn(shape, generator=g, device=dev) * 64).to(dt[storage])


def ulp_close(y, ref) -> bool:
    """Within one bf16 ulp of ``ref`` plus NEAR_ZERO of its largest |value|."""
    tol = ref.float().abs() * ULP_REL + NEAR_ZERO * ref.float().abs().max()
    return bool(((y.float() - ref.float()).abs() <= tol).all())


def check_conv_kernels(dev, g, detail: dict) -> None:
    """Phase 3, row 10 beyond the ladder's e4m3 summary: every storage of
    CONV_STORAGE at the four projection shapes, rows 1 and 8, within one
    bf16 ulp plus 1e-4 of max |y| of the plain version; the plan's blocks
    (at least one wave of 132 at every shape); CONV_TIMED storages timed
    over the four projections with their bytes bound and share; at o, two
    launches and a graph replay bitwise against the eager call; CONV_EDGES
    at rows 1, 5 and 8."""
    import torch
    from pygpukit_tpu_torch.kernels import conv_matmul, conv_matmul_plain
    from pygpukit_tpu_torch.kernels.gemv_quant import conv_gemv_plan
    n_var = 8
    tot: dict = {}                 # "storage rows" -> [ms, weight, scale, x and y bytes]
    for shape, (n, k) in PROJ_SHAPES.items():
        for rows in (1, 8):
            blocks = conv_gemv_plan(rows, n, k)["blocks"]
            check(blocks >= 132, f"conv_gemv {shape} rows {rows}: {blocks} blocks")
        for storage in CONV_STORAGE:
            w = conv_weights(storage, (n_var, k, n), g, dev)
            sc = torch.rand((n_var, n), generator=g, device=dev) * 1e-2 + 1e-3
            for rows in (1, 8):
                x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
                y, ref = conv_matmul(x, w[0], sc[0]), conv_matmul_plain(x, w[0], sc[0])
                err = (y.float() - ref.float()).abs().max().item()
                check(ulp_close(y, ref), f"conv_gemv {storage} {shape} rows {rows}: "
                      f"max abs err {err}")
                if storage in CONV_TIMED:
                    kms = time_ms(lambda i: conv_matmul(x, w[i], sc[i]), n_var)
                    t = tot.setdefault(f"{storage} rows {rows}", [0.0, 0.0])
                    t[0] += kms
                    t[1] += k * n * w.element_size() + 4 * n + 2 * rows * (k + n)
                if shape == "o":
                    replays_bitwise(lambda: conv_matmul(x, w[0], sc[0]),
                                    f"conv_gemv {storage} {shape} rows {rows}")
            del w
    for what, (ms, nbytes) in tot.items():
        bms = nbytes / HBM_BYTES_S * 1e3
        detail[f"conv_gemv_four_{what.replace(' ', '_')}"] = {"ms": ms, "bound_ms": bms,
                                                               "share": bms / ms}
        print(f"phase 3: conv_gemv {what}, the four projections: kernel {ms:.5f} ms = "
              f"{nbytes / ms / 1e6:.1f} GB/s, bound {bms:.5f} ms (bytes) = share "
              f"{bms / ms:.3f} [{CARD}]")
    for n, k in CONV_EDGES:       # a ragged N and a K off every split
        for storage in CONV_TIMED:
            w = conv_weights(storage, (k, n), g, dev)
            sc = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-3
            for rows in (1, 5, 8):
                x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
                check(ulp_close(conv_matmul(x, w, sc), conv_matmul_plain(x, w, sc)),
                      f"conv_gemv {storage} N {n} K {k} rows {rows}")
            replays_bitwise(lambda: conv_matmul(x, w, sc), f"conv_gemv {storage} N {n} K {k}")
    print(f"phase 3: conv_gemv on {list(CONV_STORAGE)} within the tolerance, replays "
          f"bitwise, plans of at least 132 blocks [{CARD}]")


def _attn_err(out, ref, kind: str, what: str) -> float:
    """Max abs error, checked: bf16 within ATTN_TOL (both round P to bf16,
    the kernel against a running maximum), f32 within F32_REL of max
    |ref|."""
    import torch
    e = (out.float() - ref.float()).abs().max().item()
    if kind == "bf16":
        check(torch.allclose(out.float(), ref.float(), **ATTN_TOL),
              f"{what}: max abs err {e}")
    else:
        check(e <= F32_REL * ref.float().abs().max().item(), f"{what}: max abs err {e}")
    return e


def check_flash_kernels(dev, g, detail: dict) -> dict:
    """Phase 3, flash_attention over FLASH_CASES and flash_decode over
    DECODE_CASES, bf16 and f32: each against its plain version, replayed
    bitwise, timed with its plain version, the library call
    (scaled_dot_product_attention, enable_gqa) and its bound. Returns the
    summary rows: flash_attention at the forward's layer shape (S 2048
    causal bf16), flash_decode at the decode phase's (ctx 144 in MAX 512,
    bf16)."""
    import torch
    from pygpukit_tpu_torch.kernels import (flash_attention, flash_attention_plain,
                                            flash_decode, flash_decode_plain)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    res = {}
    for s_len, hq, hk, d, kind, causal in FLASH_CASES:
        what = f"flash_attention S {s_len} Hq {hq} Hk {hk} D {d} {kind}" + (
            "" if causal else " full")
        n_var = 2 if s_len > 2048 else 4            # sets cycle past the L2
        qs = [torch.randn((s_len, hq, d), generator=g, device=dev).to(dts[kind])
              for _ in range(n_var)]
        ks = [torch.randn((s_len, hk, d), generator=g, device=dev).to(dts[kind])
              for _ in range(n_var)]
        vs = [torch.randn((s_len, hk, d), generator=g, device=dev).to(dts[kind])
              for _ in range(n_var)]
        out = flash_attention(qs[0], ks[0], vs[0], causal)
        err = _attn_err(out, flash_attention_plain(qs[0], ks[0], vs[0], causal),
                        kind, what)
        check(torch.equal(out, flash_attention(qs[0], ks[0], vs[0], causal)),
              f"{what}: a second launch differs")
        kms = time_ms(lambda i: flash_attention(qs[i], ks[i], vs[i], causal), n_var)
        pms = time_ms(lambda i: flash_attention_plain(qs[i], ks[i], vs[i], causal),
                      n_var, reps=2)
        lms = time_ms(lambda i: sdpa(qs[i].transpose(0, 1)[None],
                                     ks[i].transpose(0, 1)[None],
                                     vs[i].transpose(0, 1)[None], is_causal=causal),
                      n_var)
        pairs = s_len * (s_len + 1) / 2 if causal else s_len * s_len
        elt = out.element_size()
        row = kernel_row(err, kms, pms, (2 * hq + 2 * hk) * s_len * d * elt,
                         4 * hq * d * pairs, kind, lms)
        detail[what.replace(" ", "_")] = dict(row, share=row["bound_ms"] / kms)
        if (s_len, hk, kind, causal) == (2048, 4, "bf16", True):
            res["flash_attention"] = row
        del qs, ks, vs, out
    caches = sorted({(hq, hk, d, m, kind) for hq, hk, d, m, _, kinds in DECODE_CASES
                     for kind in kinds}, key=lambda c: (c[4], c[:4]))
    for hq, hk, d, max_len, kind in caches:
        nl = 22                                    # per-layer caches cycle past the L2
        kc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(dts[kind])
        vc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(dts[kind])
        q = torch.randn((1, hq, d), generator=g, device=dev).to(dts[kind])
        for ctx in (c[4] for c in DECODE_CASES if c[:4] == (hq, hk, d, max_len)
                    and kind in c[5]):
            heads = "" if (hq, hk, d) == DECODE_ROW[:3] else f" Hq {hq} Hk {hk} D {d}"
            what = f"flash_decode{heads} MAX {max_len} ctx {ctx} {kind}"
            out = flash_decode(q, kc[3], vc[3], ctx)
            err = _attn_err(out, flash_decode_plain(q, kc[3], vc[3], ctx), kind, what)
            check(torch.equal(out, flash_decode(q, kc[3], vc[3], ctx)),
                  f"{what}: a second launch differs")
            kms = time_ms(lambda i: flash_decode(q, kc[i], vc[i], ctx), nl)
            pms = time_ms(lambda i: flash_decode_plain(q, kc[i], vc[i], ctx), nl)
            lms = time_ms(lambda i: sdpa(q.transpose(0, 1)[None],
                                         kc[i, :ctx].permute(1, 0, 2)[None],
                                         vc[i, :ctx].permute(1, 0, 2)[None]), nl)
            elt = q.element_size()
            row = kernel_row(err, kms, pms, (2 * ctx * hk * d + 2 * hq * d) * elt,
                             4 * hq * d * ctx, kind, lms)
            detail[what.replace(" ", "_")] = dict(row, share=row["bound_ms"] / kms)
            print(f"phase 3: {what}: kernel {kms:.5f} ms, SDPA {lms:.5f} ms, bound "
                  f"{row['bound_ms']:.6f} ms = share {row['bound_ms'] / kms:.3f}, plain "
                  f"{pms:.4f} ms; max abs err {err:.3e}")
            if (hq, hk, d, max_len, ctx, kind) == DECODE_ROW:
                res["flash_decode"] = row
                decode_graph_replay(q, kc[3], vc[3], kind)
        del kc, vc
    return res


def decode_graph_replay(q, kc, vc, kind: str) -> None:
    """flash_decode with ctx_len an int32 tensor on the card, captured once
    in a CUDA graph: one launch, and each replay after ctx.fill_(v) bitwise
    the eager call at the int v, for v in DECODE_GRAPH_CTX."""
    import torch
    from pygpukit_tpu_torch.kernels import LAUNCHES, flash_decode, flash_decode_plain
    ctx = torch.zeros(1, dtype=torch.int32, device=q.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode(q, kc, vc, ctx)                 # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["flash_decode"]
    with torch.cuda.graph(graph):
        out = flash_decode(q, kc, vc, ctx)
    launches = LAUNCHES["flash_decode"] - before
    check(launches == 1, f"flash_decode captured {launches} launches, not one")
    for v in DECODE_GRAPH_CTX:
        ctx.fill_(v)
        graph.replay()
        eager = flash_decode(q, kc, vc, v)
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"flash_decode graph replay at ctx {v} differs from eager")
        _attn_err(eager, flash_decode_plain(q, kc, vc, v), kind, f"flash_decode ctx {v}")
    print(f"phase 3: flash_decode captured once with ctx_len on the card (MAX "
          f"{kc.shape[0]}, {kind}): {launches} launch a call; replays at ctx "
          f"{list(DECODE_GRAPH_CTX)} bitwise the eager calls")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def fused_graph_positions(args, heads, params, pos: int) -> None:
    """fused_decode captured once in a CUDA graph (pos, the rope row and the
    caches in device memory) and replayed at FUSED_GRAPH_POS and back at
    ``pos``: each replay bitwise the eager call at its position. Restores
    the arguments."""
    import torch
    from pygpukit_tpu_torch.kernels import fused_decode
    args = list(args)                    # the graph's own pos and rope row
    cos, sin, pos_t = args[1], args[2], args[3] = (args[1].clone(), args[2].clone(),
                                                    args[3].clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_decode(*args, **heads)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_decode(*args, **heads)
    for p in FUSED_GRAPH_POS + (pos,):
        pos_t.fill_(p)
        cos.copy_(params["rope_cos"][p:p + 1])
        sin.copy_(params["rope_sin"][p:p + 1])
        graph.replay()
        eager = fused_decode(*args, **heads)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, eager)),
              f"fused_decode graph replayed at pos {p}: not the eager call's bits")
    del graph


def check_fused_decode(cfg, dev, g, detail: dict) -> dict:
    """Phase 3, fused_decode over FUSED_CASES on the 1.1B bf16 leaves (seed
    0, the consolidated q|k|v and gate|up leaves) with random caches: each
    case against the plain version (relative L2 of h_out, k_new and v_new)
    and a bitwise second launch. At FUSED_TIMED: a graph replayed at
    FUSED_GRAPH_POS against eager, the C plan against fused_plan; kernel, eager and plain
    ms, its bound (weights, norms, the live K/V rows and the outputs once),
    and beside it the whole fused step (kernel, k/v scatter, head), the
    head alone and the unfused step (cuBLAS projections, flash_decode per
    layer, head) over [L, MAX, Hk, D] caches. No single PyTorch call
    computes the step: library_ms is null. Returns {"fused_decode": row}."""
    import torch
    from pygpukit_tpu_torch.kernels import fused_decode, fused_decode_plain
    from pygpukit_tpu_torch.kernels.fused_decode import fused_plan, plan_of
    from pygpukit_tpu_torch.llm import (decode_step_fn, fused_decode_step_fn, init_params,
                                        prepare_fused_decode_params)
    from pygpukit_tpu_torch.llm.model import _logits
    from pygpukit_tpu_torch.ops.nn import rope_tables
    bf16, f32 = torch.bfloat16, torch.float32
    max_pos = max(pos for _, pos, _ in FUSED_CASES) + 1
    params = init_params(cfg, 0, bf16, dev)
    params["rope_cos"], params["rope_sin"] = rope_tables(max(max_pos, 2048), cfg.head_dim,
                                                         cfg.rope_theta, device=dev)
    params = prepare_fused_decode_params(cfg, params)
    lp = params["layers"]
    e, inter = cfg.hidden_size, cfg.intermediate_size
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kvd = hk * d
    heads = dict(n_heads=hq, n_kv_heads=hk, head_dim=d, eps=cfg.norm_eps)
    err, timed = 0.0, {}
    for n, pos, mx in FUSED_CASES:
        kc = (torch.randn((n, mx, kvd), generator=g, device=dev) * 0.5).to(bf16)
        vc = torch.randn((n, mx, kvd), generator=g, device=dev).to(bf16)
        args = (params["embed"][7:8], params["rope_cos"][pos:pos + 1].to(f32),
                params["rope_sin"][pos:pos + 1].to(f32),
                torch.tensor([pos], dtype=torch.int32, device=dev), lp["w_qkv_cat"][:n],
                lp["w_o"][:n], lp["w_gu_cat"][:n], lp["w_down"][:n],
                lp["attn_norm_w"][:n].to(f32), lp["mlp_norm_w"][:n].to(f32),
                params["final_norm_w"].to(f32).reshape(1, -1), kc, vc)
        out = fused_decode(*args, **heads)
        ref = fused_decode_plain(*args, **heads)
        torch.cuda.synchronize()
        what = f"fused_decode L {n} pos {pos} MAX {mx}"
        rels = [rel_l2(a, b) for a, b in zip(out, ref)]
        tol = 1e-2 if n <= 2 else FUSED_DEEP_TOL
        check(all(bool(torch.isfinite(a.float()).all()) for a in out),
              f"{what}: a value is not finite")
        check(max(rels) <= tol, f"{what}: relative L2 of h_out, k_new, v_new {rels} "
              f"(limit {tol})")
        check(all(torch.equal(a, b) for a, b in zip(out, fused_decode(*args, **heads))),
              f"{what}: a second launch differs")
        e_abs = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, ref))
        err = max(err, e_abs)
        detail[what.replace(" ", "_")] = {"rel_l2": rels, "max_abs_err": e_abs}
        if (n, pos, mx) == FUSED_TIMED:
            # the same plain function summed by the CPU's BLAS: the depth
            # drift any two summation orders show (FUSED_DEEP_TOL)
            on_cpu = fused_decode_plain(*(a.cpu() for a in args), **heads)
            timed["spread"] = [rel_l2(a.cpu(), b) for a, b in zip(ref, on_cpu)]
            del on_cpu
            fused_graph_positions(args, heads, params, pos)
            timed["ms"] = time_ms(lambda i: fused_decode(*args, **heads), 1, reps=20)
            timed["plain_ms"] = time_ms(lambda i: fused_decode_plain(*args, **heads), 1, reps=5)
            timed["eager_ms"] = eager_ms(lambda i: fused_decode(*args, **heads), 1, iters=20)
            weights = n * e * (e + 2 * kvd + e + 2 * inter) + n * inter * e
            timed["bytes"] = (2 * weights + 4 * (2 * n * e + e) + 2 * (2 * n * pos * kvd)
                              + 2 * e + 8 * d + 4 + 2 * e + 4 * 2 * n * kvd)
            timed["ops"] = 2 * weights + n * 4 * hq * d * (pos + 1)
        del kc, vc, args, out, ref
    n, pos, mx = FUSED_TIMED
    kc4 = (torch.randn((n, mx, hk, d), generator=g, device=dev) * 0.5).to(bf16)
    vc4 = torch.randn((n, mx, hk, d), generator=g, device=dev).to(bf16)
    tok = torch.tensor([7], device=dev)
    step_ms = time_ms(lambda i: fused_decode_step_fn(cfg, params, kc4, vc4, tok, pos), 1,
                      reps=20)
    unfused_ms = time_ms(lambda i: decode_step_fn(cfg, params, kc4, vc4, tok, pos,
                                                  allow_fused=False), 1, reps=10)
    h_row = params["embed"][7].to(bf16)
    head_ms = time_ms(lambda i: _logits(cfg, params, h_row), 1, reps=20)
    res = kernel_row(err, timed["ms"], timed["plain_ms"], timed["bytes"], timed["ops"],
                     "bf16", None)
    plan = plan_of(dev, n_layers=n, hidden=e, intermediate=inter, n_heads=hq, n_kv_heads=hk,
                   head_dim=d, max_seq=mx)
    props = torch.cuda.get_device_properties(dev)
    want = fused_plan(n, e, inter, hq, hk, d, mx, sms=props.multi_processor_count)
    check(plan == want, f"fused_decode plan {plan} is not its Python mirror {want}")
    detail["fused_decode"] = dict(res, share=res["bound_ms"] / timed["ms"],
                                  eager_ms=timed["eager_ms"], fused_step_ms=step_ms,
                                  head_ms=head_ms, unfused_step_ms=unfused_ms, plan=plan,
                                  plain_card_vs_cpu_rel_l2=timed["spread"])
    print(f"phase 3: fused_decode at {n} layers, cache {mx}, pos {pos}: kernel "
          f"{timed['ms']:.4f} ms by graph replay (eager {timed['eager_ms']:.4f} ms wall), bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} = share "
          f"{res['bound_ms'] / timed['ms']:.3f}, plain {timed['plain_ms']:.4f} ms; the whole "
          f"fused step (kernel, k/v scatter, head) {step_ms:.4f} ms, the head alone "
          f"{head_ms:.4f} ms; the unfused step (cuBLAS projections, {n} flash_decode, head) "
          f"{unfused_ms:.4f} ms; plan {json.dumps(plan)}")
    rels = detail[f"fused_decode_L_{n}_pos_{pos}_MAX_{mx}"]["rel_l2"]
    print(f"phase 3: fused_decode relative L2 of h_out, k_new, v_new at {n} layers: kernel vs "
          f"plain {[f'{r:.2e}' for r in rels]}, the plain version on the card vs on the CPU "
          f"{[f'{r:.2e}' for r in timed['spread']]} (limit {FUSED_DEEP_TOL})")
    del params, lp, kc4, vc4
    torch.cuda.empty_cache()
    return {"fused_decode": res}


def _bf16_err(y, ref, what: str) -> float:
    """Max abs error of a bf16 result, checked within one bf16 ulp of |ref|
    plus NEAR_ZERO of max |ref| (f32 sums in another order, rounded once)."""
    r = ref.float()
    diff = (y.float() - r).abs()
    check(bool((diff <= r.abs() * ULP_REL + NEAR_ZERO * r.abs().max()).all()),
          f"{what}: max abs err {diff.max().item()}")
    return diff.max().item()


def check_gemm_kernels(dev, g, detail: dict) -> dict:
    """Phase 3, gemm (bf16 at M FWD_S on the four projection products as
    [K, N] weights, bf16 at GEMM_BENCH_N^3, f32 at 2048^3) and gemv_quant
    (the four projection shapes N-major in GEMV_STORAGE) against their
    plain versions, replayed bitwise, timed with the plain version and the
    library call. Returns the summary rows: gemm summed over the four
    projection products (the forward's per-layer GEMMs), gemv_quant summed
    over the four shapes on a bf16 weight with no scale (the function
    torch.mv computes)."""
    import torch
    from pygpukit_tpu_torch.kernels import gemm, gemm_plain, gemv_quant, gemv_quant_plain
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemm import gemm_plan
    bf16, f32 = torch.bfloat16, torch.float32
    card_plan = (ctypes.c_int * 4)()
    check(library().pgk_gemm_plan(2048, 2048, card_plan) == 0, "pgk_gemm_plan failed")
    clusters = {256: card_plan[2], 128: card_plan[3]}    # clusters the card runs at once
    keys = ("err", "ms", "plain_ms", "lib_ms", "bytes", "ops")
    proj = dict.fromkeys(keys, 0.0)
    cases = [(f"proj_{name}", FWD_S, n, k, bf16, 2) for name, (n, k) in PROJ_SHAPES.items()]
    cases += [(f"bf16_{GEMM_BENCH_N}cube", GEMM_BENCH_N, GEMM_BENCH_N, GEMM_BENCH_N, bf16, 1),
              ("f32_2048cube", 2048, 2048, 2048, f32, 2)]
    for what, m, n, k, dt, n_var in cases:
        a = [torch.randn((m, k), generator=g, device=dev).to(dt) for _ in range(n_var)]
        b = [torch.randn((k, n), generator=g, device=dev).to(dt) for _ in range(n_var)]
        y, ref = gemm(a[0], b[0], force="pallas"), gemm_plain(a[0], b[0], dt)
        torch.cuda.synchronize()
        if dt == bf16:
            err = _bf16_err(y, ref, f"gemm {what}")
        else:
            err = (y - ref).abs().max().item()
            check(err <= F32_REL * ref.abs().max().item(), f"gemm {what}: max abs err {err}")
        check(torch.equal(y, gemm(a[0], b[0], force="pallas")),
              f"gemm {what}: a second launch differs")
        del y, ref
        reps = 3 if m >= GEMM_BENCH_N else 10
        kms = time_ms(lambda i: gemm(a[i], b[i], force="pallas"), n_var, reps)
        pms = time_ms(lambda i: gemm_plain(a[i], b[i], dt), n_var, reps)
        lms = time_ms(lambda i: torch.matmul(a[i], b[i]), n_var, reps)
        nbytes, ops = (m * k + k * n + m * n) * a[0].element_size(), 2 * m * n * k
        row = kernel_row(err, kms, pms, nbytes, ops, "bf16" if dt == bf16 else "f32", lms)
        plan = gemm_plan(m, n, clusters) if dt == bf16 else None
        detail[f"gemm_{what}"] = dict(row, share=row["bound_ms"] / kms,
                                      tflops=ops / kms / 1e9, library_tflops=ops / lms / 1e9,
                                      plan=plan)
        if plan:
            cm, cn = plan["cluster"]
            tile = (f"tile 128 x {plan['bn']}, {plan['units']} units of {cm} x {cn} tiles on "
                    f"{plan['grid']} CTAs, {plan['waves']} waves "
                    f"({plan['units'] / (plan['waves'] * clusters[plan['bn']]):.2f} full); ")
        else:
            tile = "f32 FFMA tile; "
        print(f"phase 3: gemm {what} (M {m}, N {n}, K {k}): {tile}kernel {kms:.4f} ms = "
              f"{ops / kms / 1e9:.1f} TFLOP/s, torch.matmul {lms:.4f} ms = "
              f"{ops / lms / 1e9:.1f} TFLOP/s, bound {row['bound_ms']:.4f} ms = share "
              f"{row['bound_ms'] / kms:.3f}, plain {pms:.4f} ms; max abs err {err:.3e}")
        if what.startswith("proj"):
            for key, v in zip(keys, (err, kms, pms, lms, nbytes, ops)):
                proj[key] = max(proj[key], v) if key == "err" else proj[key] + v
        del a, b
    res = {"gemm": kernel_row(proj["err"], proj["ms"], proj["plain_ms"], proj["bytes"],
                              proj["ops"], "bf16", proj["lib_ms"])}
    gv = dict.fromkeys(keys, 0.0)
    totals: dict = {}
    n_var = 8
    for name, (n, k) in PROJ_SHAPES.items():
        x = torch.randn((k,), generator=g, device=dev).to(bf16)
        sc = torch.rand((n_var, n), generator=g, device=dev) + 0.5
        for storage in GEMV_STORAGE:
            w = gemv_weights(storage, (n_var, n, k), g, dev)
            scales = [None] * n_var if storage == "bf16" else list(sc)
            what = f"gemv_quant {name} {storage}"
            y, ref = gemv_quant(w[0], x, scales[0]), gemv_quant_plain(w[0], x, scales[0])
            torch.cuda.synchronize()
            err = _bf16_err(y, ref, what)
            check(torch.equal(y, gemv_quant(w[0], x, scales[0])), f"{what}: a second launch differs")
            kms = time_ms(lambda i: gemv_quant(w[i], x, scales[i]), n_var)
            pms = time_ms(lambda i: gemv_quant_plain(w[i], x, scales[i]), n_var)
            lms = time_ms(lambda i: torch.mv(w[i], x), n_var) if storage == "bf16" else None
            nbytes = n * k * w.element_size() + 2 * (k + n) + (0 if storage == "bf16" else 4 * n)
            row = kernel_row(err, kms, pms, nbytes, 2 * n * k, "bf16", lms)
            detail[what.replace(" ", "_")] = dict(row, share=row["bound_ms"] / kms,
                                                  GBps=nbytes / kms / 1e6)
            gv["err"] = max(gv["err"], err)
            if storage == "bf16":
                for key, v in zip(keys[1:], (kms, pms, lms, nbytes, 2 * n * k)):
                    gv[key] += v
            tot = totals.setdefault(storage, dict.fromkeys(("ms", "bytes", "lib_ms"), 0.0))
            for key, v in (("ms", kms), ("bytes", nbytes), ("lib_ms", lms or 0.0)):
                tot[key] += v
            del w
    for storage, tot in totals.items():
        bms = tot["bytes"] / HBM_BYTES_S * 1e3
        lib = f", torch.mv {tot['lib_ms']:.5f} ms" if storage == "bf16" else ""
        print(f"phase 3: gemv_quant {storage}, the four projections: kernel {tot['ms']:.5f} ms "
              f"= {tot['bytes'] / tot['ms'] / 1e6:.1f} GB/s, bound {bms:.5f} ms = share "
              f"{bms / tot['ms']:.3f}{lib}")
    n, k = GEMV_UNALIGNED
    x = torch.randn((k,), generator=g, device=dev).to(bf16)
    sc = torch.rand((n_var, n), generator=g, device=dev) + 0.5
    for storage in GEMV_STORAGE:
        w = gemv_weights(storage, (n_var, n, k), g, dev)
        what = f"gemv_quant N {n} K {k} {storage}"
        y, ref = gemv_quant(w[0], x, sc[0]), gemv_quant_plain(w[0], x, sc[0])
        torch.cuda.synchronize()
        err = _bf16_err(y, ref, what)
        check(torch.equal(y, gemv_quant(w[0], x, sc[0])), f"{what}: a second launch differs")
        kms = time_ms(lambda i: gemv_quant(w[i], x, sc[i]), n_var)
        nbytes = n * k * w.element_size() + 2 * (k + n) + 4 * n
        bms = nbytes / HBM_BYTES_S * 1e3
        aligned = detail[f"gemv_quant_gate_up_{storage}"]["ms"]
        detail[what.replace(" ", "_")] = {"ms": kms, "max_abs_err": err, "share": bms / kms}
        print(f"phase 3: {what} (rows off 16-byte vectors): kernel {kms:.5f} ms = "
              f"{nbytes / kms / 1e6:.1f} GB/s, bound {bms:.5f} ms = share {bms / kms:.3f}; "
              f"gate_up at K {PROJ_SHAPES['gate_up'][1]} {aligned:.5f} ms; max abs err {err:.3e}")
        del w
    res["gemv_quant"] = kernel_row(gv["err"], gv["ms"], gv["plain_ms"], gv["bytes"], gv["ops"],
                                   "bf16", gv["lib_ms"])
    return res


def gemv_weights(storage: str, shape: tuple, g, dev):
    """Seeded N-major gemv_quant weights: int8 in [-127, 127], else
    4 * N(0, 1) in fp8 e4m3 or bf16."""
    import torch
    if storage == "int8":
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    return (torch.randn(shape, generator=g, device=dev) * 4).to(
        torch.float8_e4m3fn if storage == "e4m3" else torch.bfloat16)


def gmm_sizes(dev, g, tokens: int, k: int, n_groups: int):
    """Group sizes of a seeded top-k routing of ``tokens`` tokens over
    ``n_groups`` experts (the port's topk_route_fn), int32 on the card."""
    import torch
    from pygpukit_tpu_torch.ops.moe import topk_route_fn
    _, ids = topk_route_fn(torch.randn((tokens, n_groups), generator=g, device=dev), k)
    return torch.bincount(ids.reshape(-1), minlength=n_groups).to(torch.int32)


def gmm_timed(lhs, rhs, gs, host_sizes: list, err: float, what: str) -> tuple:
    """gmm's device ms at (lhs, rhs, group sizes) beside gmm_plain's, the
    library call's (``torch._grouped_mm``, bf16 out; None where it refuses
    the operands) and the bound (each input read once: lhs, the weights of
    the groups that have rows, the sizes; the f32 output written once),
    printed after ``what``. Returns (ms, plain ms, library ms, bytes, ops,
    kernel_row)."""
    import torch
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    m, kk, n = lhs.shape[0], lhs.shape[1], rhs.shape[2]
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    kms = time_ms(lambda i: gmm(lhs, rhs, gs), 1, reps=5)
    pms = time_ms(lambda i: gmm_plain(lhs, rhs, host_sizes), 1, reps=2)
    try:                             # torch._grouped_mm may take no f32 operands
        lms = time_ms(lambda i: torch._grouped_mm(lhs, rhs, offs=offs), 1, reps=5)
    except RuntimeError as e:
        lms = None
        print(f"{what}: torch._grouped_mm refuses it: {str(e)[:120]}")
    live = sum(1 for x in host_sizes if x)
    size = lhs.element_size()
    nbytes = size * m * kk + size * live * kk * n + 4 * m * n + 4 * len(host_sizes)
    ops = 2 * m * kk * n
    row = kernel_row(err, kms, pms, nbytes, ops, "f32" if size == 4 else "bf16", lms)
    lib = "—" if lms is None else f"{lms:.4f} ms"
    print(f"{what}: kernel {kms:.4f} ms = {ops / kms / 1e9:.1f} TFLOP/s, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} = share "
          f"{row['bound_ms'] / kms:.3f}, plain {pms:.4f} ms, library "
          f"(torch._grouped_mm) {lib}; max abs err {err:.3e} [{CARD}]")
    return kms, pms, lms, nbytes, ops, row


def check_gmm_kernels(dev, g, detail: dict) -> dict:
    """Phase 3, gmm over GMM_CASES against gmm_plain (within GMM_REL of max
    |out|) and a bitwise second launch; the timed cases beside the plain
    version, the library call (``torch._grouped_mm``, which writes bf16
    where the kernel writes f32; the port never calls it) and the bound
    (each input read once: lhs, the weights of the groups that have rows,
    the sizes; the f32 output written once). Returns {"gmm": row}: one
    Mixtral layer's three products at M 4096 (gate, up, down of the
    2048-token forward)."""
    import torch
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    from pygpukit_tpu_torch.kernels.gmm import gmm_route
    keys = ("ms", "plain_ms", "lib_ms", "bytes", "ops")
    layer = dict.fromkeys(keys, 0.0)
    err_all = 0.0
    for name, tokens, k, kk, n, n_groups, sizes, timed in GMM_CASES:
        dt = torch.float32 if name.startswith("f32") else torch.bfloat16
        gs = (gmm_sizes(dev, g, tokens, k, n_groups) if sizes is None
              else torch.tensor(sizes, dtype=torch.int32, device=dev))
        host_sizes = gs.tolist()
        m = sum(host_sizes)
        lhs = torch.randn((m, kk), generator=g, device=dev).to(dt)
        rhs = torch.empty((n_groups, kk, n), dtype=dt, device=dev)
        for i in range(n_groups):
            rhs[i] = torch.randn((kk, n), generator=g, device=dev) * 0.02
        out, ref = gmm(lhs, rhs, gs), gmm_plain(lhs, rhs, host_sizes)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        route = gmm_route(lhs.dtype, rhs.dtype, kk, n)
        what = f"gmm {name} ({route} route, M {m}, K {kk}, N {n}, G {n_groups})"
        check(err <= GMM_REL * ref.abs().max().item(), f"{what}: max abs err {err}")
        check(torch.equal(out, gmm(lhs, rhs, gs)), f"{what}: a second launch differs")
        err_all = max(err_all, err)
        del out, ref
        if timed:
            kms, pms, lms, nbytes, ops, row = gmm_timed(lhs, rhs, gs, host_sizes, err,
                                                        f"phase 3: {what}")
            detail[f"gmm_{name}"] = dict(row, share=row["bound_ms"] / kms, M=m,
                                         tflops=ops / kms / 1e9)
            if name.endswith("M4096"):               # gate and up, or down
                for key, v in zip(keys, (kms, pms, lms, nbytes, ops)):
                    layer[key] += v * (2 if name.startswith("gate_up") else 1)
        del lhs, rhs
    torch.cuda.empty_cache()
    return {"gmm": kernel_row(err_all, layer["ms"], layer["plain_ms"], layer["bytes"],
                              layer["ops"], "bf16", layer["lib_ms"])}


def build_model(cfg, seed: int, dev, mode: str | None = "int4", base=None):
    """The model of ``cfg`` with random bf16 weights from ``seed`` (or the
    dense tree ``base``), quantized with ``mode`` (None keeps bf16) and
    fused, as bench.py:198-202 builds its decode models."""
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, fuse_params,
                                        init_params, quantize_model_params)
    params = base if base is not None else init_params(cfg, seed, torch.bfloat16, dev)
    if mode is not None:
        params = quantize_model_params(params, mode)
    return CausalTransformerModel(cfg, fuse_params(params), dtype=torch.bfloat16)


def serve(model, requests, n_steps: int, warm=(), max_seq_len: int = 1024,
          prewarm: bool = False, warm_plan=None, **kw):
    """A batch-8 engine over ``requests`` [(prompt, max_new)], timed; any
    ``warm`` requests are served first, untimed, after warmup() (which
    captures the engine's programs); ``prewarm`` runs warmup() for the
    requests' prompt lengths, untimed, or, given ``warm_plan`` [(prompt
    lengths, wave sizes)], one warmup() an entry. Returns (engine, the
    timed requests, seconds)."""
    import torch
    from pygpukit_tpu_torch.llm import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch=8, max_seq_len=max_seq_len,
                                   steps_per_dispatch=n_steps, **kw)
    if prewarm and warm_plan is not None:
        for lens, waves in warm_plan:
            eng.warmup(prompt_lens=lens, wave_sizes=waves)
    elif prewarm:
        eng.warmup(prompt_lens=sorted({len(p) for p, _ in requests}))
    if warm:
        eng.warmup(prompt_lens=sorted({len(p) for p, _ in warm}))
        for p, m in warm:
            eng.submit(p, max_new_tokens=m)
        eng.run_until_complete()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
    eng.run_until_complete()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def decode_step_times(model, b: int, max_len: int, pos: int, profile: bool = True) -> tuple:
    """(eager wall ms, graph-replayed device ms, kernel profile, launches
    of one step) of one decode step of ``model`` with every slot at
    position ``pos``: how much of the eager step is the device's work and
    how much host launch cost. b > 1: the batch-rows step over ``[b, L,
    max_len, Hk*D]`` pools of the model's KV storage; b = 1: the single-stream step
    (``decode_step_fn``) over ``[L, max_len, Hk, D]`` caches, fused under
    PYGPUKIT_DECODE=fused for an eligible model."""
    import torch
    from pygpukit_tpu_torch.llm import batch_decode_step_fn, decode_step_fn
    from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
    cfg, params, dev = model.config, model.params, model.device
    toks = torch.arange(1, b + 1, device=dev)
    if b == 1:
        shape = (cfg.num_layers, max_len, cfg.num_kv_heads, cfg.head_dim)
        kc = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=False)
        vc = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=False)

        def step(_):
            decode_step_fn(cfg, params, kc, vc, toks, pos)
        return (eager_ms(step, 1, iters=20), time_ms(step, 1, reps=20),
                kernel_profile(step), step_launches(step))
    shape = (b, cfg.num_layers, max_len, cfg.num_kv_heads * cfg.head_dim)
    kp = kv_cache_zeros(shape, model.kv_dtype, device=dev)
    vp = kv_cache_zeros(shape, model.kv_dtype, device=dev)
    poss = torch.full((b,), pos, dtype=torch.int32, device=dev)

    def step(_):
        batch_decode_step_fn(cfg, params, kp, vp, toks, poss)
    return (eager_ms(step, 1, iters=20), time_ms(step, 1, reps=20),
            kernel_profile(step) if profile else [], step_launches(step))


def paged_step_times(model, dev) -> tuple:
    """One batch-8 paged decode step at the paged path's shape (MAX 512,
    block 16, every slot at position 143 on its own blocks): eager wall ms,
    graph-replayed device ms, the profiler's kernels by device time over
    three eager steps [(name, calls, device ms per step)], and the launches
    of one step."""
    import torch
    from pygpukit_tpu_torch.llm import paged_decode_step_fn
    cfg, params = model.config, model.params
    mb, bs, b = 32, 16, 8
    shape = (cfg.num_layers, b * mb + 2, cfg.num_kv_heads, bs, cfg.head_dim)
    kp = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    tables = (torch.arange(b * mb, dtype=torch.int32, device=dev) + 1).reshape(b, mb)
    toks = torch.arange(1, b + 1, device=dev)
    poss = torch.full((b,), 143, dtype=torch.int32, device=dev)

    def step(_):
        paged_decode_step_fn(cfg, params, kp, vp, tables, toks, poss)
    return (eager_ms(step, 1, iters=20), time_ms(step, 1, reps=20), kernel_profile(step),
            step_launches(step))


def kernel_profile(step, n: int = 3) -> list:
    """torch.profiler over ``n`` eager calls of ``step(0)``: the kernels by
    device time [(name, calls, device ms per call of step)], largest first."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(n):
            step(0)
        torch.cuda.synchronize()
    # kernel events only: a CPU op's row repeats the device time of the
    # kernels it launched
    return sorted(((e.key, e.count // n, e.self_device_time_total / (n * 1e3))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[2])


def profile_line(rows: list, top: int) -> str:
    busy = sum(r[2] for r in rows)
    return (f"profiler: {busy:.3f} ms of kernels per eager step, the largest: "
            + "; ".join(f"{name[:60]} x{n} {ms:.3f} ms" for name, n, ms in rows[:top]))


def serve_again(eng, requests, warm=()):
    """``requests`` served again by ``eng`` from the state serve() gives a
    new engine, its captured programs kept: the pools, the last tokens and
    positions (host and device) and the paged tables zeroed in place and a
    fresh block allocator (blocks go out in a new engine's order); any
    ``warm`` requests first, untimed. Returns (the timed requests,
    seconds)."""
    import torch
    for cache in (eng.k_cache, eng.v_cache):
        for t in (cache.values() if isinstance(cache, dict) else (cache,)):
            t.zero_()
    eng._last_tokens[:] = 0
    eng._poss[:] = 0
    if eng.pipelined:
        eng._last_dev.zero_()
        eng._poss_dev.zero_()
    if eng.paged:
        eng._alloc = type(eng._alloc)(eng._alloc.num_blocks, eng.block_size)
        eng._tables_np[:] = 0
        eng._tables_dev.zero_()
    for p, m in warm:
        eng.submit(p, max_new_tokens=m)
    eng.run_until_complete()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
    eng.run_until_complete()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def pool_copy(eng, device=None) -> list:
    """Bitwise copies of the engine's K and V pools, on ``device`` (theirs
    unless named)."""
    return [bits(t).to(device or t.device, copy=True) for cache in (eng.k_cache, eng.v_cache)
            for t in (cache.values() if isinstance(cache, dict) else (cache,))]


# engine pools past this many bytes are copied to the host for the replay
# check: Phi-3.5's dense pools at MAX 8192 are 26 GB, and two device copies
# beside them would not fit the card
POOL_HOST_BYTES = 8 << 30


def pools_equal(copies: list, eng, trash: bool = False) -> bool:
    """The engine's live pools bitwise ``copies`` (``pool_copy``'s), a
    slice of the leading dimension at a time on the copies' device;
    ``trash``: paged pools compared outside block 0 (``tree_equal``)."""
    import torch
    live = [bits(t) for cache in (eng.k_cache, eng.v_cache)
            for t in (cache.values() if isinstance(cache, dict) else (cache,))]
    for a, b in zip(copies, live):
        if a.shape != b.shape:
            return False
        for i in range(a.shape[0]):
            x, y = a[i], b[i].to(a.device)
            if not torch.equal(x[1:] if trash else x, y[1:] if trash else y):
                return False
    return True


def ttft_ms(reqs) -> "np.ndarray":
    import numpy as np
    return np.percentile([r.ttft_s for r in reqs], [50, 95]) * 1e3


def check_served(eng, reqs, requests, what: str) -> int:
    """Every request finished with its token count and every logit was
    finite; returns the tokens generated."""
    for r, (_, m) in zip(reqs, requests):
        check(r.done and len(r.generated) == m,
              f"{what}: request {r.request_id} has {len(r.generated)} of {m} tokens")
    check(eng.logits_finite(), f"{what}: a logit went non-finite")
    return sum(len(r.generated) for r in reqs)


def dense_requests(cfg, rng) -> list:
    """The dense path's workload: 16 requests, 16- and 200-token prompts,
    48-64 new tokens."""
    return [(rng.integers(1, cfg.vocab_size, 16 if i % 2 == 0 else 200).tolist(),
             48 + (i * 5) % 17) for i in range(16)]


def engine_replay(model, requests, kernels, what: str, phases=("4", "5")) -> dict:
    """The batch-8 engine over ``requests`` twice, its programs captured by
    warmup() before the first timed run: every request finishes, every
    kernel of ``kernels`` launches (cost_analysis x replays), the second
    run (serve_again: the same programs replayed from a zeroed state) gives
    the same streams and bitwise the same KV pools; then two requests
    through single-stream generate (reported). Returns the first run's
    launches."""
    import torch
    reset_counts()
    eng1, reqs1, secs1 = serve(model, requests, 16, prewarm=True)
    launches = launch_counts()
    reset_counts()
    n_tok = check_served(eng1, reqs1, requests, what)
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was never launched on the {what}")
    ttft = ttft_ms(reqs1)
    print(f"phase {phases[0]}: {what}: served {len(reqs1)} requests, {n_tok} tokens "
          f"in {secs1:.3f} s = {n_tok / secs1:.1f} tok/s (steps {eng1.stats.steps}, "
          f"prefills {eng1.stats.prefills}), TTFT p50/p95 {ttft[0]:.1f}/"
          f"{ttft[1]:.1f} ms; launches {json.dumps(launches)}")

    pools = pool_copy(eng1)
    reqs2, secs2 = serve_again(eng1, requests)
    check([r.generated for r in reqs1] == [r.generated for r in reqs2],
          f"{what}, second run: token streams differ")
    check(all(torch.equal(a, b) for a, b in zip(pools, pool_copy(eng1))),
          f"{what}, second run: KV pools differ")
    print(f"phase {phases[1]}: {what}: replay identical (streams and pools); second "
          f"run {n_tok / secs2:.1f} tok/s")
    del eng1, pools
    # B = 1 runs the same kernels, but torch's own reductions (norms) may
    # sum in another order at another batch size, so this is reported, not
    # required; the checked reference is the CPU plain path (cpu_parity).
    for idx in (0, 1):
        model.init_fixed_cache(1024)
        single = model.generate(requests[idx][0], max_new_tokens=requests[idx][1])
        same = sum(a == b for a, b in zip(single, reqs1[idx].generated))
        print(f"phase {phases[1]}: {what}: single-stream generate vs engine, request "
              f"{idx}: {same}/{len(single)} tokens equal")
    return launches


def dense_path(model, requests, per_step: dict) -> dict:
    """Phases 4-6 (the dense path on the int4 model); returns its launch
    counts and records its per-step launches in ``per_step``."""
    launches = engine_replay(model, requests, DENSE_KERNELS, "dense path")
    check(launches["kv_rows_write"] == 0, "kv_rows_write's own kernel ran on the dense path, "
          "whose rows the attention's pass one writes")
    eager, graph, prof, counts = decode_step_times(model, 8, 1024, 300)
    for name, n in counts.items():
        per_step[name] = (n, "batch-8 decode step")
    model.init_fixed_cache(1024)
    counts = step_launches(lambda _: model.prefill(requests[1][0]))
    per_step["w4a8_gemm"] = (counts.get("w4a8_gemm", 0),
                             f"{len(requests[1][0])}-token prefill")
    print(f"phase 6: batch-8 decode step at context 301: eager {eager:.3f} ms "
          f"wall, CUDA-graph replay {graph:.3f} ms device; device busy "
          f"{graph / eager:.3f} of the eager step; " + profile_line(prof, 6))
    # the w4a8 GEMM's share of a prefill's device time (profiler, eager)
    prof = kernel_profile(lambda _: model.prefill(requests[1][0]), n=2)
    busy = sum(r[2] for r in prof)
    gemm_ms = sum(r[2] for r in prof if "w4a8_gemm_kernel" in r[0])
    quant_ms = sum(r[2] for r in prof if "act_quant" in r[0])
    print(f"phase 6: {len(requests[1][0])}-token prefill: {busy:.3f} ms of kernels, "
          f"w4a8_gemm {gemm_ms:.3f} ms ({gemm_ms / busy:.3f} of it) and its activation "
          f"quantization {quant_ms:.3f} ms; " + profile_line(prof, 6) + f" [{CARD}]")
    return launches


def streamed_bytes(params: dict) -> int:
    """Bytes one decode step streams: every layer leaf (weights, scales,
    norms) and the head. The embedding table is left out, where
    bench.py:218-220 counts it: a step reads one row of it."""
    import torch
    total = 0
    for leaf in [params["layers"], params.get("lm_head")]:
        stack = [leaf]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            elif isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def ladder_rung(model, rung: str, card: str, per_step: dict, step_ms: dict) -> dict:
    """One rung of the decode ladder (the reference's bench_decode,
    bench.py:172-253): a warm generate of LADDER_WARM tokens and a timed
    one of LADDER_NEW after a 16-token prompt, cache LADDER_MAX, chunks of
    GEN_CHUNK (the warm run captures them, the timed run replays).
    Checks that the timed run starts with the warm run's tokens, finite
    logits and the GEMV launches of the timed run's decode
    (88 per step for the rung's GEMV, none for any other). Returns the
    timed run's launches; records the graph-replayed step's device ms in
    ``step_ms``."""
    import os
    import torch
    _, switches, gemv = LADDER[rung]
    saved = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        runs = []
        model.init_fixed_cache(LADDER_MAX)     # programs captured under this rung's switches
        for n_new in (LADDER_WARM, LADDER_NEW):
            zero_cache(model, LADDER_MAX)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            toks = model.generate(LADDER_PROMPT, max_new_tokens=n_new,
                                  chunk_size=GEN_CHUNK)
            torch.cuda.synchronize()
            runs.append((toks, time.perf_counter() - t0, launch_counts(),
                         model.logits_finite()))
        eager, graph, prof, counts = decode_step_times(
            model, 1, LADDER_MAX, len(LADDER_PROMPT) + LADDER_NEW // 2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    step_ms[rung] = graph
    (toks1, _, _, fin1), (toks2, secs, launches, fin2) = runs
    check(len(toks2) == LADDER_NEW, f"ladder {rung}: {len(toks2)} tokens")
    check(toks1 == toks2[:LADDER_WARM],
          f"ladder {rung}: the timed run's tokens differ from the warm run's")
    check(fin1 and fin2, f"ladder {rung}: a logit went non-finite")
    steps = LADDER_NEW - 1
    projections = 4 * model.config.num_layers
    for name in GEMVS:
        want = projections * steps if name == gemv else 0
        check(launches[name] == want, f"ladder {rung}: {name} launched "
              f"{launches[name]} times in decode, expected {want}")
    if gemv is not None:
        per_step.setdefault(gemv, (counts.get(gemv, 0), "single-stream decode step"))
    nbytes = streamed_bytes(model.params)
    print(f"phase 9: ladder {rung}: {LADDER_NEW / secs:.1f} tok/s (generate replays its prefill and chunks); one decode step "
          f"eager {eager:.3f} ms wall, CUDA-graph replay {graph:.3f} ms device; "
          f"{nbytes / 1e9:.4f} GB streamed per step = {nbytes / graph / 1e6:.1f} GB/s "
          f"on the device; GEMV launches {json.dumps({g: launches[g] for g in GEMVS})} "
          f"({projections} per step x {steps} steps for {gemv}); [{card}]")
    print(f"phase 9: ladder {rung}: " + profile_line(prof, 6))
    return launches


def ladder(cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 9: the decode ladder on the 1.1B model at full width and
    depth, one bf16 weight tree (seed 0) quantized per rung. Returns each
    ladder GEMV's launches from its rung's timed run."""
    import torch
    from pygpukit_tpu_torch.llm import init_params
    base = init_params(cfg, 0, torch.bfloat16, dev)
    launches: dict = {}
    step_ms: dict = {}
    model, model_mode = None, "none yet"
    for rung, (mode, _, gemv) in LADDER.items():
        if mode != model_mode:              # rungs of one mode share a model
            model = None
            torch.cuda.empty_cache()
            model, model_mode = build_model(cfg, 0, dev, mode, base=base), mode
        got = ladder_rung(model, rung, card, per_step, step_ms)
        if gemv is not None:
            launches[gemv] = got[gemv]
    print(f"phase 9: one decode step by CUDA-graph replay, device ms: fp8 "
          f"{step_ms['fp8']:.3f} (conv_gemv), bf16 {step_ms['bf16']:.3f} (cuBLAS), int4 "
          f"{step_ms['int4']:.3f} (w4a8_gemv), int4 w4a16 {step_ms['int4 w4a16']:.3f} "
          f"(w4a16_gemv), int4_block {step_ms['int4_block']:.3f}, "
          f"int4_block w4a16 {step_ms['int4_block w4a16']:.3f} (block_w4a16_gemv) [{card}]")
    del model, base
    torch.cuda.empty_cache()
    return launches


def paged_path(model, cfg, rng, per_step: dict) -> dict:
    """Phase 7, the reference's serving_1b_int4_paged row; returns the
    launch counts of its first run (warmup, warm-up and timed requests)."""
    import torch
    kw = dict(warm=[(rng.integers(1, cfg.vocab_size, 16).tolist(), 128)
                    for _ in range(8)], max_seq_len=512)
    paged = dict(kw, paged=True, block_size=16)
    requests = [(rng.integers(1, cfg.vocab_size, 16).tolist(), 128) for _ in range(32)]
    reset_counts()
    eng1, reqs1, secs1 = serve(model, requests, 128, pipelined=True, **paged)
    launches = launch_counts()
    reset_counts()
    n_tok = check_served(eng1, reqs1, requests, "paged path")
    for name in PAGED_KERNELS:
        check(launches[name] > 0, f"kernel {name} was never launched on the paged path")
    for name in ("batch_decode_attention", "kv_rows_write", "kv_rows_write_fused"):
        check(launches[name] == 0, f"dense kernel {name} ran on the paged path")
    ttft = ttft_ms(reqs1)
    print(f"phase 7: paged pipelined engine (MAX 512, block 16, 128 steps per "
          f"dispatch): 32 requests, {n_tok} tokens in {secs1:.3f} s = "
          f"{n_tok / secs1:.1f} tok/s (steps {eng1.stats.steps}, prefills "
          f"{eng1.stats.prefills}), TTFT p50/p95 {ttft[0]:.1f}/{ttft[1]:.1f} ms; "
          f"launches {json.dumps(launches)}")
    streams = [r.generated for r in reqs1]
    # block 0 is the trash: unordered duplicate writes
    live = [t[:, 1:].clone() for t in pool_copy(eng1)]
    reqs2, secs2 = serve_again(eng1, requests, warm=kw["warm"])
    check([r.generated for r in reqs2] == streams, "paged replay: token streams differ")
    check(all(torch.equal(x, y[:, 1:]) for x, y in zip(live, pool_copy(eng1))),
          "paged replay: pools differ outside the trash block")
    del eng1, live
    eng3, reqs3, secs3 = serve(model, requests, CROSS_STEPS, pipelined=False, **paged)
    check([r.generated for r in reqs3] == streams,
          "paged engine, not pipelined: token streams differ")
    del eng3
    dense = requests[:DENSE_COMPARED]
    eng4, reqs4, secs4 = serve(model, dense, CROSS_STEPS, pipelined=True, **kw)
    dense_same = sum(r.generated == t for r, t in zip(reqs4, streams))
    del eng4
    eager, graph, rows, counts = paged_step_times(model, model.device)
    per_step["paged_attention"] = (counts.get("paged_attention", 0),
                                   "batch-8 paged decode step")
    print(f"phase 7: batch-8 paged decode step at context 144: eager {eager:.3f} ms "
          f"wall, CUDA-graph replay {graph:.3f} ms device; device busy "
          f"{graph / eager:.3f} of the eager step; " + profile_line(rows, 8))
    print(f"phase 7: replay identical (streams; pools outside block 0), "
          f"{n_tok / secs2:.1f} tok/s; not pipelined ({CROSS_STEPS} steps a dispatch): "
          f"identical streams, {n_tok / secs3:.1f} tok/s; dense pipelined (MAX 512, "
          f"{CROSS_STEPS} steps): "
          f"{dense_same}/{DENSE_COMPARED} streams identical, "
          f"{sum(len(r.generated) for r in reqs4) / secs4:.1f} tok/s")
    return launches


def tight_pool(model, cfg, rng) -> None:
    """Phase 8: more requests than the pool holds; admission must wait."""
    import torch
    from pygpukit_tpu_torch.llm import ContinuousBatchingEngine
    bs, max_len = 16, 512
    requests = [(rng.integers(1, cfg.vocab_size, 16 if i % 2 == 0 else 200).tolist(),
                 int(rng.integers(48, 65))) for i in range(16)]
    needs = sorted(-(-min(len(p) + m + 1, max_len) // bs) for p, m in requests)
    num_blocks = sum(needs[:4]) + 1       # any five need more; block 0 is trash
    eng = ContinuousBatchingEngine(model, max_batch=8, max_seq_len=max_len,
                                   steps_per_dispatch=16, pipelined=True,
                                   paged=True, block_size=bs, num_blocks=num_blocks)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
    most = waits = iters = 0
    while eng.has_work:
        eng.step()
        iters += 1
        active = sum(r is not None for r in eng._slots)
        most = max(most, active)
        waits += bool(eng._queue) and active < eng.max_batch
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_tok = check_served(eng, reqs, requests, "tight pool")
    check(most <= 4, f"tight pool: {most} requests held blocks at once")
    check(waits > 0, "tight pool: admission never waited for blocks")
    check(eng._alloc.free_blocks == num_blocks - 1,
          f"tight pool: {eng._alloc.free_blocks} of {num_blocks - 1} blocks free")
    print(f"phase 8: tight pool of {num_blocks} blocks (needs {needs}): 16 requests, "
          f"{n_tok} tokens in {secs:.3f} s, at most {most} at once, admission "
          f"waited in {waits} of {iters} engine steps ({eng.stats.steps} chunks), "
          f"all blocks free at the end")


def cpu_parity(cfg, dev, prompt, mode: str = "int4", phase: str = "5") -> None:
    """A two-layer full-width ``mode`` model on the card against the plain
    path on the CPU (relative L2 of the logits)."""
    from pygpukit_tpu_torch.llm import TransformerConfig
    small = TransformerConfig(**{**cfg.__dict__, "num_layers": 2})
    card_model = build_model(small, 1, dev, mode)
    cpu_model = build_model(small, 1, dev, mode).to("cpu")
    rel_l2s, max_rel, same_tok = [], 0.0, 0
    for m in (card_model, cpu_model):
        m.init_fixed_cache(64)
    lc, lr = card_model.prefill(prompt), cpu_model.prefill(prompt)
    for step in range(5):
        lc = lc.cpu()
        rel_l2s.append(((lc - lr).norm() / lr.norm()).item())
        max_rel = max(max_rel, ((lc - lr).abs().max() / lr.abs().max()).item())
        tok = int(lc.argmax())
        same_tok += int(tok == int(lr.argmax()))
        lc, lr = card_model.decode_step(tok), cpu_model.decode_step(tok)
    check(max(rel_l2s) <= REF_TOL,
          f"{mode} card vs CPU plain logits: relative L2 {max(rel_l2s):.3e}")
    print(f"phase {phase}: 2-layer {mode} card logits vs CPU plain path, relative L2 "
          f"at prefill and 4 decode steps {[f'{e:.2e}' for e in rel_l2s]} (limit "
          f"{REF_TOL}), max abs {max_rel:.3e} of max |logit|, greedy token "
          f"equal {same_tok}/5")


def block_engine(cfg, dev, requests) -> dict:
    """Phase 10: the dense path's workload on the int4_block model (w4a8
    block GEMV) with the batch-8 engine, replayed; returns its launches."""
    import torch
    model = build_model(cfg, 0, dev, "int4_block")
    launches = engine_replay(model, requests, ("block_w4a8_gemv", "kv_rows_write_fused",
                                               "batch_decode_attention"),
                             "int4_block engine", phases=("10", "10"))
    eager, graph, prof, _ = decode_step_times(model, 8, 1024, 300)
    print(f"phase 10: int4_block batch-8 decode step at context 301: eager {eager:.3f} ms "
          f"wall, CUDA-graph replay {graph:.3f} ms device; " + profile_line(prof, 6)
          + f" [{CARD}]")
    del model
    torch.cuda.empty_cache()
    cpu_parity(cfg, dev, requests[0][0], "int4_block", phase="10")
    return launches


def forward_flops(cfg, s_len: int) -> float:
    """2 * (matmul weight parameters) * S plus the causal attention's 4 Hq D
    S(S+1)/2 per layer."""
    e, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = e * (hq + 2 * hk) * d + hq * d * e + 3 * e * inter
    weights = cfg.num_layers * per_layer + e * v
    return 2 * weights * s_len + cfg.num_layers * 4 * hq * d * s_len * (s_len + 1) / 2


def forward_phase(cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 11: the uncached forward on the 1.1B bf16 model. Returns the
    launches of its main-path run (get_logits on FWD_S tokens)."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import forward_fn
    t0 = time.perf_counter()
    model = build_model(cfg, 0, dev, None)
    ids = np.random.default_rng(11).integers(1, cfg.vocab_size, FWD_S).tolist()
    torch.cuda.synchronize()
    reset_counts()
    logits = model.get_logits(ids)
    launches = launch_counts()
    reset_counts()
    check(logits.shape == (FWD_S, cfg.vocab_size), f"forward: logits {logits.shape}")
    check(bool(np.isfinite(logits).all()), "forward: a logit is not finite")
    want = cfg.num_layers
    check(launches["flash_attention"] == want,
          f"forward: flash_attention launched {launches['flash_attention']} times, "
          f"expected {want}")
    others = {k: n for k, n in launches.items() if k != "flash_attention" and n}
    check(not others, f"forward: other kernels launched {others}")
    per_step["flash_attention"] = (want, f"one {FWD_S}-token forward")
    again = model.get_logits(ids)
    check(np.array_equal(logits.view(np.uint32), again.view(np.uint32)),
          "forward: a second call's logits differ")
    del again

    tokens = torch.tensor(ids, device=dev)

    def fwd(_):
        forward_fn(cfg, model.params, tokens)
    fwd(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        fwd(0)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 3
    graph = time_ms(fwd, 1, reps=3)
    prof = kernel_profile(fwd, n=2)
    flops = forward_flops(cfg, FWD_S)
    print(f"phase 11: forward of {FWD_S} tokens: {ms:.3f} ms (CUDA events, eager) = "
          f"{FWD_S / ms * 1e3:.0f} tok/s, {flops / 1e12:.3f} TFLOP = "
          f"{flops / (ms * 1e-3) / PEAK_OPS_S['bf16']:.4f} of "
          f"{PEAK_OPS_S['bf16'] / 1e12:.0f} TFLOP/s; graph "
          f"replay {graph:.3f} ms device; shape {logits.shape}, finite, launches "
          f"{json.dumps({k: n for k, n in launches.items() if n})}, second call "
          f"bitwise equal; [{card}]")
    print("phase 11: " + profile_line(prof, 8))

    model.init_fixed_cache(FWD_S)
    pre = model.prefill(ids).cpu().numpy()
    rel = float(np.linalg.norm(logits[-1] - pre) / np.linalg.norm(pre))
    print(f"phase 11: forward's last row vs cached prefill (plain f32 softmax): "
          f"relative L2 {rel:.3e}, argmax equal {int(logits[-1].argmax() == pre.argmax())}")
    del logits, pre

    prompt = ids[:FWD_PROMPT]
    reset_counts()
    gen1 = model.generate(prompt, max_new_tokens=FWD_NEW, use_cache=False)
    gen_launches = launch_counts()
    gen2 = model.generate(prompt, max_new_tokens=FWD_NEW, use_cache=False)
    check(len(gen1) == FWD_NEW and gen1 == gen2,
          f"uncached generate: {gen1} then {gen2}")
    check(gen_launches["flash_attention"] == want * FWD_NEW,
          f"uncached generate: flash_attention launched "
          f"{gen_launches['flash_attention']} times, expected {want * FWD_NEW}")
    model.init_fixed_cache(64)
    cached = model.generate(prompt, max_new_tokens=FWD_NEW)
    same = sum(a == b for a, b in zip(gen1, cached))
    print(f"phase 11: uncached greedy generate, {FWD_NEW} tokens after a {FWD_PROMPT}-"
          f"token prompt: replay identical, flash_attention launched "
          f"{gen_launches['flash_attention']} times; cached generate equal in "
          f"{same}/{FWD_NEW} tokens")
    del model
    torch.cuda.empty_cache()
    forward_cpu_parity(cfg, dev)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches


def forward_cpu_parity(cfg, dev) -> None:
    """A two-layer full-width bf16 model's forward on the card (the
    flash_attention kernel) against the CPU plain forward (the chunked
    route past S 512), relative L2 of the logits within FWD_TOL."""
    import numpy as np
    from pygpukit_tpu_torch.llm import TransformerConfig
    small = TransformerConfig(**{**cfg.__dict__, "num_layers": 2})
    card_model = build_model(small, 1, dev, None)
    cpu_model = build_model(small, 1, dev, None).to("cpu")
    s_len = FWD_PARITY_S
    ids = np.random.default_rng(12).integers(1, cfg.vocab_size, s_len).tolist()
    lc, lr = card_model.get_logits(ids), cpu_model.get_logits(ids)
    rel = float(np.linalg.norm(lc - lr) / np.linalg.norm(lr))
    top = float((lc.argmax(-1) == lr.argmax(-1)).mean())
    check(rel <= FWD_TOL, f"2-layer bf16 forward, card vs CPU: relative L2 {rel:.3e}")
    print(f"phase 11: 2-layer bf16 forward of {s_len} tokens, card vs CPU plain "
          f"forward: relative L2 {rel:.3e} (limit {FWD_TOL}), max abs "
          f"{np.abs(lc - lr).max() / np.abs(lr).max():.3e} of max |logit|, argmax "
          f"equal in {top:.4f} of rows")


def array_layer(gp, cfg, x, w: dict, cos, sin):
    """One pre-norm decoder layer written with Array ops: rmsnorm, a matmul
    per projection, rope_inplace, flash_attention, add, swiglu."""
    s, hq, hk, d = x.shape[0], cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = gp.rmsnorm(x, w["attn_norm_w"], cfg.norm_eps)
    q = gp.matmul(y, w["w_q"]).reshape(s, hq, d)
    k = gp.matmul(y, w["w_k"]).reshape(s, hk, d)
    v = gp.matmul(y, w["w_v"]).reshape(s, hk, d)
    gp.rope_inplace(q, k, cos, sin)
    h = gp.add(x, gp.matmul(gp.flash_attention(q, k, v).reshape(s, hq * d), w["w_o"]))
    y = gp.rmsnorm(h, w["mlp_norm_w"], cfg.norm_eps)
    return gp.add(h, gp.matmul(gp.swiglu(gp.matmul(y, w["w_gate"]), gp.matmul(y, w["w_up"])),
                               w["w_down"]))


def ops_phase(cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 12, the Array API. Returns the launches of its main-path runs:
    gemm from the layer (a), gemv_quant and kv_rows_write from their library
    calls (c)."""
    import os
    import torch
    import pygpukit_tpu_torch as gp
    from pygpukit_tpu_torch.kernels import gemv_quant, kv_rows_write_plain
    from pygpukit_tpu_torch.llm import init_params
    from pygpukit_tpu_torch.llm.model import _slice_layer_params, layer_stack_fn
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.bfloat16, dev)
    layers = {name: leaf[:1] for name, leaf in params["layers"].items()}     # layer 0
    del params
    w = {name: gp.Array(t) for name, t in _slice_layer_params(layers, 0).items()}
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    h = torch.randn((FWD_S, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    cos, sin = gp.rope_init(cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta)
    check(cos.device == dev, f"rope_init with no device named: {cos.device}")

    def layer(_=None):
        return array_layer(gp, cfg, gp.Array(h), w, cos, sin)

    saved = os.environ.get("PYGPUKIT_GEMM")
    os.environ["PYGPUKIT_GEMM"] = "pallas"
    try:
        torch.cuda.synchronize()
        reset_counts()
        out = layer()
        torch.cuda.synchronize()
        launches = launch_counts()
        reset_counts()
        again = layer()
        kernel_layer_ms = time_ms(layer, 1, reps=10)
    finally:
        if saved is None:
            os.environ.pop("PYGPUKIT_GEMM", None)
        else:
            os.environ["PYGPUKIT_GEMM"] = saved
    n_proj = 7                                   # q, k, v, o, gate, up, down
    check(launches["gemm"] == n_proj, f"ops layer: gemm launched {launches['gemm']} "
          f"times, expected {n_proj}")
    check(launches["flash_attention"] == 1, "ops layer: flash_attention launched "
          f"{launches['flash_attention']} times, expected 1")
    others = {k: n for k, n in launches.items() if k not in ("gemm", "flash_attention") and n}
    check(not others, f"ops layer: other kernels launched {others}")
    check(torch.equal(out.torch, again.torch), "ops layer: a second call differs")
    ref = layer_stack_fn(cfg, layers, h, cos.torch, sin.torch)
    rel = ((out.torch.float() - ref.float()).norm() / ref.float().norm()).item()
    check(out.shape == tuple(ref.shape) and bool(torch.isfinite(out.torch).all()),
          f"ops layer: shape {out.shape} or a value not finite")
    check(rel <= FWD_TOL, f"ops layer vs the model's layer: relative L2 {rel:.3e}")
    model_layer_ms = time_ms(lambda _: layer_stack_fn(cfg, layers, h, cos.torch, sin.torch),
                             1, reps=10)
    per_step["gemm"] = (n_proj, f"one Array-API 1.1B layer on {FWD_S} rows "
                        "under PYGPUKIT_GEMM=pallas")
    print(f"phase 12: 1.1B layer 0 through the Array API on {FWD_S} rows: relative L2 "
          f"{rel:.3e} against the model's layer (limit {FWD_TOL}), launches "
          f"{json.dumps({k: n for k, n in launches.items() if n})}, second call bitwise "
          f"equal; graph replay {kernel_layer_ms:.3f} ms device (the model's layer, cuBLAS "
          f"projections: {model_layer_ms:.3f} ms); [{card}]")
    del out, again, ref, layers, w

    n = GEMM_BENCH_N
    a, b = gp.randn(n, n, dtype="bf16", seed=1), gp.randn(n, n, dtype="bf16", seed=2)
    os.environ["PYGPUKIT_GEMM"] = "pallas"
    try:
        ck = gp.matmul(a, b)
        k_ms = time_ms(lambda _: gp.matmul(a, b), 1, reps=5)
    finally:
        if saved is None:
            os.environ.pop("PYGPUKIT_GEMM", None)
        else:
            os.environ["PYGPUKIT_GEMM"] = saved
    cc = gp.matmul(a, b)
    c_ms = time_ms(lambda _: gp.matmul(a, b), 1, reps=5)
    err = _bf16_err(ck.torch, cc.torch, f"ops bf16 {n}^3: kernel vs cuBLAS")
    flops = 2.0 * n ** 3
    del a, b, ck, cc
    m, k, nn = QUANT_MKN
    qa, sa = gp.ops.quantize_fp8(gp.randn(m, k, seed=3))
    qb, sb = gp.ops.quantize_fp8(gp.randn(k, nn, seed=4))
    y = gp.matmul_fp8(qa, qb, sa, sb)
    check(y.shape == (m, nn) and y.dtype.name == "bfloat16"
          and bool(torch.isfinite(y.torch).all()), "ops fp8 GEMM: shape, dtype or finite")
    fp8_ms = time_ms(lambda _: gp.matmul_fp8(qa, qb, sa, sb), 1, reps=3)
    del qa, qb, y
    gi = torch.Generator(device=dev)
    gi.manual_seed(5)
    ia = torch.randint(-127, 128, (m, k), generator=gi, device=dev, dtype=torch.int8)
    ib = torch.randint(-127, 128, (k, nn), generator=gi, device=dev, dtype=torch.int8)
    ones_a, ones_b = gp.ones((m, 1)), gp.ones((1, nn))
    y = gp.matmul_int8(gp.Array(ia), gp.Array(ib), ones_a, ones_b)
    exact = (ia[:2].cpu().long() @ ib[:, :512].cpu().long()).float().to(torch.bfloat16)
    check(torch.equal(y.torch[:2, :512].cpu(), exact), "ops int8 GEMM: not the exact product")
    i8_ms = time_ms(lambda _: gp.matmul_int8(gp.Array(ia), gp.Array(ib), ones_a, ones_b), 1,
                    reps=5)
    qflops = 2.0 * m * k * nn
    del ia, ib, y
    print(f"phase 12: GEMM cells through the API: bf16 {n}^3 PYGPUKIT_GEMM=pallas (gemm "
          f"kernel) {k_ms:.3f} ms = {flops / k_ms / 1e9:.1f} TFLOP/s, default (cuBLAS) "
          f"{c_ms:.3f} ms = {flops / c_ms / 1e9:.1f} TFLOP/s, max abs diff {err:.3e}; fp8 "
          f"(quantize_fp8 + matmul_fp8, f32 product) at {m}x{k}x{nn} {fp8_ms:.3f} ms = "
          f"{qflops / fp8_ms / 1e9:.1f} TFLOP/s; int8 (matmul_int8, torch._int_mm) "
          f"{i8_ms:.3f} ms = {qflops / i8_ms / 1e9:.1f} TOP/s; [{card}]")

    gw = [(torch.randn((nq, kq), generator=g, device=dev) * 4).to(torch.float8_e4m3fn)
          for nq, kq in PROJ_SHAPES.values()]
    xs = [torch.randn((kq,), generator=g, device=dev).to(torch.bfloat16)
          for _, kq in PROJ_SHAPES.values()]
    torch.cuda.synchronize()
    reset_counts()
    ys = [gemv_quant(wq, xq) for wq, xq in zip(gw, xs)]
    torch.cuda.synchronize()
    gemv_launches = launch_counts()["gemv_quant"]
    reset_counts()
    check(gemv_launches == len(PROJ_SHAPES) and all(bool(torch.isfinite(y.float()).all())
                                                    for y in ys),
          f"ops gemv_quant: {gemv_launches} launches or a value not finite")
    per_step["gemv_quant"] = (0, "a library function: no path of the port calls it "
                              f"(phase 12 calls it {gemv_launches} times directly)")
    print(f"phase 12: gemv_quant through its library entry at the four projection shapes "
          f"(fp8 e4m3): {gemv_launches} launches, finite")

    # the row write through its library entry: every layer of batch-8 pools
    # at the 1.1B width (MAX 1024), bitwise its plain version
    b, mx, lanes = 8, 1024, cfg.num_kv_heads * cfg.head_dim
    shape = (b, cfg.num_layers, mx, lanes)
    kp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    k2, v2 = kp.clone(), vp.clone()
    rows = torch.randn((2, cfg.num_layers, b, cfg.num_kv_heads, cfg.head_dim), generator=g,
                       device=dev).to(torch.bfloat16)
    poss = torch.tensor([0, 5, 300, mx - 1, mx + 3, 37, 700, -1], dtype=torch.int32,
                        device=dev)
    torch.cuda.synchronize()
    reset_counts()
    for i in range(cfg.num_layers):
        gp.kv_rows_write(kp, vp, rows[0, i], rows[1, i], i, poss)
    torch.cuda.synchronize()
    krw_launches = launch_counts()["kv_rows_write"]
    reset_counts()
    for i in range(cfg.num_layers):
        kv_rows_write_plain(k2, v2, rows[0, i], rows[1, i], i, poss)
    check(krw_launches == cfg.num_layers and torch.equal(bits(kp), bits(k2))
          and torch.equal(bits(vp), bits(v2)),
          f"ops kv_rows_write: {krw_launches} launches or pools not bitwise the plain write")
    del kp, vp, k2, v2
    per_step["kv_rows_write"] = (0, "a library function: the batch-rows step's rows are "
                                 "written by the attention's launch (kv_rows_write_fused); "
                                 f"phase 12 calls it {krw_launches} times directly")
    print(f"phase 12: kv_rows_write through its library entry, {cfg.num_layers} layers of "
          f"[{b}, {cfg.num_layers}, {mx}, {lanes}] bf16 pools: {krw_launches} launches, "
          f"bitwise the plain write; phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"gemm": launches["gemm"], "gemv_quant": gemv_launches,
            "kv_rows_write": krw_launches}


def decode_route(model, route: str, per_step: dict) -> dict:
    """Phase 13, one route of the single-stream decode (the environment is
    set by the caller): a warm and a timed generate (identical tokens,
    finite logits, the route's launches and no other), a snapshot replay,
    and one step's eager and graph times. Returns the timed run's
    numbers."""
    import numpy as np
    import torch
    runs = []
    model.init_fixed_cache(LADDER_MAX)         # programs captured under this route
    for _ in range(2):
        zero_cache(model, LADDER_MAX)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = model.generate(LADDER_PROMPT, max_new_tokens=LADDER_NEW, chunk_size=GEN_CHUNK)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0, launch_counts(), model.logits_finite()))
    reset_counts()
    (toks1, _, _, fin1), (toks2, secs, launches, fin2) = runs
    check(len(toks2) == LADDER_NEW and toks1 == toks2,
          f"decode {route}: the timed run's tokens differ from the warm run's")
    check(fin1 and fin2, f"decode {route}: a logit went non-finite")
    steps = LADDER_NEW - 1
    kernel = "flash_decode" if route == "unfused" else "fused_decode"
    want = {kernel: steps * (model.config.num_layers if route == "unfused" else 1)}
    moved = {k: n for k, n in launches.items() if n}
    check(moved == want, f"decode {route}: launches {moved}, expected {want}")

    model.init_fixed_cache(LADDER_MAX)
    first = int(model.prefill(LADDER_PROMPT).argmax())
    head = model.decode_chunk(first, SNAP_AT)
    snap = model.snapshot_kv_cache()
    more = model.decode_chunk(int(head[-1]), SNAP_MORE)
    model.restore_kv_cache(snap)
    again = model.decode_chunk(int(head[-1]), SNAP_MORE)
    check(np.array_equal(more, again), f"decode {route}: {SNAP_MORE} tokens after a restore "
          "differ from the run before it")

    eager, graph, prof, counts = decode_step_times(model, 1, LADDER_MAX,
                                                   len(LADDER_PROMPT) + LADDER_NEW // 2)
    per_step[kernel] = (counts.get(kernel, 0), f"single-stream decode step ({route})")
    print(f"phase 13: {route} step: {LADDER_NEW / secs:.1f} tok/s replayed, {LADDER_NEW} tokens "
          f"replayed identical, launches {json.dumps(moved)}; snapshot after {SNAP_AT} "
          f"tokens, {SNAP_MORE} more, restore: the same {SNAP_MORE} again; one step at pos "
          f"{len(LADDER_PROMPT) + LADDER_NEW // 2}: eager {eager:.3f} ms wall, CUDA-graph "
          f"replay {graph:.3f} ms device, launches {json.dumps(counts)}")
    print(f"phase 13: {route} step: " + profile_line(prof, 6))
    return {"toks": toks2, "launches": launches[kernel]}


def decode_phase(cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 13, the single-stream fixed-cache decode on the 1.1B bf16
    model with separate leaves (no fuse_params): the unfused route, then
    PYGPUKIT_DECODE=fused, then one step both ways at the same cache.
    Returns the launches of the main-path runs (each route's timed
    generate)."""
    import os
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel, init_params
    t0 = time.perf_counter()
    model = CausalTransformerModel(cfg, init_params(cfg, 0, torch.bfloat16, dev),
                                   dtype=torch.bfloat16)
    saved = os.environ.get("PYGPUKIT_DECODE")
    try:
        os.environ.pop("PYGPUKIT_DECODE", None)
        unfused = decode_route(model, "unfused", per_step)
        os.environ["PYGPUKIT_DECODE"] = "fused"
        fused = decode_route(model, "fused", per_step)
        model.init_fixed_cache(LADDER_MAX)
        first = int(model.prefill(LADDER_PROMPT).argmax())
        snap = model.snapshot_kv_cache()
        lf = model.decode_step(first)
        model.restore_kv_cache(snap)
        os.environ.pop("PYGPUKIT_DECODE")
        lu = model.decode_step(first)
    finally:
        if saved is None:
            os.environ.pop("PYGPUKIT_DECODE", None)
        else:
            os.environ["PYGPUKIT_DECODE"] = saved
    rel = rel_l2(lf, lu)
    check(bool(torch.isfinite(lf).all()) and rel <= FWD_TOL,
          f"decode: fused vs unfused logits at one cache, relative L2 {rel:.3e}")
    same = sum(a == b for a, b in zip(fused["toks"], unfused["toks"]))
    print(f"phase 13: one step at pos {len(LADDER_PROMPT)}, fused vs unfused logits at the "
          f"same cache: relative L2 {rel:.3e} (limit {FWD_TOL}), argmax equal "
          f"{int(lf.argmax() == lu.argmax())}; the {LADDER_NEW}-token greedy streams agree in "
          f"{same}/{LADDER_NEW} tokens (random weights: reported); [{card}]")
    del model
    torch.cuda.empty_cache()
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return {"flash_decode": unfused["launches"], "fused_decode": fused["launches"]}


def capture_checks(model, route: str) -> dict:
    """Phase 16: the model's greedy step captured once at LADDER_PROMPT's
    cache (``core.capture`` through ``_ensure_decode_exe``), replayed at
    STRAT_POSITIONS: logits and both caches bitwise the eager step's from
    the same cache state, twice; the capture leaves the caches and the
    counters as they were; another cache raises. Returns the executable."""
    import torch
    from pygpukit_tpu_torch import LAUNCHES
    from pygpukit_tpu_torch.llm import decode_step_fn

    def cache_bits():
        return [bits(t).clone() for t in (model.k_cache, model.v_cache)]

    def put(saved):
        for t, s0 in zip((model.k_cache, model.v_cache), saved):
            bits(t).copy_(s0)
    model.init_fixed_cache(LADDER_MAX)
    model.prefill(LADDER_PROMPT)
    saved, counts = cache_bits(), dict(LAUNCHES)
    exe = model._ensure_decode_exe()
    torch.cuda.synchronize()
    check(dict(LAUNCHES) == counts and all(torch.equal(a, b) for a, b in
                                           zip(cache_bits(), saved)),
          f"strategies {route}: the capture changed the caches or the launch counters")
    kernel = "flash_decode" if route == "unfused" else "fused_decode"
    want = {kernel: model.config.num_layers if route == "unfused" else 1}
    check(exe.cost_analysis() == want,
          f"strategies {route}: cost_analysis {exe.cost_analysis()}, expected {want}")
    for pos in STRAT_POSITIONS:
        model.pos = pos
        state = cache_bits()
        eager = decode_step_fn(model.config, model.params, model.k_cache, model.v_cache,
                               pos % model.config.vocab_size, pos).clone()
        after = cache_bits()
        for _ in range(2):
            put(state)
            model.pos = pos
            got = model.decode_step(pos % model.config.vocab_size)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(eager).all()) and torch.equal(got, eager)
                  and all(torch.equal(a, b) for a, b in zip(cache_bits(), after)),
                  f"strategies {route}: the replay at pos {pos} is not the eager step's bits")
    b = model.decode_buffers
    try:
        exe.replay(model.params, model.k_cache.clone(), model.v_cache, 1, 20,
                   model._nonfinite, b.logits, b.sampled)
        check(False, f"strategies {route}: a replay handed another cache did not raise")
    except ValueError:
        pass
    print(f"phase 16: {route} step captured at pos {len(LADDER_PROMPT)}: node_count "
          f"{exe.node_count}, cost_analysis {json.dumps(exe.cost_analysis())}, pool "
          f"{exe.memory_analysis()} bytes; replays at pos {list(STRAT_POSITIONS)} bitwise "
          f"the eager step (logits and both caches), twice each; another cache raises")
    return exe


def timed_strategy(model, strat, prompt, n_new: int) -> tuple:
    """(tokens, wall seconds, launches of the run: eager plus cost_analysis
    x replays) of ``strat.generate`` from a zeroed cache, after a warm run
    that captures the programs the timed run replays; the counters set to
    0 just before the timed run. The tokens of both runs must agree."""
    import torch
    if getattr(strat, "init_graph", None) is not None:
        strat.init_graph(LADDER_MAX)
    elif model is not None:
        model.init_fixed_cache(LADDER_MAX)
    warm = strat.generate(prompt, n_new)
    if model is not None:
        zero_cache(model, LADDER_MAX)
    strat.stats = type(strat.stats)()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = strat.generate(prompt, n_new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    check(toks == warm, f"strategies: {type(strat).__name__}'s warm and timed runs differ")
    return toks, secs, counts


def step_loop_ms(model, replay: bool, n: int = STRAT_STEPS) -> float:
    """Wall ms per step of ``n`` steps fed back-to-back from
    LADDER_PROMPT's cache with one synchronize at the end: eager steps
    (``decode_step_fn``) or replays (``decode_step``)."""
    import torch
    from pygpukit_tpu_torch.llm import decode_step_fn
    model.init_fixed_cache(LADDER_MAX)
    model.prefill(LADDER_PROMPT)

    def eager(token):
        decode_step_fn(model.config, model.params, model.k_cache, model.v_cache, token,
                       model.pos)
        model.pos += 1
    step = model.decode_step if replay else eager
    step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step((i + 2) % model.config.vocab_size)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def forced_m1(model, toks) -> tuple:
    """DecodeM1's program (the model's prefill and captured step) fed
    LADDER_PROMPT then ``toks`` (teacher forcing) from a zeroed cache: per
    step its argmax, top-2 gap and near-tie bound (STRAT_TIE of the
    largest |logit|), and its caches' rows [L, R, Hk*D] of the fed tokens."""
    import numpy as np
    import torch
    zero_cache(model, LADDER_MAX)
    logits = model.prefill(LADDER_PROMPT)
    rows = []
    for i, tok in enumerate(toks):
        top = torch.topk(logits, 2).values
        rows.append(torch.stack([torch.argmax(logits).float(), top[0] - top[1],
                                 logits.abs().max()]))
        if i + 1 < len(toks):
            logits = model.decode_step(tok)
    s = torch.stack(rows).cpu().numpy().astype(np.float64)
    n = len(LADDER_PROMPT) + len(toks) - 1
    kv = [c[:, :n].reshape(c.shape[0], n, -1).clone() for c in (model.k_cache, model.v_cache)]
    return s[:, 0].astype(np.int64), s[:, 1], STRAT_TIE * s[:, 2], kv


def kv_rel_l2(rows, ref) -> float:
    """Largest relative L2 over layers of ``rows`` against ``ref`` [L, R, W]."""
    import torch
    a, b = rows.float(), ref[:, :rows.shape[1]].float()
    return float(((a - b).norm(dim=(1, 2)) / b.norm(dim=(1, 2))).max())


def context_check(model, name: str, toks, kv, n_rows: int, ref: tuple) -> str:
    """Phase 16's context check of one strategy (forced_m1 along its own
    tokens): its token is DecodeM1's argmax at every step that is no
    near-tie, and the first ``n_rows`` of its KV rows ``kv`` (k, v [L, R,
    Hk*D]) are DecodeM1's within STRAT_KV_TOL. ``ref`` is forced_m1 along
    DecodeM1's own tokens: the gap where the strategy parts from them is
    reported. Returns the report."""
    import numpy as np
    arg, gap, tie, m1_kv = forced_m1(model, toks)
    sure = gap > tie
    bad = [i for i in np.flatnonzero(sure) if toks[i] != arg[i]]
    n_rows = min(n_rows, m1_kv[0].shape[1])
    err = max(kv_rel_l2(a[:, :n_rows], b) for a, b in zip(kv, m1_kv))
    ref_toks, ref_gap, ref_tie = ref
    split = next((i for i, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), None)
    where = ("none" if split is None else f"token {split}, DecodeM1's top-2 gap there "
             f"{ref_gap[split]:.5g} (near-tie bound {ref_tie[split]:.5g})")
    check(not bad and err <= STRAT_KV_TOL,
          f"strategies: {name} against DecodeM1 fed its tokens: argmax differs at steps "
          f"{bad} beyond near-ties, or KV rows relative L2 {err:.3e} > {STRAT_KV_TOL}")
    return (f"{name}: DecodeM1's argmax at all {int(sure.sum())}/{len(toks)} steps beyond "
            f"a near-tie (smallest gap checked {gap[sure].min():.5g}), KV rows {n_rows} "
            f"within {err:.3e}; parts from DecodeM1's run at {where}")


def strategies_phase(cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 16, the decode strategies and capture/replay on phase 13's
    1.1B bf16 model with separate leaves, MAX LADDER_MAX, LADDER_PROMPT.
    Per route (unfused, then PYGPUKIT_DECODE=fused): the capture checks;
    DecodeM1 and DecodeM1Graph for LADDER_NEW tokens, identical, finite;
    eager against replayed wall ms per token (the strategies, each with a
    host read a token) and per step (STRAT_STEPS steps fed back-to-back).
    Unfused: DecodeBatch over 8 prompts (two identical, in slots 0 and 5),
    DecodeJacobi (window 6), DecodeSpeculative self (n_draft 2, gamma 4)
    and with a separate 2-layer draft made with slice_layers; tok/s,
    stats, agreement with DecodeM1 (reported), the context check of each
    (context_check) and the launches of every path: eager counts, plus
    cost_analysis() x replays for replays. Returns the launches of the
    replayed and batch paths."""
    import dataclasses
    import os
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel, init_params, slice_layers
    from pygpukit_tpu_torch.llm.decode import (DecodeBatch, DecodeJacobi, DecodeM1,
                                               DecodeM1Graph, DecodeSpeculative)
    t0 = time.perf_counter()
    model = CausalTransformerModel(cfg, init_params(cfg, 0, torch.bfloat16, dev),
                                   dtype=torch.bfloat16)
    layers = cfg.num_layers
    saved = os.environ.get("PYGPUKIT_DECODE")
    out: dict = {}
    try:
        for route in ("unfused", "fused"):
            if route == "fused":
                os.environ["PYGPUKIT_DECODE"] = "fused"
            else:
                os.environ.pop("PYGPUKIT_DECODE", None)
            exe = capture_checks(model, route)
            kernel = "flash_decode" if route == "unfused" else "fused_decode"
            per = layers if route == "unfused" else 1
            m1 = DecodeM1().bind(model)
            m1_toks, m1_s, m1_l = timed_strategy(model, m1, LADDER_PROMPT, LADDER_NEW)
            check(m1_l == {kernel: per * LADDER_NEW} and model.logits_finite(),
                  f"strategies {route}: DecodeM1 launches {m1_l} or a non-finite logit")
            graph = DecodeM1Graph().bind(model)
            g_toks, g_s, g_l = timed_strategy(model, graph, LADDER_PROMPT, LADDER_NEW)
            replayed = g_l                  # every decode step is a replay now
            check(g_toks == m1_toks and len(g_toks) == LADDER_NEW and model.logits_finite(),
                  f"strategies {route}: DecodeM1Graph's tokens differ from DecodeM1's")
            check(g_l == {kernel: per * LADDER_NEW},
                  f"strategies {route}: DecodeM1Graph launched {g_l} (cost_analysis x "
                  "replays)")
            eager_ms, replay_ms = step_loop_ms(model, False), step_loop_ms(model, True)
            out[f"{kernel} ({route}, replayed)"] = replayed.get(kernel, 0)
            per_step[f"{kernel} replayed"] = (per, f"one replay of the captured {route} step")
            print(f"phase 16: {route}: DecodeM1 {LADDER_NEW / m1_s:.1f} tok/s "
                  f"({m1_s * 1e3 / LADDER_NEW:.3f} ms/token replayed wall, {m1.stats}, launches "
                  f"{json.dumps(m1_l)}), DecodeM1Graph {LADDER_NEW / g_s:.1f} tok/s "
                  f"({g_s * 1e3 / LADDER_NEW:.3f} ms/token replayed wall, {graph.stats}, "
                  f"launches {json.dumps(g_l)}): {LADDER_NEW} tokens "
                  f"identical; {STRAT_STEPS} steps back-to-back: eager {eager_ms:.3f} ms/step, "
                  f"replayed {replay_ms:.3f} ms/step wall; [{card}]")
            if route == "unfused":
                ref_toks = m1_toks
        os.environ.pop("PYGPUKIT_DECODE", None)

        def agree(toks):
            return sum(a == b for a, b in zip(toks, ref_toks))

        rng = np.random.default_rng(16)
        prompts = [LADDER_PROMPT] + [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                                     for n in rng.integers(4, 40, 7)]
        prompts[5] = LADDER_PROMPT
        batch = DecodeBatch(max_seq_len=LADDER_MAX).bind(model)
        b_toks, b_s, b_l = timed_strategy(None, batch, prompts, LADDER_NEW)
        steps = LADDER_NEW - 1
        want = {"batch_decode_attention": layers * steps, "kv_rows_write_fused": layers * steps}
        check(b_toks[0] == b_toks[5] and all(len(t) == LADDER_NEW for t in b_toks),
              "strategies: DecodeBatch slots 0 and 5 (one prompt) differ")
        check(b_l == want, f"strategies: DecodeBatch launches {b_l}, expected {want}")
        out.update({k + " (DecodeBatch)": n for k, n in b_l.items()})
        print(f"phase 16: DecodeBatch 8 prompts: {8 * LADDER_NEW / b_s:.1f} tok/s "
              f"({LADDER_NEW / b_s:.1f} steps/s), stats {batch.stats}, slots 0 and 5 "
              f"identical, slot 0 agrees with DecodeM1 in {agree(b_toks[0])}/{LADDER_NEW}, "
              f"launches {json.dumps(b_l)}; [{card}]")
        # the context check: DecodeM1 fed its own tokens first (it must
        # reproduce them), then each strategy's
        ref_arg, ref_gap, ref_tie, _ = forced_m1(model, ref_toks)
        check(ref_arg.tolist() == ref_toks,
              "strategies: DecodeM1 fed its own tokens does not reproduce them")
        ref = (ref_toks, ref_gap, ref_tie)
        reports = [context_check(model, "DecodeBatch slot 0", b_toks[0],
                                 [c[0] for c in (batch.k_cache, batch.v_cache)],
                                 len(LADDER_PROMPT) + LADDER_NEW - 1, ref)]
        draft = CausalTransformerModel(dataclasses.replace(cfg, num_layers=2),
                                       slice_layers(model.params, 2), dtype=torch.bfloat16)
        for name, strat in (("DecodeJacobi(window 6)", DecodeJacobi(window=6)),
                            ("DecodeSpeculative(self, n_draft 2, gamma 4)",
                             DecodeSpeculative(n_draft_layers=2, gamma=4)),
                            ("DecodeSpeculative(2-layer draft, gamma 4)",
                             DecodeSpeculative(gamma=4, draft_model=draft))):
            strat.bind(model)
            toks, secs, counts = timed_strategy(model, strat, LADDER_PROMPT, LADDER_NEW)
            check(len(toks) == LADDER_NEW and model.logits_finite(),
                  f"strategies: {name} gave {len(toks)} tokens or a non-finite logit")
            st = strat.stats
            print(f"phase 16: {name}: {LADDER_NEW / secs:.1f} tok/s, stats {st}, "
                  f"acceptance {st.accepted / max(st.accepted + st.rejected, 1):.3f}, "
                  f"{st.tokens_per_step:.2f} tokens a step, agrees with DecodeM1 in "
                  f"{agree(toks)}/{LADDER_NEW}, launches {json.dumps(counts)}; [{card}]")
            kv = [c.reshape(c.shape[0], c.shape[1], -1).clone()
                  for c in (model.k_cache, model.v_cache)]
            reports.append(context_check(model, name, toks, kv, model.pos, ref))
        print(f"phase 16: context check, random weights (DecodeM1's program fed each "
              f"strategy's tokens; near-tie: top-2 gap <= {STRAT_TIE:g} of the largest "
              f"|logit|; KV limit {STRAT_KV_TOL}): " + "; ".join(reports) + f"; [{card}]")
        del model, draft, strat, batch
        torch.cuda.empty_cache()
        peaked_agreement(cfg, dev, prompts, card)
    finally:
        if saved is None:
            os.environ.pop("PYGPUKIT_DECODE", None)
        else:
            os.environ["PYGPUKIT_DECODE"] = saved
    torch.cuda.empty_cache()
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return out


def peaked_agreement(cfg, dev, prompts, card: str) -> None:
    """Phase 16 on a peaked 1.1B-width bf16 model (seed 0; PEAKED_EMBED
    says how it is built): DecodeBatch's slot 0 (the 8 prompts,
    LADDER_PROMPT in slot 0), DecodeJacobi (window 6), self-speculation
    (n_draft 2, gamma 4) and speculation with a separate 2-layer draft
    must each give DecodeM1's LADDER_NEW tokens."""
    import dataclasses
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel, init_params, slice_layers
    from pygpukit_tpu_torch.llm.decode import (DecodeBatch, DecodeJacobi, DecodeM1,
                                               DecodeSpeculative)
    params = init_params(cfg, 0, torch.bfloat16, dev)
    params["embed"] = params["embed"] * PEAKED_EMBED
    perm = torch.randperm(cfg.vocab_size, generator=torch.Generator().manual_seed(0))
    params["lm_head"] = params["embed"][perm.to(dev)].t().contiguous()
    model = CausalTransformerModel(cfg, params, dtype=torch.bfloat16)
    draft = CausalTransformerModel(dataclasses.replace(cfg, num_layers=2),
                                   slice_layers(model.params, 2), dtype=torch.bfloat16)
    model.init_fixed_cache(LADDER_MAX)
    ref = DecodeM1().bind(model).generate(LADDER_PROMPT, LADDER_NEW)
    got = {"DecodeBatch slot 0": DecodeBatch(max_seq_len=LADDER_MAX).bind(model)
           .generate(prompts, LADDER_NEW)[0]}
    for name, strat in (("DecodeJacobi(window 6)", DecodeJacobi(window=6)),
                        ("DecodeSpeculative(self, n_draft 2, gamma 4)",
                         DecodeSpeculative(n_draft_layers=2, gamma=4)),
                        ("DecodeSpeculative(2-layer draft, gamma 4)",
                         DecodeSpeculative(gamma=4, draft_model=draft))):
        model.init_fixed_cache(LADDER_MAX)
        got[name] = strat.bind(model).generate(LADDER_PROMPT, LADDER_NEW)
    agree = {name: sum(a == b for a, b in zip(toks, ref)) for name, toks in got.items()}
    print(f"phase 16: peaked model (embed x {PEAKED_EMBED}, permuted head): agreement with "
          f"DecodeM1's {LADDER_NEW} tokens {json.dumps(agree)} ({len(set(ref))} distinct "
          f"tokens in DecodeM1's); [{card}]")
    check(len(ref) == LADDER_NEW and all(toks == ref for toks in got.values()),
          f"strategies, peaked model: a strategy's tokens differ from DecodeM1's: {agree}")
    del model, draft
    torch.cuda.empty_cache()


def kv_phase(cfg, dev, card: str) -> None:
    """Phase 15, the reference's bench_serving_kv (bench.py:390-428) at full
    width and depth: the 1.1B shape with int8 (w8a8) weights, the batch-8
    pipelined engine at MAX 4096, 32 steps a dispatch, 8 warm-up requests,
    then 16 timed requests of one 16-token prompt and 128 new tokens, on
    bf16, int8 and fp8 KV. Every request finishes with finite logits; the
    row write and the attention launch once a layer a step; the engine
    served again (serve_again) replays the int8 run's streams and pools bitwise (the reference cell's
    storage; bf16's replay is phase 5's, fp8 shares int8's kernels but
    the convert); tok/s, TTFT, one step's eager and graph device ms and the
    greedy tokens that agree with the bf16 run, per storage."""
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel, ContinuousBatchingEngine
    t0 = time.perf_counter()
    params = build_model(cfg, 0, dev, "int8").params
    requests = [(KV_PROMPT, KV_NEW)] * KV_REQS

    def run(model):
        eng = ContinuousBatchingEngine(model, max_batch=8, max_seq_len=KV_MAX,
                                       steps_per_dispatch=KV_STEPS, pipelined=True)
        for _ in range(KV_WARM):
            eng.submit(KV_PROMPT, max_new_tokens=KV_STEPS)
        eng.run_until_complete()
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
        eng.run_until_complete()
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t1, launch_counts()

    base_streams = None
    for kind in ("bf16", "int8", "fp8"):
        model = CausalTransformerModel(cfg, params, dtype=torch.bfloat16,
                                       kv_dtype=None if kind == "bf16" else kind)
        eng, reqs, secs, launches = run(model)
        n_tok = check_served(eng, reqs, requests, f"kv {kind}")
        for name in ("kv_rows_write_fused", "batch_decode_attention"):
            check(launches[name] > 0, f"kv {kind}: {name} was never launched")
        streams = [r.generated for r in reqs]
        if kind == "int8":
            pools = pool_copy(eng)
            reqs2, _ = serve_again(eng, requests, warm=[(KV_PROMPT, KV_STEPS)] * KV_WARM)
            check([r.generated for r in reqs2] == streams, f"kv {kind} replay: streams differ")
            check(all(torch.equal(x, y) for x, y in zip(pools, pool_copy(eng))),
                  f"kv {kind} replay: pools differ")
            del pools
        del eng
        eager, graph, _, counts = decode_step_times(model, 8, KV_MAX, 1000, profile=False)
        for name in ("kv_rows_write_fused", "batch_decode_attention"):
            check(counts.get(name) == cfg.num_layers,
                  f"kv {kind}: {name} launched {counts.get(name)} times a step")
        if base_streams is None:
            base_streams = streams
        agree = sum(a == b for s1, s2 in zip(streams, base_streams) for a, b in zip(s1, s2))
        ttft = ttft_ms(reqs)
        print(f"phase 15: kv {kind} (int8 weights, MAX {KV_MAX}, {KV_STEPS} steps a dispatch): "
              f"{n_tok} tokens in {secs:.3f} s = {n_tok / secs:.1f} tok/s, TTFT p50/p95 "
              f"{ttft[0]:.1f}/{ttft[1]:.1f} ms; a batch-8 step at context 1001: eager "
              f"{eager:.3f} ms wall, CUDA-graph replay {graph:.3f} ms device; launches a step "
              f"{json.dumps(counts)}; greedy tokens equal to bf16's {agree}/{n_tok}"
              + ("; replay identical (streams and pools)" if kind == "int8" else "")
              + f"; [{card}]")
        del model
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")


def moe_forward_flops(cfg, s_len: int) -> float:
    """forward_flops with the routed MLP: per token the router and the
    top-k experts' three products in place of the dense MLP."""
    e, v, mi = cfg.hidden_size, cfg.vocab_size, cfg.moe_intermediate_size
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = (e * (hq + 2 * hk) * d + hq * d * e + e * cfg.num_experts
                 + cfg.num_experts_per_tok * 3 * e * mi)
    weights = cfg.num_layers * per_layer + e * v
    return 2 * weights * s_len + cfg.num_layers * 4 * hq * d * s_len * (s_len + 1) / 2


def moe_forward(model, cfg, dev, card: str, per_step: dict) -> dict:
    """Phase 14, step 1: get_logits on MOE_FWD_S tokens (shape, finite, 3
    gmm and 1 flash_attention launches a layer and nothing else, a bitwise
    second call), device ms by CUDA events and graph replay, a kernel
    profile. Returns the launches of the first call."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import forward_fn
    n_layers = cfg.num_layers
    ids = np.random.default_rng(14).integers(1, cfg.vocab_size, MOE_FWD_S).tolist()
    torch.cuda.synchronize()
    reset_counts()
    logits = model.get_logits(ids)
    launches = launch_counts()
    reset_counts()
    check(logits.shape == (MOE_FWD_S, cfg.vocab_size) and bool(np.isfinite(logits).all()),
          f"moe forward: logits {logits.shape} or a value not finite")
    moved = {k: n for k, n in launches.items() if n}
    want = {"gmm": 3 * n_layers, "flash_attention": n_layers}
    check(moved == want, f"moe forward: launches {moved}, expected {want}")
    again = model.get_logits(ids)
    check(np.array_equal(logits.view(np.uint32), again.view(np.uint32)),
          "moe forward: a second call's logits differ")
    del logits, again
    per_step["gmm"] = (3 * n_layers, f"one {MOE_FWD_S}-token forward of the "
                       f"{n_layers}-layer Mixtral (3 a MoE layer)")
    tokens = torch.tensor(ids, device=dev)

    def fwd(_):
        forward_fn(cfg, model.params, tokens)
    fwd(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        fwd(0)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 3
    graph = time_ms(fwd, 1, reps=3)
    prof = kernel_profile(fwd, n=2)
    flops = moe_forward_flops(cfg, MOE_FWD_S)
    print(f"phase 14: forward of {MOE_FWD_S} tokens: {ms:.3f} ms (CUDA events, eager) = "
          f"{MOE_FWD_S / ms * 1e3:.0f} tok/s, {flops / 1e12:.3f} TFLOP = "
          f"{flops / (ms * 1e-3) / PEAK_OPS_S['bf16']:.4f} of "
          f"{PEAK_OPS_S['bf16'] / 1e12:.0f} TFLOP/s; graph replay "
          f"{graph:.3f} ms device; launches {json.dumps(moved)}, second call bitwise "
          f"equal; [{card}]")
    print("phase 14: " + profile_line(prof, 8))
    return launches


def moe_generate(model, cfg, dev) -> None:
    """Phase 14, step 2: generate MOE_NEW greedy tokens after a
    MOE_PROMPT-token prompt twice (identical tokens, finite logits, 3 gmm
    launches a layer in the prefill and none in decode, one flash_decode a
    layer a step); one decode step's eager and graph ms beside the gather
    route's device ms (one _moe_mlp call at T 1 a layer)."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm.model import _moe_mlp, _slice_layer_params
    n_layers = cfg.num_layers
    prompt = np.random.default_rng(15).integers(1, cfg.vocab_size, MOE_PROMPT).tolist()
    runs = []
    model.init_fixed_cache(MOE_MAX)          # the first run captures, the second replays
    for _ in range(2):
        zero_cache(model, MOE_MAX)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = model.generate(prompt, max_new_tokens=MOE_NEW, chunk_size=MOE_NEW)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0, launch_counts(), model.logits_finite()))
    reset_counts()
    (toks1, _, _, fin1), (toks2, secs, launches, fin2) = runs
    check(len(toks2) == MOE_NEW and toks1 == toks2,
          "moe generate: the second run's tokens differ from the first's")
    check(fin1 and fin2, "moe generate: a logit went non-finite")
    moved = {k: n for k, n in launches.items() if n}
    want = {"gmm": 3 * n_layers, "flash_decode": n_layers * (MOE_NEW - 1)}
    check(moved == want, f"moe generate: launches {moved}, expected {want}")
    pos = MOE_PROMPT + MOE_NEW // 2
    eager, graph, prof, counts = decode_step_times(model, 1, MOE_MAX, pos)
    check(counts == {"flash_decode": n_layers}, f"moe decode step: launches {counts}")
    lps = [_slice_layer_params(model.params["layers"], i) for i in range(n_layers)]
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    y1 = torch.randn((1, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    gather_ms = time_ms(lambda i: _moe_mlp(cfg, lps[i], y1), n_layers, reps=5) * n_layers
    print(f"phase 14: generate {MOE_NEW} greedy tokens after a {MOE_PROMPT}-token prompt "
          f"(prefill {2 * MOE_PROMPT} routed rows): {MOE_NEW / secs:.1f} tok/s replayed, "
          f"replayed identical, launches {json.dumps(moved)} (gmm only in the prefill); "
          f"one decode step at pos {pos}: eager {eager:.3f} ms wall, CUDA-graph replay "
          f"{graph:.3f} ms device, launches {json.dumps(counts)}; the gather route "
          f"({n_layers} _moe_mlp calls at T 1) {gather_ms:.3f} ms device = "
          f"{gather_ms / graph:.3f} of the step")
    print("phase 14: decode step " + profile_line(prof, 6))


def moe_engine(model, cfg) -> None:
    """Phase 14, step 3: the batch-8 engine on MOE_REQUESTS requests of
    MOE_REQ_PROMPT-token prompts and MOE_REQ_NEW new tokens: every request
    finishes, gmm in the prefills, one batch_decode_attention a layer a
    decode step, the row write fused in, on the dense MoE route
    (no gmm), the engine served again (serve_again) replays the streams and
    pools bitwise."""
    import numpy as np
    import torch
    n_layers = cfg.num_layers
    rng = np.random.default_rng(17)
    requests = [(rng.integers(1, cfg.vocab_size, MOE_REQ_PROMPT).tolist(), MOE_REQ_NEW)
                for _ in range(MOE_REQUESTS)]
    reset_counts()
    eng1, reqs1, secs1 = serve(model, requests, 16, max_seq_len=MOE_ENGINE_MAX)
    launches = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    n_tok = check_served(eng1, reqs1, requests, "moe engine")
    for name in ("gmm", "kv_rows_write_fused", "batch_decode_attention"):
        check(launches.get(name, 0) > 0, f"moe engine: {name} was never launched")
    eager, graph, prof, counts = decode_step_times(model, 8, MOE_ENGINE_MAX,
                                                   MOE_REQ_PROMPT + MOE_REQ_NEW // 2)
    want = {"kv_rows_write_fused": n_layers, "batch_decode_attention": n_layers}
    check(counts == want, f"moe engine decode step: launches {counts}, expected {want}")
    pools = pool_copy(eng1)
    reqs2, secs2 = serve_again(eng1, requests)
    check([r.generated for r in reqs1] == [r.generated for r in reqs2],
          "moe engine, second run: token streams differ")
    check(all(torch.equal(a, b) for a, b in zip(pools, pool_copy(eng1))),
          "moe engine, second run: KV pools differ")
    del pools
    ttft = ttft_ms(reqs1)
    print(f"phase 14: batch-8 engine, {MOE_REQUESTS} requests of {MOE_REQ_PROMPT} + "
          f"{MOE_REQ_NEW} tokens: {n_tok} tokens in {secs1:.3f} s = {n_tok / secs1:.1f} tok/s "
          f"(second run {n_tok / secs2:.1f}), TTFT p50/p95 {ttft[0]:.1f}/{ttft[1]:.1f} ms, "
          f"launches {json.dumps(launches)}; replay identical (streams and pools); one "
          f"batch-8 decode step (dense MoE route): eager {eager:.3f} ms wall, CUDA-graph "
          f"replay {graph:.3f} ms device, launches {json.dumps(counts)}")
    print("phase 14: batch-8 step " + profile_line(prof, 6))


def moe_cpu_parity(cfg, dev) -> None:
    """Phase 14, step 4: a 2-layer full-width Mixtral drawn on the CPU and
    copied to the card; get_logits on MOE_PARITY_S tokens, the card (gmm, 6
    launches) against the CPU plain path (the dense route; the CPU model's
    matmul leaves f32 copies, ``cpu_f32_weights``): the MOE_ROWS_Q
    quantile of the rows' relative L2 within FWD_TOL (see MOE_ROWS_Q)."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig, fuse_params,
                                        init_params)
    small = TransformerConfig(**{**cfg.__dict__, "num_layers": 2})
    params = fuse_params(init_params(small, 1, torch.bfloat16, "cpu"))

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return None if tree is None else tree.to(dev)
    cpu_model = CausalTransformerModel(small, dict(params, layers=cpu_f32_weights(
        params["layers"])), dtype=torch.bfloat16)
    card_model = CausalTransformerModel(small, to_card(params), dtype=torch.bfloat16)
    ids = np.random.default_rng(18).integers(1, cfg.vocab_size, MOE_PARITY_S).tolist()
    torch.cuda.synchronize()
    reset_counts()
    lc = card_model.get_logits(ids)
    n_gmm = launch_counts()["gmm"]
    reset_counts()
    check(n_gmm == 6, f"moe 2-layer forward: gmm launched {n_gmm} times, expected 6")
    t0 = time.perf_counter()
    lr = cpu_model.get_logits(ids)
    cpu_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(lc - lr) / np.linalg.norm(lr))
    rows = np.linalg.norm(lc - lr, axis=1) / np.linalg.norm(lr, axis=1)
    top = float((lc.argmax(-1) == lr.argmax(-1)).mean())
    check(np.quantile(rows, MOE_ROWS_Q) <= FWD_TOL,
          f"moe 2-layer forward, card vs CPU: {MOE_ROWS_Q} quantile of the rows' relative "
          f"L2 {np.quantile(rows, MOE_ROWS_Q):.3e} (all rows {rel:.3e})")
    print(f"phase 14: 2-layer Mixtral forward of {MOE_PARITY_S} tokens, card (gmm) vs CPU "
          f"plain path (dense route, {cpu_s:.1f} s): relative L2 of the rows: median "
          f"{np.median(rows):.3e}, {MOE_ROWS_Q} quantile {np.quantile(rows, MOE_ROWS_Q):.3e} "
          f"(limit {FWD_TOL}), max {rows.max():.3e}, {int((rows > FWD_TOL).sum())} rows above "
          f"the limit; all rows {rel:.3e}; argmax equal in {top:.4f} of rows")


def moe_phase(dev, card: str, per_step: dict) -> dict:
    """Phase 14, the MoE path on CFG_MIXTRAL (random bf16 weights, seed 0,
    fuse_params): the forward, generate, the batch-8 engine, then a 2-layer
    model against the CPU plain path. Returns the launches of the main-path
    run (the forward's first get_logits)."""
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig, fuse_params,
                                        init_params)
    t0 = time.perf_counter()
    cfg = TransformerConfig(**CFG_MIXTRAL)
    model = CausalTransformerModel(cfg, fuse_params(init_params(cfg, 0, torch.bfloat16, dev)),
                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in model.buffers())
    print(f"phase 14: Mixtral-8x7B widths at {cfg.num_layers} layers: {weights / 1e9:.2f} GB "
          f"of bf16 weights built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    launches = moe_forward(model, cfg, dev, card, per_step)
    moe_generate(model, cfg, dev)
    moe_engine(model, cfg)
    del model
    torch.cuda.empty_cache()
    moe_cpu_parity(cfg, dev)
    torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return launches


def clone_tree(t):
    import torch
    if isinstance(t, torch.Tensor):
        return t.clone()
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(clone_tree(v) for v in t)
    return t


def tree_equal(a, b, trash: bool = False) -> bool:
    """Leaf by leaf bitwise; ``trash``: paged pools [L, NB, ...] compared
    outside block 0 (its duplicate writes are unordered)."""
    import torch
    if isinstance(a, dict):
        return all(tree_equal(a[k], b[k], trash) for k in a)
    if isinstance(a, (tuple, list)):
        return all(tree_equal(x, y, trash) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        if trash:
            a, b = a[:, 1:], b[:, 1:]
        return a.shape == b.shape and torch.equal(bits(a), bits(b))
    return a == b


def eager_vs_replay(exe, args, what: str, trash=()) -> tuple[float, float]:
    """One eager call of ``exe``'s function on clones of its donated
    arguments against one replay from the same state, the registered
    generators put back in between: outputs and donated state bitwise
    (``trash``: the argnums of paged pools). Returns (eager, replay) wall
    ms, each synchronized."""
    import torch
    donated = exe.donate_argnums
    clones = [clone_tree(a) if i in donated else a for i, a in enumerate(args)]
    states = [gen.get_state() for gen in exe.generators]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = exe.fn(*clones)
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) * 1e3
    ref = clone_tree(ref)
    for gen, st in zip(exe.generators, states):
        gen.set_state(st)
    t0 = time.perf_counter()
    out = exe.replay(*args)
    torch.cuda.synchronize()
    replay = (time.perf_counter() - t0) * 1e3
    check(tree_equal(out, ref) and all(tree_equal(args[i], clones[i], i in trash)
                                       for i in donated),
          f"graphs: {what}: the replay is not the eager call's bits")
    return eager, replay


def exe_lines(pool, what: str) -> str:
    """Per executable of an owner's ExecutableCache: node count, bytes
    reserved in the pool, capture seconds, replays."""
    rows = [f"{e.name}: {e.node_count} nodes, {e.memory_analysis()} B, "
            f"{e.stats.capture_s:.2f} s, {e.stats.replays} replays"
            for e in pool.executables().values()]
    return f"{what}: pool {pool.nbytes} B; " + "; ".join(rows)


def engine_inputs(eng, key, rng) -> tuple:
    """Replay arguments of the engine's executable ``key`` at a fresh
    random input: prompts, lengths in [1, bucket], distinct slots, distinct
    blocks for paged tables; the chunk at random tokens and positions (the
    pipelined engine's own last/poss and the paged tables set in place)."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.ops.embedding import kv_leaf
    m = eng.model
    dev, vocab, b = m.device, m.config.vocab_size, eng.max_batch
    pools, flag = (m.params, eng.k_cache, eng.v_cache), eng._nonfinite

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.as_tensor(rng.integers(lo, hi, shape), dtype=dtype, device=dev)

    def tables(w):
        nb = kv_leaf(eng.k_cache).shape[1]
        blocks = rng.permutation(np.arange(1, nb))[:w * eng.max_blocks]
        return torch.as_tensor(blocks.reshape(w, eng.max_blocks), dtype=torch.int32,
                               device=dev)
    if key == "chunk":
        last, poss = ints(1, vocab, (b,), torch.long), ints(0, eng.max_seq_len - 1, (b,))
        if eng.pipelined:
            eng._last_dev.copy_(last)
            eng._poss_dev.copy_(poss)
            last, poss = eng._last_dev, eng._poss_dev
        head = pools
        if eng.paged:
            eng._tables_dev.copy_(tables(b))
            head += (eng._tables_dev,)
        return head + (last, poss, flag)
    w, bucket = (key[1] if len(key) == 3 else 1, key[-1]) if isinstance(key, tuple) else (1, key)
    tokens = ints(1, vocab, (w, bucket), torch.long)
    lens = ints(1, bucket + 1, (w,))
    slots = torch.as_tensor(rng.permutation(b)[:w], dtype=torch.int32, device=dev)
    if not eng.pipelined:
        if eng.paged:
            return pools + (tables(1)[0], tokens[0], lens[:1], flag)
        return pools + (tokens[0], lens[:1], slots[:1], flag)
    state = pools + (eng._last_dev, eng._poss_dev)
    if eng.paged:
        return state + (tables(w), tokens, lens, slots, flag)
    return state + (tokens, lens, slots, flag)


def graphs_engine(model, requests, n_steps: int, what: str, rng, card: str,
                  phase: str = "17", stats: dict | None = None, n_inputs: int = 2,
                  **kw) -> dict:
    """Phase 17, one engine: its programs captured in warmup() (untimed),
    the requests served twice (the second time by serve_again, replaying
    the same programs from a zeroed state): identical streams and bitwise
    pools (paged: outside block 0); tok/s and TTFT; per
    executable its nodes, pool bytes and capture seconds; every executable
    replayed bitwise against one eager call of its function at two random
    inputs, the chunk's eager and replayed wall ms a step; launches a step
    from cost_analysis(). Returns the first run's launches (cost_analysis
    x replays)."""
    paged = kw.get("paged", False)
    reset_counts()
    eng, reqs1, secs1 = serve(model, requests, n_steps, prewarm=True, **kw)
    launches = launch_counts()
    reset_counts()
    n_tok = check_served(eng, reqs1, requests, what)
    pool_bytes = sum(t.numel() * t.element_size() for c in (eng.k_cache, eng.v_cache)
                     for t in (c.values() if isinstance(c, dict) else (c,)))
    pools = pool_copy(eng, "cpu" if pool_bytes > POOL_HOST_BYTES else None)
    reqs2, secs2 = serve_again(eng, requests)
    check([r.generated for r in reqs1] == [r.generated for r in reqs2],
          f"graphs: {what}: the second run's streams differ")
    check(pools_equal(pools, eng, paged), f"graphs: {what}: the second run's pools differ")
    ttft = ttft_ms(reqs1)
    del pools
    chunk = eng.graphs.get("chunk")
    per_step = {k: n / n_steps for k, n in chunk.cost_analysis().items()}
    times = {}
    for key, exe in eng.graphs.executables().items():
        for _ in range(n_inputs):
            times[exe.name] = eager_vs_replay(exe, engine_inputs(eng, key, rng),
                                              f"{what} {exe.name}", (1, 2) if paged else ())
    e_ms, r_ms = times[chunk.name]
    if stats is not None:
        stats.update(tok_s=n_tok / secs1, tok_s_again=n_tok / secs2, ttft_ms=list(ttft),
                     replayed_ms_step=r_ms / n_steps, streams=[r.generated for r in reqs1])
    print(f"phase {phase}: {what}: {len(reqs1)} requests, {n_tok} tokens in {secs1:.3f} s = "
          f"{n_tok / secs1:.1f} tok/s (second run {n_tok / secs2:.1f}), TTFT p50/p95 "
          f"{ttft[0]:.1f}/{ttft[1]:.1f} ms; streams and pools identical over two runs; "
          f"{chunk.name}: eager {e_ms / n_steps:.3f} ms/step, replayed "
          f"{r_ms / n_steps:.3f} ms/step wall; launches a step {json.dumps(per_step)}; "
          f"every executable's replay bitwise its eager call at {n_inputs} input(s); "
          f"[{card}]")
    print(f"phase {phase}: " + exe_lines(eng.graphs, what) + "; eager/replayed ms "
          + json.dumps({k: [round(v[0], 3), round(v[1], 3)] for k, v in times.items()}))
    del eng
    return launches


def model_inputs(model, key, rng) -> tuple:
    """Replay arguments of the model's executable ``key`` at a random
    input (position, tokens, true length)."""
    import torch
    dev, vocab = model.device, model.config.vocab_size
    head = (model.params, model.k_cache, model.v_cache)

    def one(lo, hi):
        return torch.tensor([int(rng.integers(lo, hi))], dtype=torch.int32, device=dev)
    kind = key[0]
    if kind == "prefill":
        tokens = torch.as_tensor(rng.integers(1, vocab, key[1]), dtype=torch.int32, device=dev)
        return head + (tokens, one(1, key[1] + 1), model._nonfinite)
    if kind == "decode":
        b = model.decode_buffers
        return head + (one(1, vocab), one(16, LADDER_MAX - 1), model._nonfinite, b.logits,
                       b.sampled)
    if kind == "window":
        tokens = torch.as_tensor(rng.integers(1, vocab, key[1]), dtype=torch.long, device=dev)
        return head + (tokens, one(16, LADDER_MAX - key[1]), model._nonfinite)
    return head + (one(1, vocab), one(16, LADDER_MAX - key[1]), model._nonfinite)


def graphs_model(model, rng, card: str) -> None:
    """Phase 17, the model's programs at MAX LADDER_MAX: prefill (16-token
    prompt, bucket 32), decode_step, decode_window (T GRAPH_WINDOW) and
    decode_chunk_device (GRAPH_CHUNK steps, greedy and at GRAPH_TEMP with
    top-k GRAPH_TOPK): each replay bitwise one eager call at two inputs
    (the sampled chunk's generator reseeded alike, two seeds)."""
    model.init_fixed_cache(LADDER_MAX)
    logits = model.prefill(LADDER_PROMPT)
    tok = logits.argmax()
    model.decode_step(tok)
    model.decode_window(list(range(1, GRAPH_WINDOW + 1)), advance=0)
    model.decode_chunk_device(tok, GRAPH_CHUNK)
    model.decode_chunk_device(tok, GRAPH_CHUNK, GRAPH_TEMP, GRAPH_TOPK, seed=1)
    times = {}
    for key, exe in model.graphs.executables().items():
        for seed in (3, 4):
            if exe.generators:
                exe.generators[0].manual_seed(seed)
            label = exe.name + (" sampled" if exe.generators else "")
            times[label] = eager_vs_replay(exe, model_inputs(model, key, rng),
                                           f"model {label}")
    steps = {f"generate_{GRAPH_CHUNK}": GRAPH_CHUNK,
             f"generate_{GRAPH_CHUNK} sampled": GRAPH_CHUNK}
    print("phase 17: model programs, each replay bitwise its eager call at two inputs; "
          "eager/replayed wall ms a call (a step for the chunks): "
          + json.dumps({k: [round(v[0] / steps.get(k, 1), 3), round(v[1] / steps.get(k, 1), 3)]
                        for k, v in times.items()}) + f"; [{card}]")
    print("phase 17: " + exe_lines(model.graphs, "model"))


def graphs_strategies(model, cfg, rng, card: str) -> None:
    """Phase 17, DecodeBatch over 8 prompts and speculation with a separate
    2-layer draft (slice_layers of the model): their programs, each replay
    bitwise one eager call at two inputs."""
    import dataclasses
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel, slice_layers
    from pygpukit_tpu_torch.llm.decode import DecodeBatch, DecodeSpeculative
    dev, vocab = model.device, cfg.vocab_size
    prompts = [LADDER_PROMPT] + [rng.integers(1, vocab, int(n)).tolist()
                                 for n in rng.integers(4, 40, 7)]
    batch = DecodeBatch(max_seq_len=LADDER_MAX).bind(model)
    toks = batch.generate(prompts, GRAPH_CHUNK)
    check(all(len(t) == GRAPH_CHUNK for t in toks), "graphs: DecodeBatch token counts")
    times = {}
    for key, exe in batch.graphs.executables().items():
        for _ in range(2):
            if key[0] == "prefill":
                inputs = (torch.as_tensor(rng.integers(1, vocab, (8, key[2])), device=dev),
                          torch.as_tensor(rng.integers(1, key[2] + 1, 8), dtype=torch.int32,
                                          device=dev))
            else:
                inputs = (torch.as_tensor(rng.integers(1, vocab, 8), dtype=torch.int32,
                                          device=dev),
                          torch.as_tensor(rng.integers(40, LADDER_MAX - 1, 8),
                                          dtype=torch.int32, device=dev))
            times[exe.name] = eager_vs_replay(
                exe, (model.params, batch.k_cache, batch.v_cache) + inputs,
                f"DecodeBatch {exe.name}")
    print("phase 17: " + exe_lines(batch.graphs, "DecodeBatch"))
    del batch
    draft = CausalTransformerModel(dataclasses.replace(cfg, num_layers=2),
                                   slice_layers(model.params, 2), dtype=torch.bfloat16)
    spec = DecodeSpeculative(gamma=4, draft_model=draft).bind(model)
    model.init_fixed_cache(LADDER_MAX)
    toks = spec.generate(LADDER_PROMPT, GRAPH_DRAFT_NEW)
    check(len(toks) == GRAPH_DRAFT_NEW, "graphs: speculation with a draft: token count")
    for key, exe in spec.graphs.executables().items():
        for _ in range(2):
            one = torch.tensor([int(rng.integers(1, key[1] + 1 if key[0] == "prefill"
                                                 else vocab))], dtype=torch.int32, device=dev)
            if key[0] == "prefill":
                first = torch.as_tensor(rng.integers(1, vocab, key[1]), device=dev)
            else:
                first = one
                one = torch.tensor([int(rng.integers(16, LADDER_MAX - key[1]))],
                                   dtype=torch.int32, device=dev)
            times[exe.name] = eager_vs_replay(
                exe, (spec._draft_params, spec._draft_k, spec._draft_v, first, one),
                f"draft {exe.name}")
    print(f"phase 17: DecodeBatch and the separate draft: every replay bitwise its eager "
          f"call at two inputs; eager/replayed wall ms "
          + json.dumps({k: [round(v[0], 3), round(v[1], 3)] for k, v in times.items()})
          + f"; speculation stats {spec.stats}; [{card}]")
    print("phase 17: " + exe_lines(spec.graphs, "draft"))
    del spec, draft


def graphs_phase(cfg, dev, card: str, requests) -> dict:
    """Phase 17 (graphs): every program the engine, the model, DecodeBatch
    and the separate draft capture, on the TinyLlama-1.1B shape with random
    int4 weights (seed 0): the dense pipelined engine (batch 8, MAX 1024,
    16 steps a dispatch) over phase 4's requests, the paged pipelined
    engine (block 16, MAX 512, 128 steps) over GRAPH_PAGED_REQS requests of
    16 + 128 tokens (phase 7's) at GRAPH_PAGED_STEPS steps a dispatch, the
    non-pipelined dense engine; the
    model's programs; DecodeBatch and the separate draft. Returns the
    launches of the dense pipelined run."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    model = build_model(cfg, 0, dev)
    rng = np.random.default_rng(17)
    launches = graphs_engine(model, requests, 16, "dense pipelined engine", rng, card,
                             pipelined=True)
    paged_reqs = [(rng.integers(1, cfg.vocab_size, 16).tolist(), 128)
                  for _ in range(GRAPH_PAGED_REQS)]
    graphs_engine(model, paged_reqs, GRAPH_PAGED_STEPS, "paged pipelined engine", rng,
                  card, max_seq_len=512, pipelined=True, paged=True, block_size=16)
    graphs_engine(model, requests, 16, "dense engine, not pipelined", rng, card)
    graphs_model(model, rng, card)
    graphs_strategies(model, cfg, rng, card)
    del model
    torch.cuda.empty_cache()
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return launches


def write_tokenizer(path: Path, vocab_size: int) -> None:
    """A byte-level BPE tokenizer.json (the Hugging Face format): the
    ChatML specials (ids 0-2, also added tokens), the 256 byte characters,
    TOKENIZER_MERGES merges learned from TOKENIZER_TEXT (the most frequent
    pair first, ties to the larger pair), then two-character tokens up to
    ``vocab_size``, so every id the model can sample decodes to text."""
    from collections import Counter
    from pygpukit_tpu_torch.llm.tokenizer import _bytes_to_unicode, _split_words
    enc = _bytes_to_unicode()
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[enc[b]] = len(vocab)
    words = Counter("".join(enc[b] for b in w.encode("utf-8"))
                    for w in _split_words(TOKENIZER_TEXT))
    seqs = {w: list(w) for w in words}
    merges = []
    for _ in range(TOKENIZER_MERGES):
        pairs: Counter = Counter()
        for w, n in words.items():
            for pair in zip(seqs[w], seqs[w][1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    chars = [enc[b] for b in range(256)]
    for a in chars:
        for b in chars:
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault(a + b, len(vocab))
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    path.write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None, "pre_tokenizer": byte_level, "post_processor": None,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}, ensure_ascii=False))


def hf_llama_tensors(cfg, params: dict) -> dict:
    """The Hugging Face Llama names of an unfused param tree, projections as
    ``[out, in]`` views (transposed copies are made one at a time by the
    writer)."""
    lp = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"]}
    hf = {"w_q": "self_attn.q_proj", "w_k": "self_attn.k_proj", "w_v": "self_attn.v_proj",
          "w_o": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
          "w_down": "mlp.down_proj"}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = lp["attn_norm_w"][i]
        out[pre + "post_attention_layernorm.weight"] = lp["mlp_norm_w"][i]
        for leaf, name in hf.items():
            out[pre + name + ".weight"] = lp[leaf][i].t()
    out["model.norm.weight"] = params["final_norm_w"]
    out["lm_head.weight"] = params["lm_head"].t()
    return out


def write_checkpoint(d: Path, tensors: dict, hf_config: dict, shards: int) -> float:
    """``tensors`` as one model.safetensors or as ``shards`` files with a
    model.safetensors.index.json, beside config.json; returns seconds."""
    from pygpukit_tpu_torch.llm import save_safetensors
    t0 = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf_config))
    names = list(tensors)
    if shards == 1:
        save_safetensors(d / "model.safetensors", tensors)
    else:
        weight_map, size = {}, 0
        for k in range(shards):
            part = names[k * len(names) // shards:(k + 1) * len(names) // shards]
            shard = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
            save_safetensors(d / shard, {n: tensors[n] for n in part})
            weight_map.update({n: shard for n in part})
            size += sum(tensors[n].numel() * tensors[n].element_size() for n in part)
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": size}, "weight_map": weight_map}))
    return time.perf_counter() - t0


def h2d_gbs(dev) -> float:
    """GB/s of one pinned H2D_BYTES host-to-device copy (CUDA events, the
    mean of three after a warm one): the yardstick of the load."""
    import torch
    host = torch.empty(H2D_BYTES, dtype=torch.uint8, pin_memory=True)
    buf = torch.empty(H2D_BYTES, dtype=torch.uint8, device=dev)
    buf.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        buf.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return 3 * H2D_BYTES / (start.elapsed_time(end) * 1e-3) / 1e9


def timed_load(d: Path, pinned: bool, dev):
    """(model, wall seconds) of load_model_from_safetensors(d) with pinned
    or pageable (PYGPUKIT_ASYNC_LOAD=0) copies, synchronized."""
    import os
    import torch
    from pygpukit_tpu_torch.llm import load_model_from_safetensors
    saved = os.environ.get("PYGPUKIT_ASYNC_LOAD")
    os.environ["PYGPUKIT_ASYNC_LOAD"] = "1" if pinned else "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = load_model_from_safetensors(d, max_seq_len=LOAD_MAX, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("PYGPUKIT_ASYNC_LOAD")
        else:
            os.environ["PYGPUKIT_ASYNC_LOAD"] = saved
    return model, secs


def host_copy_s(d: Path) -> float:
    """Seconds to copy every tensor of the checkpoint at ``d`` out of its
    map into one pinned buffer, the host's share of a pinned load."""
    import torch
    from pygpukit_tpu_torch.llm import load_safetensors
    with load_safetensors(d) as st:
        buf = torch.empty(max(st.info(k).nbytes for k in st.keys()), dtype=torch.uint8,
                          pin_memory=True)
        t0 = time.perf_counter()
        for k in st.keys():
            raw = st.tensor_raw(k)
            buf[:raw.numel()].copy_(raw)
        return time.perf_counter() - t0


def params_bitwise(a: dict, b: dict) -> bool:
    """Every leaf of two param trees the same dtype, shape and bytes."""
    from pygpukit_tpu_torch.llm.model import _flatten
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    if fa.keys() != fb.keys():
        return False
    return all((x is None and y is None) or (
        x is not None and y is not None and x.dtype == y.dtype and x.shape == y.shape
        and torch_equal_bits(x, y)) for x, y in ((fa[k], fb[k]) for k in fa))


def torch_equal_bits(x, y) -> bool:
    import torch
    x, y = x.reshape(-1).contiguous(), y.reshape(-1).contiguous()   # a 0-d leaf: one element
    return torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def chat_requests(tok, cfg) -> list:
    """LOAD_CHAT_NEW tokens after each ChatML prompt (CHAT_QUESTIONS under a
    system message, and one whose user message is TOKENIZER_TEXT repeated
    to LOAD_LONG tokens or more), encoded by the port's Tokenizer."""
    from pygpukit_tpu_torch.llm import apply_chat_template
    system = {"role": "system", "content": "You are a helpful assistant. Answer briefly."}
    prompts = [apply_chat_template([system, {"role": "user", "content": q}])
               for q in CHAT_QUESTIONS]
    long_text = TOKENIZER_TEXT
    while len(tok.encode(apply_chat_template([system, {"role": "user",
                                                       "content": long_text}]))) < LOAD_LONG:
        long_text += " " + TOKENIZER_TEXT
    prompts.append(apply_chat_template([system, {"role": "user", "content": long_text}]))
    requests = [(tok.encode(p), LOAD_CHAT_NEW) for p in prompts]
    check(all(0 <= t < cfg.vocab_size for ids, _ in requests for t in ids),
          "load: a prompt token is outside the vocabulary")
    return requests


def tok_agrees(tok, own, requests) -> bool:
    """The own byte-level BPE ``own`` (what serves where ``tokenizers``
    does not import) gives ``tok``'s ids and text on every prompt."""
    return all(own.encode(tok.decode(ids)) == ids and own.decode(ids) == tok.decode(ids)
               for ids, _ in requests)


def load_phase(cfg, dev, card: str) -> dict:
    """Phase 18: checkpoint loading and the chat path (module docstring).
    Returns the phase's launches by kernel."""
    import dataclasses
    import importlib.util
    import shutil
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, Tokenizer, fuse_params,
                                        init_params, quantize_model_params)
    from pygpukit_tpu_torch.llm.tokenizer import _ByteLevelBPE
    t0 = time.perf_counter()
    reset_counts()
    params = init_params(cfg, 0, torch.bfloat16, dev)
    src = CausalTransformerModel(cfg, fuse_params(params), dtype=torch.bfloat16)
    src.init_fixed_cache(LOAD_MAX)
    tensors = hf_llama_tensors(cfg, params)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    hf_config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                 "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                 "intermediate_size": cfg.intermediate_size,
                 "num_hidden_layers": cfg.num_layers,
                 "num_attention_heads": cfg.num_heads,
                 "num_key_value_heads": cfg.num_kv_heads,
                 "max_position_embeddings": cfg.max_position_embeddings,
                 "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                 "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    root = ROOT / "build" / "load_phase"
    shutil.rmtree(root, ignore_errors=True)
    single, sharded = root / "single", root / "sharded"
    try:
        rate = h2d_gbs(dev)
        w1 = write_checkpoint(single, tensors, hf_config, 1)
        write_tokenizer(single / "tokenizer.json", cfg.vocab_size)
        times = {}          # (what, copies) -> [seconds of each load]
        loaded = None
        for what, d, pinned in (("one file", single, True), ("one file", single, False),
                                ("one file", single, True), ("two shards", sharded, True),
                                ("two shards", sharded, True)):
            if what == "two shards" and not d.exists():
                (single / "model.safetensors").unlink()   # one checkpoint on disk at a time
                w2 = write_checkpoint(sharded, tensors, hf_config, 2)
            model, secs = timed_load(d, pinned, dev)
            check(dataclasses.asdict(model.config) == dataclasses.asdict(cfg)
                  and model.spec.name == "llama", f"load: config {model.config}")
            check(params_bitwise(model.params, src.params),
                  f"load: a leaf of the {what} load differs from the source's")
            times.setdefault((what, "pinned" if pinned else "pageable"), []).append(secs)
            if loaded is None:
                loaded = model
            del model
        host_s = host_copy_s(sharded)
        tok, own_bpe = Tokenizer(str(single)), _ByteLevelBPE(str(single / "tokenizer.json"))
        del tensors, params
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    loads = "; ".join(f"{what} {copies}: " + ", ".join(
        f"{t:.3f} s = {nbytes / t / 1e9:.2f} GB/s" for t in ts)
        for (what, copies), ts in times.items())
    print(f"phase 18: the 1.1B bf16 checkpoint, {nbytes / 1e9:.3f} GB, written in "
          f"{w1:.2f} s (one file) and {w2:.2f} s (two shards); loaded with max_seq_len "
          f"{LOAD_MAX} from the page cache (no disk read): {loads}; the host's copies out "
          f"of the map alone {host_s:.3f} s = {nbytes / host_s / 1e9:.2f} GB/s; pinned "
          f"{H2D_BYTES >> 20} MiB host-to-device copy {rate:.2f} GB/s; every leaf bitwise "
          f"the source model's fused leaf; tokenizer "
          f"{'HF tokenizers' if tok._hf is not None else 'own byte-level BPE'} "
          f"({tok.vocab_size} ids); ml_dtypes "
          f"{'present' if importlib.util.find_spec('ml_dtypes') else 'absent'}; [{card}]")

    ids = np.random.default_rng(18).integers(1, cfg.vocab_size, FWD_S).tolist()
    a, b = loaded(ids), src(ids)
    check(tuple(a.shape) == (FWD_S, cfg.vocab_size) and bool(torch.isfinite(a).all()),
          f"load: forward logits {tuple(a.shape)}")
    check(torch_equal_bits(a, b), "load: the loaded model's forward logits differ")
    del a, b
    requests = chat_requests(tok, cfg)
    check(tok_agrees(tok, own_bpe, requests), "load: the own byte-level BPE differs from the "
          "tokenizer's ids or text on a chat prompt")
    prompt = requests[0][0]
    g1 = loaded.generate(prompt, max_new_tokens=LOAD_NEW, chunk_size=GEN_CHUNK)
    g2 = src.generate(prompt, max_new_tokens=LOAD_NEW, chunk_size=GEN_CHUNK)
    check(len(g1) == LOAD_NEW and g1 == g2,
          f"load: generate after the load {g1[:8]}... against {g2[:8]}...")
    check(loaded.logits_finite(), "load: a generate logit went non-finite")

    old = [loaded.params["layers"][k][i].clone() for k in ("w_qkv", "w_down") for i in (0, -1)]
    old_refs = [loaded.params["layers"][k][i] for k in ("w_qkv", "w_down") for i in (0, -1)]
    for model in (loaded, src):
        model.params = quantize_model_params(model.params, "int4")
        check(not model.graphs.executables() and model.decode_buffers is None,
              "load: the params setter kept captured programs")
    q1 = loaded.generate(prompt, max_new_tokens=GEN_CHUNK, chunk_size=GEN_CHUNK)
    q2 = src.generate(prompt, max_new_tokens=GEN_CHUNK, chunk_size=GEN_CHUNK)
    check(q1 == q2, f"load: int4 generate after the params setter {q1} against {q2}")
    eng1, reqs1, secs = serve(loaded, requests, GEN_CHUNK)
    n_tok = check_served(eng1, reqs1, requests, "load (loaded)")
    eng2, reqs2, _ = serve(src, requests, GEN_CHUNK)
    check_served(eng2, reqs2, requests, "load (source)")
    streams = [r.generated for r in reqs1]
    check(streams == [r.generated for r in reqs2],
          "load: the loaded model's chat streams differ from the source's")
    texts = [tok.decode(s) for s in streams]
    check(all(isinstance(t, str) and t for t in texts), "load: a stream decoded to no text")
    check(all(torch.equal(x, y) for x, y in zip(old_refs, old)),
          "load: the bf16 weights changed after the params setter")
    launches = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    for name in ("w4a8_gemv", "w4a8_gemm", "batch_decode_attention", "flash_attention",
                 "flash_decode"):
        check(launches.get(name, 0) > 0, f"load: {name} never launched ({launches})")
    print(f"phase 18: 2048-token forward logits bitwise the source's; {LOAD_NEW} greedy "
          f"tokens identical; int4 through the params setter after those captures: a "
          f"{GEN_CHUNK}-token generate identical, then {len(requests)} ChatML requests "
          f"(prompts {min(len(p) for p, _ in requests)}-{max(len(p) for p, _ in requests)} "
          f"tokens) served by the batch-8 engine: {n_tok} tokens in {secs:.3f} s, streams "
          f"identical to the source model's; first stream decodes to {texts[0][:40]!r}; "
          f"the own byte-level BPE gives the tokenizer's ids and text on every prompt; "
          f"the bf16 weights unchanged; launches {json.dumps(launches)}; [{card}]")
    del eng1, eng2, loaded, src
    torch.cuda.empty_cache()
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the model families at their published widths
# ---------------------------------------------------------------------------

def family_entry(name: str) -> tuple:
    """(repository, config.json, layers run) of a phase-19 family, a
    phase-20 rope family or a phase-21 conventions family."""
    for table in (FAMILIES, ROPE_FAMILIES):
        if name in table:
            return table[name]
    return CONV_FAMILIES[name]


def family_config(name: str):
    """(TransformerConfig, config.json dict) of ``family_entry(name)``, its
    depth cut where the entry says so."""
    import dataclasses
    from pygpukit_tpu_torch.llm import TransformerConfig
    _, hf, layers = family_entry(name)
    cfg = TransformerConfig.from_hf_config(hf)
    if layers is not None:
        # the per-layer lists (Gemma-3's layer types, SmolLM3's NoPE
        # switches) cut with the depth
        cut = {k: getattr(cfg, k)[:layers] for k in ("layer_types", "rope_layers")
               if getattr(cfg, k) is not None}
        cfg = dataclasses.replace(cfg, num_layers=layers, **cut)
    return cfg, hf


def family_params(name: str, cfg, dev) -> dict:
    """init_params (seed 0, bf16) with the leaves it leaves at a constant
    drawn as a checkpoint has them: norm weights (pre, sandwich, q/k, final)
    in [0.5, 1.9], layernorm and MLP biases, the attention biases of Qwen2
    and GLM-4 (q, k, v) and GPT-2 and Phi-2 (q, k, v, o), Phi-2's lm-head
    bias, and Apertus's xIELU parameters about their initial values, which
    init_params does not make or keeps at a constant."""
    import torch
    from pygpukit_tpu_torch.llm import init_params
    params = init_params(cfg, 0, torch.bfloat16, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(19)

    def rnd(shape, std, dt):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dt)

    def around_one(t):
        return torch.clamp(1.0 + rnd(t.shape, 0.1, torch.float32), 0.5, 1.9)
    lp = params["layers"]
    for k in list(lp):
        if k.endswith("norm_w") or k in ("w_q_norm", "w_k_norm"):
            lp[k] = around_one(lp[k])
        elif k in ("attn_norm_b", "mlp_norm_b", "b_fc1", "b_fc2"):
            lp[k] = rnd(lp[k].shape, 0.02, lp[k].dtype)
    params["final_norm_w"] = around_one(params["final_norm_w"])
    if "final_norm_b" in params:
        params["final_norm_b"] = rnd(params["final_norm_b"].shape, 0.02, torch.float32)
    if name.startswith(("qwen2", "glm", "phi-2")) or name == "gpt2":
        nl, hq, hk, d = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for leaf, n in (("b_q", hq * d), ("b_k", hk * d), ("b_v", hk * d)):
            lp[leaf] = rnd((nl, n), 0.1, torch.bfloat16)
    if name in ("gpt2", "phi-2"):
        lp["b_o"] = rnd((cfg.num_layers, cfg.hidden_size), 0.02, torch.bfloat16)
    if name == "phi-2":
        params["lm_head_b"] = rnd((cfg.vocab_size,), 0.1, torch.float32)
    for leaf in ("act_alpha_p", "act_alpha_n", "act_beta"):
        if leaf in lp:
            lp[leaf] = lp[leaf] + rnd(lp[leaf].shape, 0.05, torch.float32)
    return params


def kernel_layers(cfg, n_keys: int) -> int:
    """Layers whose uncached and single-stream attention over ``n_keys``
    keys (the forward's length, the cache's rows) take flash_attention and
    flash_decode: no softcap, no window shorter than the keys, the
    kernels' scale."""
    from pygpukit_tpu_torch.llm.model import _layer_window
    from pygpukit_tpu_torch.ops.nn.attention import effective_window, flash_attention_route
    return sum(flash_attention_route("cuda", cfg.attn_scale, cfg.head_dim,
                                     cfg.attn_logit_softcap,
                                     effective_window(_layer_window(cfg, i), n_keys),
                                     cfg.num_heads, cfg.num_kv_heads) == "kernel"
               for i in range(cfg.num_layers))


def hf_family_tensors(spec, cfg, params: dict) -> dict:
    """The checkpoint of an unfused tree under ``spec``'s names (the
    loader's inverse): projections [out, in] (GPT-2's Conv1D [in, out], its
    q|k|v one c_attn tensor and bias), Gemma's norm weights less one (its
    checkpoints store w of an effective 1 + w; exact for w in [0.5, 2]); no
    input norms where the spec has none (OLMo-2), the q, k, v and head
    biases where the tree has them (Phi-2)."""
    import torch
    lp = params["layers"]

    def lin(w):
        return w.t() if spec.hf_linear_layout else w

    def norm(w):
        return w - 1.0 if spec.norm_plus_one else w
    out = {spec.embed_tokens: params["embed"], spec.final_norm: norm(params["final_norm_w"])}
    if spec.position_embed:
        out[spec.position_embed] = params["pos_embed"]
    if spec.final_norm_bias:
        out[spec.final_norm_bias] = params["final_norm_b"]
    if spec.lm_head and params.get("lm_head") is not None:
        out[spec.lm_head] = params["lm_head"].t()
        if spec.lm_head_bias and "lm_head_b" in params:
            out[spec.lm_head_bias] = params["lm_head_b"]
    for i in range(cfg.num_layers):
        def put(template, t):
            out[template.format(layer=i)] = t
        for template, leaf in ((spec.attn_norm, "attn_norm_w"), (spec.mlp_norm, "mlp_norm_w")):
            if template and leaf in lp:
                put(template, norm(lp[leaf][i]))
        for template, leaf in ((spec.attn_norm_bias, "attn_norm_b"),
                               (spec.mlp_norm_bias, "mlp_norm_b"), (spec.o_bias, "b_o"),
                               (spec.fc1_bias, "b_fc1"), (spec.fc2_bias, "b_fc2")):
            if template and leaf in lp:
                put(template, lp[leaf][i])
        for template, leaf in ((spec.post_attn_norm, "post_attn_norm_w"),
                               (spec.post_mlp_norm, "post_mlp_norm_w"),
                               (spec.q_norm, "w_q_norm"), (spec.k_norm, "w_k_norm")):
            if template:
                put(template, norm(lp[leaf][i]))
        if spec.qkv_combined:
            put(spec.q_proj, lin(torch.cat([lp[k][i] for k in ("w_q", "w_k", "w_v")], dim=1)))
            if spec.q_bias:
                put(spec.q_bias, torch.cat([lp[k][i] for k in ("b_q", "b_k", "b_v")]))
        else:
            for template, leaf in ((spec.q_proj, "w_q"), (spec.k_proj, "w_k"),
                                   (spec.v_proj, "w_v")):
                put(template, lin(lp[leaf][i]))
            for template, leaf in ((spec.q_bias, "b_q"), (spec.k_bias, "b_k"),
                                   (spec.v_bias, "b_v")):
                if template and leaf in lp:
                    put(template, lp[leaf][i])
        put(spec.o_proj, lin(lp["w_o"][i]))
        if spec.gate_up_combined:              # Phi-3: one gate_up_proj, gate rows first
            put(spec.gate_proj, lin(torch.cat([lp["w_gate"][i], lp["w_up"][i]], dim=1)))
            put(spec.down_proj, lin(lp["w_down"][i]))
            continue
        mlp = (((spec.fc1, "w_fc1"), (spec.fc2, "w_fc2")) if spec.fc1 else
               ((spec.gate_proj, "w_gate"), (spec.up_proj, "w_up"), (spec.down_proj, "w_down")))
        for template, leaf in mlp:
            put(template, lin(lp[leaf][i]))
    return out


def family_checkpoint(name: str, cfg, hf: dict, params: dict, src, ids, logits, dev) -> str:
    """The round trip: ``params`` written under the family's Hugging Face
    names by save_safetensors with its config.json, loaded by
    load_model_from_safetensors on the card: the config and every leaf
    bitwise the source model's, the forward logits bitwise ``logits`` (the
    source model's on ``ids``). Returns the report."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import MODEL_SPECS, load_model_from_safetensors
    spec = MODEL_SPECS[FAM_SPEC[name]]
    d = ROOT / "build" / "families_phase" / name
    shutil.rmtree(d, ignore_errors=True)
    # the config.json of the layers run (a depth cut writes its own count)
    hf = dict(hf, **{"n_layer" if "n_layer" in hf else "num_hidden_layers": cfg.num_layers})
    try:
        secs_w = write_checkpoint(d, hf_family_tensors(spec, cfg, params), hf, 1)
        nbytes = (d / "model.safetensors").stat().st_size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_model_from_safetensors(d, device=dev)
        torch.cuda.synchronize()
        secs_l = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(loaded.spec.name == spec.name
          and dataclasses.asdict(loaded.config) == dataclasses.asdict(cfg),
          f"families {name}: the loaded config {loaded.config}")
    check(params_bitwise(loaded.params, src.params),
          f"families {name}: a loaded leaf differs from the source model's")
    again = loaded.get_logits(ids)
    check(np.array_equal(again.view(np.uint32), logits.view(np.uint32)),
          f"families {name}: the loaded model's logits differ from the source's")
    del loaded, again
    return (f"checkpoint {nbytes / 1e9:.3f} GB written in {secs_w:.2f} s, loaded in "
            f"{secs_l:.2f} s, every leaf and the forward logits bitwise the source's")


#: the dense matmul leaves the CPU reference models hold in f32
CPU_F32_LEAVES = ("w_qkv", "w_q", "w_k", "w_v", "w_o", "w_gate_up", "w_gate", "w_up",
                  "w_down", "w_fc1", "w_fc2", "w_experts_gate", "w_experts_up",
                  "w_experts_down")


def cpu_f32_weights(layers: dict) -> dict:
    """``layers`` with its dense bf16 matmul leaves (CPU_F32_LEAVES) as f32
    copies: the plain path multiplies ``x.float() @ w.float()`` at every
    call, so an f32 leaf is the same product of the same operands, its
    conversion made once instead of at each call (quantized dict leaves,
    norms and biases are kept as they are)."""
    import torch
    return {k: (v.float() if k in CPU_F32_LEAVES and isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v) for k, v in layers.items()}


def family_cpu_slice(name: str, cfg, params: dict, dev) -> str:
    """The first FAM_SLICE layers (2; Gemma-3 6, its first global layer
    among them) on the card against the CPU plain path, on a FAM_SLICE_S
    prompt: the bf16 forward (relative L2 within FWD_TOL), bf16 prefill
    and four decode steps (FWD_TOL), the int4 model's prefill and four
    decode steps (REF_TOL). MoE: the bf16 forward only, held row by row as
    phase 14 holds Mixtral's (MOE_ROWS_Q: the card's gmm and the CPU's
    dense route round at other points, so a router near-tie moves a row).
    LongRoPE (FAM_SLICE_THRESHOLD): the slice's original_max is scaled
    down below the prompt, so both sides take the long tables. The CPU
    model holds a dense head (a tied one: the embedding, transposed) as the
    f32 copy that the plain path's _logits makes of it at every call: the
    same operands of the same product, converted once instead of at each
    of its eleven calls (the conversions of a 256000-row head took most of
    the slice's time), and its dense matmul leaves as f32 copies likewise
    (``cpu_f32_weights``). Returns the report."""
    import dataclasses
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, fuse_params,
                                        quantize_model_params, slice_layers)
    n = FAM_SLICE.get(name, 2)
    small = dataclasses.replace(cfg, num_layers=n)
    if name in FAM_SLICE_THRESHOLD:
        small = dataclasses.replace(small, rope_scaling=dict(
            cfg.rope_scaling, original_max_position_embeddings=FAM_SLICE_THRESHOLD[name]))
    tree = slice_layers(params, n)
    ids = np.random.default_rng(191).integers(1, cfg.vocab_size, FAM_SLICE_S).tolist()
    out = []
    cpu_s = 0.0                          # wall seconds of the CPU model's calls

    def on_cpu(fn, *args):
        nonlocal cpu_s
        t1 = time.perf_counter()
        r = fn(*args)
        cpu_s += time.perf_counter() - t1
        return r
    t0 = time.perf_counter()
    for mode, tol in ((None, FWD_TOL),) + ((("int4", REF_TOL),) if not cfg.is_moe else ()):
        t = tree if mode is None else quantize_model_params(tree, mode)
        card = CausalTransformerModel(small, fuse_params(t), dtype=torch.bfloat16)
        ct = fuse_params(t)
        head = ct["embed"].t() if ct.get("lm_head") is None else ct["lm_head"]
        if isinstance(head, torch.Tensor):
            ct["lm_head"] = head.float().contiguous()
        ct["layers"] = cpu_f32_weights(ct["layers"])
        cpu = CausalTransformerModel(small, ct, dtype=torch.bfloat16).to("cpu")
        del ct, head
        errs = []
        if mode is None:
            lc, lr = card.get_logits(ids), on_cpu(cpu.get_logits, ids)
            rows = np.linalg.norm(lc - lr, axis=1) / np.linalg.norm(lr, axis=1)
            errs.append(float(np.quantile(rows, MOE_ROWS_Q)) if cfg.is_moe else
                        float(np.linalg.norm(lc - lr) / np.linalg.norm(lr)))
        if not cfg.is_moe:
            for m in (card, cpu):
                m.init_fixed_cache(128)
            lc, lr = card.prefill(ids), on_cpu(cpu.prefill, ids)
            for step in range(5):
                lc = lc.cpu()
                errs.append(((lc - lr).norm() / lr.norm()).item())
                if step < 4:
                    tok = int(lc.argmax())
                    lc, lr = card.decode_step(tok), on_cpu(cpu.decode_step, tok)
        check(max(errs) <= tol, f"families {name}: {n}-layer {mode or 'bf16'} card vs CPU "
              f"relative L2 {max(errs):.3e} (limit {tol})")
        out.append(f"{mode or 'bf16'} {[f'{e:.2e}' for e in errs]} (limit {tol})")
        del card, cpu
    what = (f"forward rows' {MOE_ROWS_Q} quantile" if cfg.is_moe else
            "forward, prefill and four decode steps")
    past = (f" (original_max {FAM_SLICE_THRESHOLD[name]}, the {FAM_SLICE_S}-token prompt "
            f"past it)" if name in FAM_SLICE_THRESHOLD else "")
    return (f"{n}-layer slice{past}, card vs CPU plain path, relative L2 of the {what}: "
            + "; ".join(out) + f" ({time.perf_counter() - t0:.1f} s, the CPU model's calls "
            f"{cpu_s:.1f} s)")


def family_requests(name: str, cfg, rng) -> list:
    """FAM_REQS requests of FAM_REQ_NEW new tokens: 16- and 200-token
    prompts, the first FAM_LONG[name] ones past the family's window."""
    n_long, lo, hi = FAM_LONG.get(name, (0, 0, 0))
    out = []
    for i in range(FAM_REQS):
        n = int(rng.integers(lo, hi + 1)) if i < n_long else (16 if i % 2 == 0 else 200)
        out.append((rng.integers(1, cfg.vocab_size, n).tolist(), FAM_REQ_NEW))
    return out


def family_run(name: str, dev, card: str, rng, phase: str = "19") -> dict:
    """One family of phase 19 (``families_phase``) or phase 20
    (``rope_phase``). Returns the launches of its main-path runs by
    kernel."""
    import gc
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, forward_fn, fuse_params,
                                        quantize_model_params)
    t0 = time.perf_counter()
    # what earlier phases and families left in reference cycles (engines,
    # their captured programs and pools) goes before the next family's
    # engines: Gemma-2's take about 20 GB beside its weights
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    cfg, hf = family_config(name)
    params = family_params(name, cfg, dev)
    model = CausalTransformerModel(cfg, fuse_params(params), dtype=torch.bfloat16)
    s_len = FAM_FWD_S.get(name, FWD_S)
    n_fa, n_fd = kernel_layers(cfg, s_len), kernel_layers(cfg, FAM_GEN_MAX)
    total: dict = {}
    # wall seconds by section (the host's clock; what a family's run spends)
    secs: dict = {}
    t_lap = [t0]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    lap("build")

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    # the uncached forward
    ids = rng.integers(1, cfg.vocab_size, s_len).tolist()
    tokens = torch.tensor(ids, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    out = forward_fn(cfg, model.params, tokens)
    torch.cuda.synchronize()
    launches = launch_counts()
    reset_counts()
    add(launches)
    check(tuple(out.shape) == (s_len, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          f"families {name}: forward logits {tuple(out.shape)}")
    check(launches["flash_attention"] == n_fa,
          f"families {name}: flash_attention launched {launches['flash_attention']} "
          f"times in the forward, expected {n_fa}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()                          # the second forward, timed (eager)
    again = forward_fn(cfg, model.params, tokens)
    end.record()
    end.synchronize()
    fwd_ms = start.elapsed_time(end)
    check(torch.equal(out, again), f"families {name}: a second forward differs")
    del again
    logits = out.cpu().numpy()
    del out
    lap("forward")
    # single-stream bf16 generate, warm (capturing) then timed (replaying)
    prompt = ids[:FAM_PROMPT]
    runs = []
    for _ in range(2):
        zero_cache(model, FAM_GEN_MAX)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        toks = model.generate(prompt, max_new_tokens=FAM_NEW, chunk_size=GEN_CHUNK)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t1, launch_counts()))
    reset_counts()
    (toks1, _, _), (toks2, gen_s, gen_l) = runs
    add(gen_l)
    check(toks1 == toks2 and len(toks2) == FAM_NEW and model.logits_finite(),
          f"families {name}: generate's replayed tokens differ or a logit is not finite")
    check(gen_l["flash_decode"] == n_fd * (FAM_NEW - 1),
          f"families {name}: flash_decode launched {gen_l['flash_decode']} times in "
          f"generate, expected {n_fd * (FAM_NEW - 1)}")
    report = [f"forward {s_len} tokens {fwd_ms:.2f} ms = {s_len / fwd_ms * 1e3:.0f} tok/s "
              f"({n_fa} flash_attention launches); generate {FAM_NEW} tokens "
              f"{FAM_NEW / gen_s:.1f} tok/s, replay identical ({gen_l['flash_decode']} "
              f"flash_decode launches)"]
    lap("generate")
    if name in FAM_FUSED:
        report.append(family_fused(name, cfg, params, prompt, total))
        lap("fused")
    if name in FAM_CHECKPOINT:
        report.append(family_checkpoint(name, cfg, hf, params, model, ids, logits, dev))
        lap("checkpoint")
    # a model is a reference cycle (its captured programs hold it): collect
    # the bf16 models before the engines' pools (Phi-3.5's are 26 GB a pair)
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    report.append(family_cpu_slice(name, cfg, params, dev))
    gc.collect()
    lap("cpu slice")
    # the int4 engines, dense and paged, each served twice and every program
    # replayed against one eager call
    model = CausalTransformerModel(cfg, fuse_params(quantize_model_params(params, "int4")),
                                   dtype=torch.bfloat16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held_engines = torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    lap("int4 model")
    requests = family_requests(name, cfg, rng)
    mx = FAM_MAX.get(name, FAM_MAX_DEFAULT)
    # the prefill waves the engine can form: up to 4 a bucket from the
    # alternating 16/200-token prompts of 8 free slots, and of the long
    # prompts as many as there are (FAM_LONG)
    n_long = FAM_LONG.get(name, (0,))[0]
    plan = [(sorted({len(p) for p, _ in requests[n_long:]}), [2, 4])]
    if n_long:
        plan.append((sorted({len(p) for p, _ in requests[:n_long]}),
                     [w for w in (2, 4) if w <= n_long]))
    streams = {}
    for what, kw in (("dense engine", {}),
                     ("paged pipelined engine", dict(pipelined=True, paged=True,
                                                     block_size=16))):
        stats: dict = {}
        launches = graphs_engine(model, requests, 16, f"{name} {what}", rng, card, phase,
                                 stats, 1, max_seq_len=mx, warm_plan=plan, **kw)
        streams[what] = stats["streams"]
        # the engine's pools and programs go before the next one's (Phi-3.5's
        # dense pools at MAX 8192 are 26 GB)
        gc.collect()
        torch.cuda.empty_cache()
        add(launches)
        attention = "paged_attention" if kw else "batch_decode_attention"
        for kernel in ("w4a8_gemv", attention) + (("gmm",) if cfg.is_moe else ()):
            check(launches.get(kernel, 0) > 0,
                  f"families {name} {what}: {kernel} never launched ({launches})")
        if not kw:
            check(launches["kv_rows_write_fused"] == launches["batch_decode_attention"],
                  f"families {name}: a batch attention launch wrote no rows")
        report.append(f"{what} {stats['tok_s']:.1f} tok/s (again {stats['tok_s_again']:.1f}), "
                      f"TTFT p50/p95 {stats['ttft_ms'][0]:.1f}/{stats['ttft_ms'][1]:.1f} ms")
        lap(what)
    if name in FAM_ENGINES_EQUAL:
        # LongRoPE: rows on both sides of the threshold in one batch
        check(streams["dense engine"] == streams["paged pipelined engine"],
              f"families {name}: the dense and paged engines' streams differ")
        report.append("dense and paged engines' streams identical")
    # the tied f32 head's share of one batch-8 decode step
    _, step_ms, _, _ = decode_step_times(model, 8, mx, 300, profile=False)
    h = torch.randn((8, cfg.hidden_size), device=dev).to(torch.bfloat16)
    from pygpukit_tpu_torch.llm.model import _logits
    head_ms = time_ms(lambda i: _logits(cfg, model.params, h), 1, reps=5)
    report.append(f"batch-8 decode step at context 301 {step_ms:.3f} ms device, the "
                  f"{'tied f32' if model.params.get('lm_head') is None else 'int8'} head "
                  f"{head_ms:.3f} ms of it ({head_ms / step_ms:.3f})")
    del model
    torch.cuda.empty_cache()
    lap("step and head")
    report.append(f"{time.perf_counter() - t0:.1f} s ({held:.2f} GB allocated before it, "
                  f"{held_engines:.2f} GB before the engines; by section {json.dumps(secs)})")
    print(f"phase {phase}: {name} ({family_entry(name)[0]}, {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}): "
          + "; ".join(report) + f"; launches {json.dumps({k: n for k, n in total.items() if n})}"
          + f" [{card}]")
    return total


# the family attention rows against their plain versions: rows 5/6 and 17
# at (Hq, Hk, D, softcap, window), B 8, MAX 8192 and ATTN_LENS, row 14 at
# (Hq, Hk) over FWD_S tokens, row 15 at (Hq, Hk, MAX, ctx, layers)
ATTN_LENS, ATTN_MAX = (1, 700, 4096, 4097, 4300, 6000, 8192, 9000), 8192
ATTN_ROWS = {
    # Gemma-2-2B's softcap and window; Gemma-3-1B's global layers
    "d256": dict(rows=(8, 4, 256, 50.0, 4096), flash=(4, 1), decode=(4, 1, 1024, 700, 26),
                 phase="19"),
    # Phi-3.5-mini (its 262144 window masks nothing: none); row 15 at the
    # long prompts' context in its 8192-row cache
    "d96": dict(rows=(32, 32, 96, None, None), flash=(32, 32),
                decode=(32, 32, 8192, 4200, 8), phase="20"),
    # Phi-2 at its whole context: rows 5/6 and 17 at MAX 2048 (contexts of
    # one row to past MAX), row 15 at the long prompts' context
    "d80": dict(rows=(32, 32, 80, None, None), flash=(32, 32),
                decode=(32, 32, 2048, 1900, 8), phase="21", max=2048,
                lens=(1, 300, 1024, 1025, 1500, 1700, 2048, 2300)),
}


def attention_rows(dev, detail: dict, tag: str) -> dict:
    """The four kernels at ATTN_ROWS[tag]'s shapes against their plain
    versions (ATTN_TOL), a second launch bitwise, timed beside the plain
    version and SDPA with their bounds: rows 5/6 written and read by
    kv_write_attention (its pools bitwise the plain write), with and
    without the window; row 17 over shuffled blocks (block 16); row 14 a
    causal forward; row 15 one query, with a graph replayed at device
    contexts. Returns the kernels line's rows (``<kernel>_<tag>``)."""
    import torch
    from pygpukit_tpu_torch.kernels import (batch_decode_attention,
                                            batch_decode_attention_plain, flash_attention,
                                            flash_attention_plain, flash_decode,
                                            flash_decode_plain, kv_rows_write_plain,
                                            kv_write_attention, paged_attention,
                                            paged_attention_plain)
    from pygpukit_tpu_torch.kernels.paged_attention import _paged_gather
    shapes = ATTN_ROWS[tag]
    g = torch.Generator(device=dev)
    g.manual_seed(1919)
    res = {}
    hq, hk, d, cap, win = shapes["rows"]
    b, nl, mx = 8, 4, shapes.get("max", ATTN_MAX)
    lanes, scale = hk * d, d ** -0.5
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, hk, d), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, hk, d), generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor(shapes.get("lens", ATTN_LENS), dtype=torch.int32, device=dev)
    err = 0.0
    for window in dict.fromkeys((win, None)):
        k1, v1, k2, v2 = kp[:, 1:3].clone(), vp[:, 1:3].clone(), kp[:, 1:3].clone(), \
            vp[:, 1:3].clone()
        o = kv_write_attention(q, k1, v1, kn, vn, 1, lens - 1, lens, scale=scale,
                               softcap=cap, window=window)
        kv_rows_write_plain(k2, v2, kn, vn, 1, lens - 1)
        check(torch.equal(bits(k1), bits(k2)) and torch.equal(bits(v1), bits(v2)),
              f"{tag} kv_write_attention: the pools differ from the plain write")
        r = batch_decode_attention_plain(q, k2, v2, 1, lens, scale, cap, window)
        err = max(err, _attn_err(o, r, "bf16", f"{tag} batch attention window {window}"))
        check(torch.equal(o, batch_decode_attention(q, k1, v1, 1, lens, scale, cap, window)),
              f"{tag} batch attention: a second launch differs")
        del k1, v1, k2, v2
    live = lens.clamp(max=mx)
    lo = (lens - win).clamp(min=0) if win else torch.zeros_like(lens)
    n_live = int((live - lo).clamp(min=0).sum())
    pos = torch.arange(mx, device=dev)[None, :]
    mask = ((pos < live[:, None]) & (pos >= lo[:, None]))[:, None, None, :]

    def library(i):
        kk = kp[:, i].view(b, mx, hk, d).transpose(1, 2)
        vv = vp[:, i].view(b, mx, hk, d).transpose(1, 2)
        sdpa(q.transpose(1, 2), kk, vv, attn_mask=mask, scale=scale)
    kms = time_ms(lambda i: batch_decode_attention(q, kp, vp, i, lens, scale, cap, win), nl)
    pms = time_ms(lambda i: batch_decode_attention_plain(q, kp, vp, i, lens, scale, cap,
                                                         win), nl, reps=2)
    lms = time_ms(library, nl)
    res[f"batch_decode_attention_{tag}"] = kernel_row(
        err, kms, pms, 2 * n_live * lanes * 2 + 2 * q.numel() * 2 + 4 * b,
        4 * hq * d * n_live, "bf16", lms)
    del kp, vp
    torch.cuda.empty_cache()
    # row 17 at the same heads over shuffled blocks (the rows' MAX, block 16)
    bs, mb = 16, mx // 16
    nb = b * mb + 2
    kpool = torch.randn((nl, nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    vpool = torch.randn((nl, nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    qp = q[:, 0].contiguous()
    perm = torch.randperm(nb - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm[:b * mb].reshape(b, mb).contiguous()
    plens = lens.clamp(max=mx)
    o = paged_attention(qp, kpool[1], vpool[1], tables, plens, scale, cap, win)
    err = _attn_err(o, paged_attention_plain(qp, kpool[1], vpool[1], tables, plens, scale,
                                             cap, win), "bf16", f"{tag} paged attention")
    check(torch.equal(o, paged_attention(qp, kpool[1], vpool[1], tables, plens, scale, cap,
                                         win)), f"{tag} paged attention: a second launch differs")
    seqs = [(_paged_gather(kpool[i], tables), _paged_gather(vpool[i], tables))
            for i in range(nl)]
    kms = time_ms(lambda i: paged_attention(qp, kpool[i], vpool[i], tables, plens, scale, cap,
                                            win), nl)
    pms = time_ms(lambda i: paged_attention_plain(qp, kpool[i], vpool[i], tables, plens,
                                                  scale, cap, win), nl, reps=2)
    lms = time_ms(lambda i: sdpa(qp[:, :, None], seqs[i][0], seqs[i][1], attn_mask=mask,
                                 scale=scale), nl)
    res[f"paged_attention_{tag}"] = kernel_row(
        err, kms, pms, 2 * n_live * lanes * 2 + 2 * qp.numel() * 2 + 4 * b * (mb + 1),
        4 * hq * d * n_live, "bf16", lms)
    del kpool, vpool, seqs
    torch.cuda.empty_cache()
    # row 14: a causal forward of FWD_S tokens
    s_len, (hq, hk) = FWD_S, shapes["flash"]
    n_var = 4
    qs = [torch.randn((s_len, hq, d), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(n_var)]
    ks = [torch.randn((s_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(n_var)]
    vs = [torch.randn((s_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(n_var)]
    o = flash_attention(qs[0], ks[0], vs[0])
    err = _attn_err(o, flash_attention_plain(qs[0], ks[0], vs[0]), "bf16",
                    f"{tag} flash_attention")
    check(torch.equal(o, flash_attention(qs[0], ks[0], vs[0])),
          f"{tag} flash_attention: a second launch differs")
    kms = time_ms(lambda i: flash_attention(qs[i], ks[i], vs[i]), n_var)
    pms = time_ms(lambda i: flash_attention_plain(qs[i], ks[i], vs[i]), n_var, reps=2)
    lms = time_ms(lambda i: sdpa(qs[i].transpose(0, 1)[None], ks[i].transpose(0, 1)[None],
                                 vs[i].transpose(0, 1)[None], is_causal=True), n_var)
    pairs = s_len * (s_len + 1) / 2
    res[f"flash_attention_{tag}"] = kernel_row(err, kms, pms,
                                               (2 * hq + 2 * hk) * s_len * d * 2,
                                               4 * hq * d * pairs, "bf16", lms)
    del qs, ks, vs
    # row 15: one query over ctx rows of a MAX-row cache, layers cycled
    hq, hk, max_len, ctx, nl = shapes["decode"]
    kc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
    q1 = torch.randn((1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    o = flash_decode(q1, kc[3], vc[3], ctx)
    err = _attn_err(o, flash_decode_plain(q1, kc[3], vc[3], ctx), "bf16", f"{tag} flash_decode")
    check(torch.equal(o, flash_decode(q1, kc[3], vc[3], ctx)),
          f"{tag} flash_decode: a second launch differs")
    decode_graph_replay(q1, kc[3], vc[3], "bf16")
    kms = time_ms(lambda i: flash_decode(q1, kc[i], vc[i], ctx), nl)
    pms = time_ms(lambda i: flash_decode_plain(q1, kc[i], vc[i], ctx), nl)
    lms = time_ms(lambda i: sdpa(q1.transpose(0, 1)[None], kc[i, :ctx].permute(1, 0, 2)[None],
                                 vc[i, :ctx].permute(1, 0, 2)[None]), nl)
    res[f"flash_decode_{tag}"] = kernel_row(err, kms, pms, (2 * ctx * hk * d + 2 * hq * d) * 2,
                                            4 * hq * d * ctx, "bf16", lms)
    del kc, vc
    torch.cuda.empty_cache()
    for name, row in res.items():
        detail[name] = dict(row, share=row["bound_ms"] / row["ms"])
        print(f"phase {shapes['phase']}: {name}: kernel {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.5f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}) = share "
              f"{row['bound_ms'] / row['ms']:.3f}; max abs err {row['max_abs_err']:.3e} "
              f"[{CARD}]")
    return res


def family_fused(name: str, cfg, params: dict, prompt: list, total: dict) -> str:
    """Row 18 on scaled tables: a model of separate bf16 leaves (the fused
    kernel's layout) under PYGPUKIT_DECODE=fused, a FAM_NEW-token generate
    warm then replayed (identical, one fused_decode launch a step and no
    flash_decode); then at the prompt's end and after the generate, the
    fused step's logits against the unfused step's from the same cache
    (relative L2 within FUSED_DEEP_TOL, phase 3's bound for the fused
    kernel's drift with depth). Adds the timed run's launches to ``total``.
    Returns the report."""
    import os
    import torch
    from pygpukit_tpu_torch.llm import CausalTransformerModel
    from pygpukit_tpu_torch.llm.model import use_fused_decode
    old = os.environ.get("PYGPUKIT_DECODE")
    os.environ["PYGPUKIT_DECODE"] = "fused"
    try:
        model = CausalTransformerModel(cfg, params, dtype=torch.bfloat16)
        check(use_fused_decode(cfg, model.params, FAM_GEN_MAX),
              f"families {name}: the fused step refuses the model")
        runs = []
        for _ in range(2):
            zero_cache(model, FAM_GEN_MAX)
            torch.cuda.synchronize()
            reset_counts()
            t1 = time.perf_counter()
            toks = model.generate(prompt, max_new_tokens=FAM_NEW, chunk_size=GEN_CHUNK)
            torch.cuda.synchronize()
            runs.append((toks, time.perf_counter() - t1, launch_counts()))
        reset_counts()
        (toks1, _, _), (toks2, secs, launches) = runs
        check(toks1 == toks2 and model.logits_finite(),
              f"families {name}: the fused generate's replay differs or a logit is not finite")
        check(launches.get("fused_decode", 0) == FAM_NEW - 1
              and launches.get("flash_decode", 0) == 0,
              f"families {name}: fused generate launches {launches}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        errs, agree = [], []
        for ctx in (prompt, prompt + toks2):
            zero_cache(model, FAM_GEN_MAX)
            tok = int(model.prefill(ctx).argmax())
            snap = model.snapshot_kv_cache()
            fused = model.decode_step(tok).float().clone()
            model.restore_kv_cache(snap)
            os.environ["PYGPUKIT_DECODE"] = ""
            plain = model.decode_step(tok).float().clone()
            os.environ["PYGPUKIT_DECODE"] = "fused"
            errs.append(rel_l2(fused, plain))
            agree.append(int(fused.argmax()) == int(plain.argmax()))
        check(max(errs) <= FUSED_DEEP_TOL, f"families {name}: fused vs unfused step relative "
              f"L2 {errs} (limit {FUSED_DEEP_TOL})")
        del model
    finally:
        if old is None:
            os.environ.pop("PYGPUKIT_DECODE", None)
        else:
            os.environ["PYGPUKIT_DECODE"] = old
    return (f"fused route (PYGPUKIT_DECODE=fused): generate {FAM_NEW} tokens "
            f"{FAM_NEW / secs:.1f} tok/s, replay identical, {launches['fused_decode']} "
            f"fused_decode launches; fused vs unfused step at positions {len(prompt)} and "
            f"{len(prompt) + FAM_NEW}: relative L2 {[f'{e:.2e}' for e in errs]} (limit "
            f"{FUSED_DEEP_TOL}), argmax agrees {agree}")


def pope_alibi_check(dev) -> str:
    """PoPE (pope_init_encoding, pope_inplace) and ALiBi (alibi_init_slopes,
    alibi_compute_bias, alibi_add_bias) through the Array API on the card
    against the CPU, one call each on seeded f32 inputs at Phi-3.5's heads:
    within 1e-5 (f32 sin and cos of two libraries)."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.core.array import Array
    from pygpukit_tpu_torch.ops.nn import (alibi_add_bias, alibi_compute_bias,
                                           alibi_init_slopes, pope_init_encoding, pope_inplace)
    rng = np.random.default_rng(20)
    q = rng.standard_normal((512, 32, 96)).astype(np.float32)
    k = rng.standard_normal((512, 32, 96)).astype(np.float32)
    sc = rng.standard_normal((32, 512, 512)).astype(np.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        enc = pope_init_encoding(4096, 96, 10000.0, device=d)
        qa, ka = Array(torch.from_numpy(q).to(d)), Array(torch.from_numpy(k).to(d))
        pope_inplace(qa, ka, enc, start_pos=100)
        slopes = alibi_init_slopes(32, device=d)
        bias = alibi_compute_bias(512, 32, slopes)
        scores = Array(torch.from_numpy(sc).to(d))
        alibi_add_bias(scores, slopes)
        out.append([a.torch.cpu() for a in (enc, qa, ka, slopes, bias, scores)])
    err = max((a - b).abs().max().item() for a, b in zip(*out))
    check(err <= 1e-5, f"rope: PoPE/ALiBi card vs CPU max abs err {err:.3e}")
    return f"PoPE and ALiBi on the card against the CPU: max abs err {err:.3e}"


def rope_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 20 (``--phases rope``; module docstring). Returns (the D96_ROWS
    rows' launches on Phi-3.5-mini's main path, all of them at D 96, and
    their kernels-line numbers)."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    runs = {}
    for name in ROPE_FAMILIES:
        runs[name] = family_run(name, dev, card, rng, "20")
    check(runs["llama-3.2-1b"].get("fused_decode", 0) > 0,
          "rope: fused_decode never launched on Llama-3.2-1B's llama3 tables")
    print("phase 20: " + pope_alibi_check(dev) + f" [{card}]")
    detail: dict = {}
    results = attention_rows(dev, detail, "d96")
    launches = {row: runs[fam].get(base, 0) for row, (base, fam) in D96_ROWS.items()}
    for row, n in launches.items():
        check(n > 0, f"rope: {row} never launched on {D96_ROWS[row][1]}'s path")
    print("phase 20: d96 " + json.dumps(detail))
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    return launches, results


def conventions_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 21 (``--phases conventions``; module docstring). Returns (the
    D80_ROWS rows' launches on Phi-2's main path, all of them at D 80, and
    their kernels-line numbers)."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    runs = {}
    for name in CONV_FAMILIES:
        runs[name] = family_run(name, dev, card, rng, "21")
    detail: dict = {}
    results = attention_rows(dev, detail, "d80")
    launches = {row: runs[fam].get(base, 0) for row, (base, fam) in D80_ROWS.items()}
    for row, n in launches.items():
        check(n > 0, f"conventions: {row} never launched on {D80_ROWS[row][1]}'s path")
    print("phase 21: d80 " + json.dumps(detail))
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    return launches, results


def families_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 19 (``--phases families``; module docstring). Returns (the
    D256_ROWS rows' launches: the kernel's launches on its family's main
    path, all of them at D 256, and their kernels-line numbers)."""
    import numpy as np
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    runs = {}
    for name in FAMILIES:
        runs[name] = family_run(name, dev, card, rng)
    detail: dict = {}
    results = attention_rows(dev, detail, "d256")
    launches = {row: runs[fam].get(base, 0) for row, (base, fam) in D256_ROWS.items()}
    for row, n in launches.items():
        check(n > 0, f"families: {row} never launched on {D256_ROWS[row][1]}'s path")
    print("phase 19: d256 " + json.dumps(detail))
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s")
    return launches, results


# phase 22: the standalone families (llm.models) at their published widths,
# the config.json values of each Hugging Face repository written here as
# numbers, recalled, not read from the files (nothing is downloaded): name ->
# (repository, family, config.json, layers run or None for all, the dense
# prefix run). DeepSeek-V3 runs 2 of its 61 layers, one dense and one MoE
# (first_k_dense_replace cut from 3 to 1): its 61 are about 1.3 TB of bf16;
# for the script's time DeepSeek-V2-Lite runs 9 of its 27 layers (one
# dense) and gpt-oss-20b 8 of its 24
STANDALONE = {
    "deepseek-v2-lite": ("deepseek-ai/DeepSeek-V2-Lite", "deepseek", dict(
        model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
        num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
        q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, intermediate_size=10944, moe_intermediate_size=1408,
        n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6, n_group=1,
        topk_group=1, first_k_dense_replace=1, topk_method="greedy",
        norm_topk_prob=False, routed_scaling_factor=1.0, rope_theta=10000.0,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                      "mscale": 0.707, "mscale_all_dim": 0.707, "beta_fast": 32,
                      "beta_slow": 1},
        max_position_embeddings=163840, rms_norm_eps=1e-6, tie_word_embeddings=False),
        9, 1),
    "deepseek-v3": ("deepseek-ai/DeepSeek-V3", "deepseek", dict(
        model_type="deepseek_v3", vocab_size=129280, hidden_size=7168,
        num_hidden_layers=61, num_attention_heads=128, num_key_value_heads=128,
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, intermediate_size=18432, moe_intermediate_size=2048,
        n_routed_experts=256, n_shared_experts=1, num_experts_per_tok=8, n_group=8,
        topk_group=4, first_k_dense_replace=3, topk_method="noaux_tc", norm_topk_prob=True,
        routed_scaling_factor=2.5, rope_theta=10000.0,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                      "mscale": 1.0, "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1},
        max_position_embeddings=163840, rms_norm_eps=1e-6, tie_word_embeddings=False),
        2, 1),
    "gpt-oss-20b": ("openai/gpt-oss-20b", "gptoss", dict(
        model_type="gpt_oss", vocab_size=201088, hidden_size=2880, num_hidden_layers=24,
        num_attention_heads=64, num_key_value_heads=8, head_dim=64, intermediate_size=2880,
        num_local_experts=32, num_experts_per_tok=4, sliding_window=128,
        rope_theta=150000.0, rope_scaling={"rope_type": "yarn", "factor": 32.0,
                                           "original_max_position_embeddings": 4096,
                                           "beta_fast": 32.0, "beta_slow": 1.0,
                                           "truncate": False},
        max_position_embeddings=131072, swiglu_limit=7.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False), 8, None),
}
# the forward's tokens, generate's prompt and new tokens (DeepSeek-V3: 32
# after a 64-token prompt), the hybrid engine's slots, capacity, requests,
# new tokens and steps a dispatch, its prompts' least and most length
# (33-120: the engine's prefill bucket is generate's), the CPU slice's
# prompt, the rows of DeepSeek-V3's gmm-against-gather check. Since phase
# 23 came: 32 new tokens a generate and 16 a request (64 and 32 before)
SA_FWD_S, SA_PROMPT, SA_NEW, SA_V3_PROMPT, SA_V3_NEW = 2048, 512, 32, 64, 32
SA_BATCH, SA_MAX, SA_REQS, SA_REQ_NEW, SA_STEPS, SA_REQ_LEN = 4, 1024, 8, 16, 4, (40, 120)
SA_SLICE_S, SA_GATHER_ROWS = 64, 16
# generate's chunk: each chunk length is a captured program whose capture
# runs it eagerly once, so 8-step chunks (programs of 7 and 8 steps) cost
# a quarter of one 63-step chunk's capture
SA_CHUNK = 8
# DeepSeek-V3's MoE layer, gmm against the gather formula (both f32 sums of
# the same bf16 products; gmm's order differs): relative L2
SA_GATHER_TOL = 1e-2
# the attention shapes no kernel is built for (C.8): name -> (D, Hq, Hk)
UNBUILT = {"D 32": (32, 4, 2), "D 112": (112, 4, 2), "G 24": (64, 48, 2)}


def standalone_config(name: str):
    """(family module, config) of STANDALONE[name], cut as it says."""
    import dataclasses
    from pygpukit_tpu_torch.llm.models import deepseek, gptoss
    _, family, hf, layers, dense = STANDALONE[name]
    mod = deepseek if family == "deepseek" else gptoss
    cfg = (mod.DeepseekV3Config if family == "deepseek" else mod.GptOssConfig).from_hf(hf)
    if layers is not None and family == "deepseek":
        cfg = dataclasses.replace(cfg, num_layers=layers, first_k_dense=dense)
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers, layer_types=cfg.layer_types[:layers])
    return mod, cfg


def standalone_slice(mod, cfg, params: dict, n: int = 2):
    """(config, params) of the first ``n`` layers: DeepSeek's dense layer
    and first MoE layer, gpt-oss's first sliding and full layers. The
    leaves are views of ``params``."""
    import dataclasses
    p = {k: v for k, v in params.items() if k not in ("dense_layers", "moe_layers", "layers")}
    if hasattr(cfg, "first_k_dense"):
        kd = min(cfg.first_k_dense, n - 1)
        p["dense_layers"] = {k: v[:kd] for k, v in params["dense_layers"].items()}
        p["moe_layers"] = {k: v[:n - kd] for k, v in params["moe_layers"].items()}
        return dataclasses.replace(cfg, num_layers=n, first_k_dense=kd), p
    p["layers"] = {k: v[:n] for k, v in params["layers"].items()}
    return dataclasses.replace(cfg, num_layers=n, layer_types=cfg.layer_types[:n]), p


def standalone_gmm(mod, cfg, dev, g, params: dict, what: str) -> dict:
    """gmm at the family's expert shape (expert_gmm): the first MoE layer's
    products (DeepSeek: gate, up, down; gpt-oss: the interleaved gate_up,
    down). Returns the layer's totals."""
    ds = hasattr(cfg, "first_k_dense")
    lp = {k: v[0] for k, v in params["moe_layers" if ds else "layers"].items()}
    mats = ([("gate", lp["w_experts_gate"]), ("up", lp["w_experts_up"])] if ds else
            [("gate_up", lp["w_experts_gate_up"])])
    return expert_gmm(cfg, dev, g, mats, lp["w_experts_down"],
                      cfg.n_routed_experts if ds else cfg.num_experts, f"phase 22: {what}")


def expert_gmm(cfg, dev, g, mats: list, w_down, n_exp: int, what: str) -> dict:
    """gmm at a MoE layer's products (``mats``: (label, [G, K, N] stack)
    pairs taking the hidden rows, then ``w_down``) at the M of the
    SA_FWD_S-token forward, rows grouped by a seeded top-k routing over the
    ``n_exp`` experts, each against gmm_plain (GMM_REL) and timed with its
    bound and torch._grouped_mm's time. Returns the layer's totals (ms,
    plain ms, library ms, bytes, operations, the largest error, rows and
    empty groups)."""
    import torch
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    gs = gmm_sizes(dev, g, SA_FWD_S, cfg.num_experts_per_tok, n_exp)
    host = gs.tolist()
    lhs = (torch.randn((sum(host), cfg.hidden_size), generator=g, device=dev)).to(
        torch.bfloat16)
    total = dict.fromkeys(("ms", "plain_ms", "lib_ms", "bytes", "ops"), 0.0)
    err_max, down_in = 0.0, None
    for label, rhs in mats + [("down", w_down)]:
        x = lhs if label != "down" else down_in
        out, ref = gmm(x, rhs, gs), gmm_plain(x, rhs, host)
        err = (out - ref).abs().max().item()
        shape = f"M {x.shape[0]}, K {rhs.shape[1]}, N {rhs.shape[2]}, G {rhs.shape[0]}"
        check(err <= GMM_REL * ref.abs().max().item(),
              f"{what}: gmm {label} ({shape}) against gmm_plain: max abs err {err}")
        err_max = max(err_max, err)
        if label != "down":
            down_in = torch.randn((x.shape[0], w_down.shape[1]), generator=g,
                                  device=dev).to(torch.bfloat16)
        kms, pms, lms, nbytes, ops, _ = gmm_timed(x, rhs, gs, host, err,
                                                  f"{what} gmm {label} ({shape})")
        for key, v in zip(total, (kms, pms, lms, nbytes, ops)):
            total[key] = None if v is None or total[key] is None else total[key] + v
        del out, ref
    torch.cuda.empty_cache()
    return dict(total, err=err_max, rows=sum(host), empty=sum(1 for n in host if n == 0))


def standalone_forward(mod, cfg, model, dev, n_moe: int, what: str) -> tuple:
    """The SA_FWD_S-token forward: shape, finite, gmm launched n_moe x the
    products a MoE layer and nothing else, a bitwise second call; device
    ms by graph replay, tok/s and a kernel profile of one eager call.
    Returns (launches, ms, tok/s, profile line)."""
    import numpy as np
    import torch
    ids = np.random.default_rng(221).integers(1, cfg.vocab_size, SA_FWD_S).tolist()
    tokens = torch.tensor(ids, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    out = mod.forward_fn(cfg, model.params, tokens)
    torch.cuda.synchronize()
    launches = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    check(tuple(out.shape) == (SA_FWD_S, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          f"{what}: forward logits {tuple(out.shape)} or a value not finite")
    per_layer = 2 if mod.__name__.endswith("gptoss") else 3
    want = {"gmm": per_layer * n_moe}
    check(launches == want, f"{what}: forward launches {launches}, expected {want}")
    check(torch.equal(out, mod.forward_fn(cfg, model.params, tokens)),
          f"{what}: a second forward differs")
    del out
    ms = time_ms(lambda i: mod.forward_fn(cfg, model.params, tokens), 1, reps=2)
    prof = kernel_profile(lambda i: mod.forward_fn(cfg, model.params, tokens), n=1)
    return launches, ms, SA_FWD_S / ms * 1e3, profile_line(prof, 5)


def standalone_generate(model, cfg, prompt_len: int, n_new: int, what: str) -> tuple:
    """generate n_new greedy tokens after a seeded prompt, twice from the
    same cache (the second run replays the first's programs): identical
    tokens. Returns (tokens, tok/s of the replayed run, its launches)."""
    import numpy as np
    import torch
    prompt = np.random.default_rng(222).integers(1, cfg.vocab_size, prompt_len).tolist()
    model.init_fixed_cache(SA_MAX)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = model.generate(prompt, max_new_tokens=n_new, chunk_size=SA_CHUNK)
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0, launch_counts()))
    reset_counts()
    (t1, _, _), (t2, secs, launches) = runs
    check(len(t2) == n_new and t1 == t2, f"{what}: the replayed generate's tokens differ")
    return t2, n_new / secs, {k: n for k, n in launches.items() if n}


def standalone_engine(model, cfg, what: str) -> tuple:
    """The hybrid engine (SA_BATCH slots, MAX SA_MAX) on SA_REQS requests of
    SA_REQ_NEW new tokens, after a warm-up that captures its programs (a
    request of SA_STEPS + 1 tokens for each prompt bucket: its admission
    and one chunk): each stream, the warm-up's too, the greedy generate of
    its prompt on the card at the engine's capacity (the same prompt
    bucket, cache length and single-sequence step, so the same bits;
    generate reuses the cache and chunk programs of standalone_generate).
    Returns (tok/s, TTFT p50/p95 ms, launches) of the timed run."""
    import numpy as np
    import torch
    from pygpukit_tpu_torch.llm.model import _bucket
    from pygpukit_tpu_torch.llm.serving_hybrid import HybridServingEngine
    rng = np.random.default_rng(223)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(*SA_REQ_LEN))).tolist()
               for _ in range(SA_REQS)]
    warm = list({_bucket(len(p)): p for p in prompts}.values())
    runs = [[(p, SA_STEPS + 1) for p in warm], [(p, SA_REQ_NEW) for p in prompts]]
    want = {(tuple(p), n): model.generate(p, max_new_tokens=n, chunk_size=SA_CHUNK)
            for run in runs for p, n in run}
    model.graphs.reset()
    eng = HybridServingEngine(model, max_batch=SA_BATCH, max_seq_len=SA_MAX,
                              steps_per_dispatch=SA_STEPS)
    for run in runs:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in run]
        eng.run_until_complete()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts().items() if n}
        reset_counts()
        for r, (p, n) in zip(reqs, run):
            check(r.done and r.generated == want[(tuple(p), n)],
                  f"{what}: engine request {r.request_id}'s stream is not its generate's")
    n_tok = sum(len(r.generated) for r in reqs)
    eng.graphs.reset()
    return n_tok / secs, ttft_ms(reqs), launches


def standalone_cpu_slice(mod, cfg, params: dict, dev, what: str) -> str:
    """The first two layers (standalone_slice) on the card against the CPU
    plain path (the one-hot experts in f32): the SA_SLICE_S-token forward's
    rows, MOE_ROWS_Q quantile of their relative L2 within FWD_TOL (as
    phase 14 holds Mixtral's: the routes round at other points)."""
    import numpy as np
    import torch
    scfg, sp = standalone_slice(mod, cfg, params)
    cls = mod.DeepseekV3Model if hasattr(cfg, "first_k_dense") else mod.GptOssModel
    card = cls(scfg, dict(sp), dtype=torch.bfloat16)
    ids = np.random.default_rng(224).integers(1, cfg.vocab_size, SA_SLICE_S).tolist()
    lc = card.get_logits(ids)
    cpu_tree = {k: (None if v is None else
                    {kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                for k, v in sp.items()}
    cpu = cls(scfg, cpu_tree, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    lr = cpu.get_logits(ids)
    cpu_s = time.perf_counter() - t0
    rows = np.linalg.norm(lc - lr, axis=1) / np.linalg.norm(lr, axis=1)
    q = float(np.quantile(rows, MOE_ROWS_Q))
    check(q <= FWD_TOL, f"{what}: 2-layer slice card vs CPU: {MOE_ROWS_Q} quantile of the "
          f"rows' relative L2 {q:.3e} (limit {FWD_TOL})")
    del card, cpu, cpu_tree
    return (f"2-layer slice, card vs CPU plain path (one-hot experts in f32, {cpu_s:.1f} s), "
            f"{SA_SLICE_S}-token forward rows' relative L2: median {np.median(rows):.3e}, "
            f"{MOE_ROWS_Q} quantile {q:.3e} (limit {FWD_TOL}), max {rows.max():.3e}")


def standalone_v3_moe(mod, cfg, model, dev, g) -> str:
    """DeepSeek-V3's MoE layer: ``gmm_experts`` against ``gather_experts``
    (the gather formula) on SA_GATHER_ROWS token rows routed by its own
    noaux_tc router, relative L2 within SA_GATHER_TOL (there is no CPU copy
    of its MoE layer: 45 GB of f32 experts)."""
    import torch
    from pygpukit_tpu_torch.ops import moe
    lp = {k: v[0] for k, v in model.params["moe_layers"].items()}
    x = (torch.randn((SA_GATHER_ROWS, cfg.hidden_size), generator=g, device=dev)).to(
        torch.bfloat16)
    w, ids = mod._router(cfg, lp, x)

    def act(outs, _):
        return mod._silu(outs[0]).mul_(outs[1]).to(x.dtype)
    stacks = ((lp["w_experts_gate"], lp["w_experts_up"]), lp["w_experts_down"])
    reset_counts()
    a = moe.gmm_experts(x, *stacks, w, ids, act)
    torch.cuda.synchronize()
    n_gmm = launch_counts()["gmm"]
    reset_counts()
    b = moe.gather_experts(x, *stacks, w, ids, act)
    rel = ((a - b).norm() / b.norm()).item()
    check(n_gmm == 3 and rel <= SA_GATHER_TOL,
          f"deepseek-v3: gmm route against the gather formula on {SA_GATHER_ROWS} rows: "
          f"relative L2 {rel:.3e} (limit {SA_GATHER_TOL}), {n_gmm} gmm launches")
    return (f"MoE layer on {SA_GATHER_ROWS} rows ({SA_GATHER_ROWS * cfg.num_experts_per_tok} "
            f"routed rows, noaux_tc): gmm route (3 launches) against the gather formula, "
            f"relative L2 {rel:.3e} (limit {SA_GATHER_TOL})")


def standalone_run(name: str, dev, card: str) -> int:
    """One model of phase 22. Returns the gmm launches of its forward."""
    import gc
    import torch
    t0 = time.perf_counter()
    mod, cfg = standalone_config(name)
    ds = hasattr(cfg, "first_k_dense")
    cls = mod.DeepseekV3Model if ds else mod.GptOssModel
    model = cls(cfg, mod.init_params(cfg, 0, torch.bfloat16, dev), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for grp in model.params.values()
                 if grp is not None
                 for t in (grp.values() if isinstance(grp, dict) else (grp,)))
    n_moe = cfg.num_layers - cfg.first_k_dense if ds else cfg.num_layers
    secs = {"build": round(time.perf_counter() - t0, 1)}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    report = [f"{nbytes / 1e9:.2f} GB of bf16 weights"]
    launches, ms, tok_s, fwd_prof = standalone_forward(mod, cfg, model, dev, n_moe, name)
    report.append(f"forward {SA_FWD_S} tokens {ms:.3f} ms device (graph replay) = "
                  f"{tok_s:.0f} tok/s, launches {json.dumps(launches)}; forward "
                  + fwd_prof)
    lap("forward")
    g = torch.Generator(device=dev)
    g.manual_seed(225)
    gm = standalone_gmm(mod, cfg, dev, g, model.params, name)
    bms, by = bound(gm["bytes"], gm["ops"], "bf16")
    lib = "—" if gm["lib_ms"] is None else f"{gm['lib_ms']:.4f} ms"
    report.append(f"gmm at its expert shape (one MoE layer's products at M "
                  f"{SA_FWD_S * cfg.num_experts_per_tok}): {gm['ms']:.4f} ms, bound "
                  f"{bms:.4f} ms by {by} = share {bms / gm['ms']:.3f}, plain "
                  f"{gm['plain_ms']:.4f} ms, torch._grouped_mm {lib}; "
                  f"{launches.get('gmm', 0)} launches in the forward")
    lap("gmm")
    prompt_len, n_new = (SA_V3_PROMPT, SA_V3_NEW) if name == "deepseek-v3" else (SA_PROMPT,
                                                                                  SA_NEW)
    _, gen_tok_s, gen_l = standalone_generate(model, cfg, prompt_len, n_new, name)
    pos = torch.tensor([prompt_len + n_new], dtype=torch.int32, device=dev)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    step_prof = kernel_profile(lambda i: mod.decode_step_fn(
        cfg, model.params, *model._fixed_caches(), tok, pos), n=1)
    report.append(f"generate {n_new} tokens after a {prompt_len}-token prompt "
                  f"{gen_tok_s:.1f} tok/s replayed, identical, launches {json.dumps(gen_l)}; "
                  f"one decode step at pos {prompt_len + n_new} " + profile_line(step_prof, 5))
    lap("generate")
    if name == "deepseek-v3":
        report.append(standalone_v3_moe(mod, cfg, model, dev, g))
        lap("moe check")
    else:
        eng_tok_s, ttft, eng_l = standalone_engine(model, cfg, name)
        report.append(f"hybrid engine ({SA_BATCH} slots, MAX {SA_MAX}, {SA_REQS} requests of "
                      f"{SA_REQ_NEW} new tokens, {SA_STEPS} steps a dispatch, its programs "
                      f"captured by a warm-up) {eng_tok_s:.1f} tok/s replayed, TTFT p50/p95 "
                      f"{ttft[0]:.1f}/{ttft[1]:.1f} ms, every stream its prompt's generate, "
                      f"launches {json.dumps(eng_l)}")
        lap("engine")
    model.graphs.reset()
    params = model.params
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if name != "deepseek-v3":
        report.append(standalone_cpu_slice(mod, cfg, params, dev, name))
        lap("cpu slice")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22: {name} ({STANDALONE[name][0]}, {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}): " + "; ".join(report)
          + f"; {time.perf_counter() - t0:.1f} s (by section {json.dumps(secs)}) [{card}]")
    return launches.get("gmm", 0)


def unbuilt_routes(dev, card: str) -> None:
    """C.8: the routes each unbuilt attention shape takes (UNBUILT), and a
    2-layer f32 model of each shape served on the card: the forward, a
    generate and both engines, the engines' streams the generate's."""
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, ContinuousBatchingEngine,
                                        TransformerConfig, init_params)
    from pygpukit_tpu_torch.llm.model import batch_attention_route
    from pygpukit_tpu_torch.llm.serving_paged import paged_attention_route
    from pygpukit_tpu_torch.ops.nn.attention import fixed_cache_route, flash_attention_route
    for what, (d, hq, hk) in UNBUILT.items():
        routes = {"flash_attention": flash_attention_route("cuda", d ** -0.5, d, None, None,
                                                           hq, hk),
                  "flash_decode": fixed_cache_route("cuda", 1, hq, hk, d, torch.float32,
                                                    torch.float32, torch.float32),
                  "batch step": batch_attention_route("cuda", hq, hk, d),
                  "paged step": paged_attention_route("cuda", hq, hk, d)}
        cfg = TransformerConfig(vocab_size=512, hidden_size=hq * d, num_layers=2, num_heads=hq,
                                num_kv_heads=hk, intermediate_size=256,
                                max_position_embeddings=256, tie_word_embeddings=False)
        model = CausalTransformerModel(cfg, init_params(cfg, 0, torch.float32, dev),
                                       dtype=torch.float32)
        prompt = list(range(3, 40))
        reset_counts()
        logits = model.get_logits(prompt)
        model.init_fixed_cache(128)
        want = model.generate(prompt, 12, chunk_size=4)
        streams = []
        for paged in (False, True):
            eng = ContinuousBatchingEngine(model, max_batch=2, max_seq_len=128,
                                           steps_per_dispatch=4, paged=paged)
            req = eng.submit(prompt, max_new_tokens=12)
            eng.run_until_complete()
            streams.append(req.generated)
            eng.graphs.reset()
        launches = {k: n for k, n in launch_counts().items() if n}
        reset_counts()
        check(bool(torch.isfinite(torch.from_numpy(logits)).all()) and streams == [want, want],
              f"C.8 {what}: the engines' streams differ from generate's or a logit is not "
              f"finite")
        kernels = {k for k, r in routes.items() if r == "kernel"}
        moved = set(launches) & {"flash_attention", "flash_decode", "batch_decode_attention",
                                 "paged_attention"}
        check(moved == {"flash_attention", "flash_decode"} & kernels,
              f"C.8 {what}: routes {routes} but launches {launches}")
        model.graphs.reset()
        print(f"phase 22: C.8 {what} (D {d}, {hq}/{hk} heads): routes {json.dumps(routes)}; "
              f"a 2-layer f32 model's forward, generate and both engines ran, the engines' "
              f"streams the generate's, attention launches {json.dumps(sorted(moved))} "
              f"[{card}]")


def standalone_phase(dev, card: str) -> int:
    """Phase 22 (``--phases standalone``): the C.8 routes, then each model of
    STANDALONE, one at a time, the card freed between them. Returns the gmm
    launches of the models' forwards."""
    t0 = time.perf_counter()
    unbuilt_routes(dev, card)
    n_gmm = sum(standalone_run(name, dev, card) for name in STANDALONE)
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return n_gmm


# phase 23: Llama-4 and the families with one per-layer cache tree
# (llm.models) at their published widths, the config.json values of each
# Hugging Face repository written here as numbers, recalled, not read from
# the files (nothing is downloaded): name -> (repository, family, config,
# layers run or None for all). Llama-Guard-4-12B's text config is given in
# Llama4Config's field names (its dense MLP is intermediate_size_mlp; the
# rope_scaling block is not read, as the reference reads none); NoPE every
# fourth layer. For the script's time (on a slower host the whole script
# took 1136 s of its 1200 s limit with them deeper) Llama-Guard-4-12B runs
# 16 of its 48 layers, Mamba-2.8B 16 of 64 and FalconMamba-7B 8 of 64.
TREE_FAMILIES = {
    "llama-guard-4-12b": ("meta-llama/Llama-Guard-4-12B (text_config)", "llama4", dict(
        vocab_size=202048, hidden_size=5120, intermediate_size=8192, num_hidden_layers=48,
        num_attention_heads=40, num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=500000.0, attn_scale=0.1, floor_scale=8192.0, use_qk_norm=True,
        max_position_embeddings=131072, no_rope_layers=[1, 1, 1, 0] * 12), 16),
    "mamba-2.8b": ("state-spaces/mamba-2.8b-hf", "mamba", dict(
        model_type="mamba", vocab_size=50280, hidden_size=2560, num_hidden_layers=64,
        state_size=16, intermediate_size=5120, conv_kernel=4, time_step_rank=160,
        use_conv_bias=True, use_bias=False, layer_norm_epsilon=1e-5,
        tie_word_embeddings=True), 16),
    "falcon-mamba-7b": ("tiiuae/falcon-mamba-7b", "mamba", dict(
        model_type="falcon_mamba", vocab_size=65024, hidden_size=4096, num_hidden_layers=64,
        state_size=16, intermediate_size=8192, conv_kernel=4, time_step_rank=256,
        use_conv_bias=True, use_bias=False, mixer_rms_eps=1e-6, layer_norm_epsilon=1e-5,
        tie_word_embeddings=False), 8),
    "lfm2-1.2b": ("LiquidAI/LFM2-1.2B", "lfm2", dict(
        model_type="lfm2", vocab_size=65536, hidden_size=2048, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, intermediate_size=12288,
        block_auto_adjust_ff_dim=True, block_ffn_dim_multiplier=1.0, block_multiple_of=256,
        conv_L_cache=3, conv_bias=False, rope_theta=1000000.0, norm_eps=1e-5,
        max_position_embeddings=128000, tie_word_embeddings=True,
        layer_types=["full_attention" if i in (2, 5, 8, 10, 12, 14) else "conv"
                     for i in range(16)]), None),
}
# the forward's tokens; Llama-4's generate (no cache: a forward a token):
# prompt and new tokens; the cached families' generate: prompt and new
# tokens (after init_fixed_cache(SA_MAX), so the engine's streams, phase
# 22's SA_* workload, are generate's bits); Mamba's blocked prefill: the
# prompt, its blocks and the new tokens compared; the CPU slices' prompt
TR_FWD_S, TR_L4_PROMPT, TR_L4_NEW, TR_PROMPT, TR_NEW = 2048, 32, 16, 512, 32
TR_BLOCKED_S, TR_BLOCK, TR_BLOCKED_NEW, TR_SLICE_S = 1024, 512, 16, 64
# Mamba's blocked prefill against one shot on f32 weights: the two scans
# sum the same products in another order (f32 rounding, grown through 64
# layers), relative L2 of the last logits
TR_BLOCKED_F32_TOL = 1e-4
# the 2-layer slices run on the card and on the CPU: layer indices (a rope
# and a NoPE layer of Llama-4, a conv and an attention layer of LFM2)
TR_SLICE = {"llama4": (2, 4), "mamba": (0, 2), "lfm2": (1, 3)}
# row 15 at LFM2-1.2B's attention: (Hq, Hk, D, MAX, ctx, layers cycled)
TR_DECODE_ROW = (32, 8, 64, SA_MAX, TR_PROMPT + TR_NEW, 6)
# the kernels line's row of row 15 at LFM2-1.2B's shape
D64_ROWS = {"flash_decode_lfm2": ("flash_decode", "lfm2-1.2b")}


def tree_model(name: str, dev, cut: bool = True):
    """(family module, config, model) of TREE_FAMILIES[name] with random
    bf16 weights from seed 0 on ``dev``, cut to its layers."""
    import dataclasses
    import torch
    from pygpukit_tpu_torch.llm.models import lfm2, llama4, mamba
    _, family, hf, layers = TREE_FAMILIES[name]
    if family == "llama4":
        cfg = llama4.Llama4Config(**hf)
        if layers is not None and cut:
            cfg = dataclasses.replace(cfg, num_hidden_layers=layers,
                                      no_rope_layers=cfg.rope_flags()[:layers])
        return llama4, cfg, llama4.Llama4Model.init_random(cfg, 0, torch.bfloat16, dev)
    mod = mamba if family == "mamba" else lfm2
    cfg = (mamba.MambaConfig if family == "mamba" else lfm2.Lfm2Config).from_hf(hf)
    if layers is not None and cut:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cls = mamba.MambaModel if family == "mamba" else lfm2.Lfm2Model
    return mod, cfg, cls(cfg, mod.init_params(cfg, 0, torch.bfloat16, dev), dtype=torch.bfloat16)


def tree_slice(mod, cfg, params: dict, device):
    """(config, params) of TREE_SLICE's two layers, the leaves copied to
    ``device`` (views where they are already there)."""
    import dataclasses
    lo, hi = TR_SLICE[mod.__name__.rsplit(".", 1)[1]]

    def to(t):
        return None if t is None else t.to(device)
    p = {k: to(v) for k, v in params.items() if k != "layers"}
    if isinstance(params["layers"], dict):           # Llama-4's stacked leaves
        p["layers"] = {k: to(v[lo:hi]) for k, v in params["layers"].items()}
        return dataclasses.replace(cfg, num_hidden_layers=hi - lo,
                                   no_rope_layers=cfg.rope_flags()[lo:hi]), p
    p["layers"] = [{k: to(v) for k, v in lp.items()} for lp in params["layers"][lo:hi]]
    extra = {"layer_types": cfg.layer_types[lo:hi]} if hasattr(cfg, "layer_types") else {}
    return dataclasses.replace(cfg, num_layers=hi - lo, **extra), p


def tree_forward_fn(mod):
    return mod.llama4_forward_fn if hasattr(mod, "llama4_forward_fn") else mod.forward_fn


def tree_forward(mod, cfg, model, dev, what: str) -> tuple:
    """The TR_FWD_S-token forward: shape, finite, no kernel launched (the
    reference's prefill attention and scan are plain), a bitwise second
    call; device ms by graph replay, tok/s and a kernel profile of one
    eager call. Returns (ms, tok/s, profile line)."""
    import numpy as np
    import torch
    fwd = tree_forward_fn(mod)
    ids = np.random.default_rng(231).integers(1, cfg.vocab_size, TR_FWD_S).tolist()
    tokens = torch.tensor(ids, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    out = fwd(cfg, model.params, tokens)
    torch.cuda.synchronize()
    launches = {k: n for k, n in launch_counts().items() if n}
    reset_counts()
    check(tuple(out.shape) == (TR_FWD_S, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          f"{what}: forward logits {tuple(out.shape)} or a value not finite")
    check(not launches, f"{what}: forward launches {launches}, expected none")
    check(torch.equal(out, fwd(cfg, model.params, tokens)), f"{what}: a second forward differs")
    del out
    torch.cuda.empty_cache()
    ms = time_ms(lambda i: fwd(cfg, model.params, tokens), 1, reps=2)
    torch.cuda.empty_cache()
    prof = kernel_profile(lambda i: fwd(cfg, model.params, tokens), n=1)
    return ms, TR_FWD_S / ms * 1e3, profile_line(prof, 5)


def tree_generate(model, cfg, prompt_len: int, n_new: int, what: str) -> tuple:
    """generate n_new greedy tokens after a seeded prompt twice (a cached
    family at SA_MAX rows, the second run replaying the first's programs):
    identical tokens. Returns (tok/s of the second run, its launches)."""
    import numpy as np
    import torch
    prompt = np.random.default_rng(232).integers(1, cfg.vocab_size, prompt_len).tolist()
    cached = hasattr(model, "init_fixed_cache")
    if cached:
        model.init_fixed_cache(SA_MAX)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = (model.generate(prompt, max_new_tokens=n_new, chunk_size=SA_CHUNK) if cached
                else model.generate(prompt, max_new_tokens=n_new))
        torch.cuda.synchronize()
        runs.append((toks, time.perf_counter() - t0, launch_counts()))
    reset_counts()
    (t1, _, _), (t2, secs, launches) = runs
    check(len(t2) == n_new and t1 == t2, f"{what}: the second generate's tokens differ")
    return n_new / secs, {k: n for k, n in launches.items() if n}


def tree_blocked(model, cfg, what: str) -> str:
    """Mamba's stateful prefill over TR_BLOCKED_S tokens in blocks of
    TR_BLOCK against one shot: the last position's logits (relative L2,
    the same argmax) and TR_BLOCKED_NEW greedy tokens equal; then both
    prefills again on an f32 copy of the weights, where the two scans
    differ only in f32 rounding (TR_BLOCKED_F32_TOL): in bf16 the other
    order's rounding flips grow through the layers."""
    import numpy as np
    import torch
    ids = np.random.default_rng(233).integers(1, cfg.vocab_size, TR_BLOCKED_S)

    def last_logits(m, blk) -> "torch.Tensor":
        for leaf in (t for c in m.caches for t in c.values()):
            leaf.zero_()
        step = blk or TR_BLOCKED_S
        for off in range(0, TR_BLOCKED_S, step):
            out = m._replay_prefill(ids[off:off + step])
        return out.clone()

    def rel_l2(a, b) -> float:
        return ((a - b).norm() / b.norm()).item()
    model.init_fixed_cache(2 * TR_BLOCKED_S)
    blocked, one = (last_logits(model, blk) for blk in (TR_BLOCK, None))
    rel = rel_l2(blocked, one)
    same = int(torch.argmax(blocked)) == int(torch.argmax(one))
    toks = [model.generate(ids, max_new_tokens=TR_BLOCKED_NEW, chunk_size=SA_CHUNK,
                           prefill_block=blk) for blk in (TR_BLOCK, None)]
    check(same and toks[0] == toks[1] and rel <= FWD_TOL,
          f"{what}: blocked prefill (blocks of {TR_BLOCK}) against one shot: last logits "
          f"relative L2 {rel:.3e}, argmax equal {same}, tokens {toks[0]} vs {toks[1]}")
    model.graphs.reset()
    f32 = type(model)(cfg, torch.utils._pytree.tree_map(
        lambda t: t.float() if isinstance(t, torch.Tensor) and t.is_floating_point() else t,
        model.params), dtype=torch.float32)
    f32.init_fixed_cache(2 * TR_BLOCKED_S)
    rel32 = rel_l2(*(last_logits(f32, blk) for blk in (TR_BLOCK, None)))
    check(rel32 <= TR_BLOCKED_F32_TOL, f"{what}: f32 blocked prefill against one shot: last "
          f"logits relative L2 {rel32:.3e} (limit {TR_BLOCKED_F32_TOL})")
    f32.graphs.reset()
    del f32
    torch.cuda.empty_cache()
    return (f"blocked prefill of {TR_BLOCKED_S} tokens in blocks of {TR_BLOCK} against one "
            f"shot: last logits relative L2 {rel:.3e} in bf16, {rel32:.3e} on f32 weights "
            f"(limit {TR_BLOCKED_F32_TOL}), the same argmax, {TR_BLOCKED_NEW} greedy tokens "
            f"equal")


def tree_cpu_slice(mod, cfg, model, what: str) -> str:
    """TR_SLICE's two layers on the card against the CPU plain path (every
    product in f32, the same bf16 weights): the TR_SLICE_S-token forward's
    rows, the largest relative L2 within FWD_TOL."""
    import numpy as np
    import torch
    fwd = tree_forward_fn(mod)
    scfg, sp = tree_slice(mod, cfg, model.params, model.device)
    ids = torch.tensor(np.random.default_rng(234).integers(1, cfg.vocab_size, TR_SLICE_S))
    lc = fwd(scfg, sp, ids.to(model.device)).cpu().numpy()
    scfg, sp = tree_slice(mod, cfg, model.params, "cpu")
    t0 = time.perf_counter()
    lr = fwd(scfg, sp, ids).numpy()
    cpu_s = time.perf_counter() - t0
    rows = np.linalg.norm(lc - lr, axis=1) / np.linalg.norm(lr, axis=1)
    check(rows.max() <= FWD_TOL, f"{what}: 2-layer slice card vs CPU: the largest row's "
          f"relative L2 {rows.max():.3e} (limit {FWD_TOL})")
    del sp
    return (f"2-layer slice (layers {TR_SLICE[mod.__name__.rsplit('.', 1)[1]]}), card vs CPU "
            f"plain path ({cpu_s:.1f} s), {TR_SLICE_S}-token forward rows' relative L2: median "
            f"{np.median(rows):.3e}, max {rows.max():.3e} (limit {FWD_TOL})")


def decode_row(dev, detail: dict, shape: tuple, row: str, what: str, seed: int) -> dict:
    """Row 15 at a family's attention, ``shape`` (Hq, Hk, D, MAX, ctx,
    layers cycled): one bf16 query over ctx rows of a MAX-row cache
    against its plain version (ATTN_TOL), a second launch bitwise, timed
    beside the plain version and SDPA with its bound. Records ``row`` in
    ``detail``; returns the kernels line's row."""
    import torch
    from pygpukit_tpu_torch.kernels import flash_decode, flash_decode_plain
    hq, hk, d, max_len, ctx, nl = shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((nl, max_len, hk, d), generator=g, device=dev).to(torch.bfloat16)
    q1 = torch.randn((1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    o = flash_decode(q1, kc[1], vc[1], ctx)
    err = _attn_err(o, flash_decode_plain(q1, kc[1], vc[1], ctx), "bf16",
                    f"{what} flash_decode")
    check(torch.equal(o, flash_decode(q1, kc[1], vc[1], ctx)),
          f"{what} flash_decode: a second launch differs")
    kms = time_ms(lambda i: flash_decode(q1, kc[i], vc[i], ctx), nl)
    pms = time_ms(lambda i: flash_decode_plain(q1, kc[i], vc[i], ctx), nl)
    lms = time_ms(lambda i: sdpa(q1.transpose(0, 1)[None], kc[i, :ctx].permute(1, 0, 2)[None],
                                 vc[i, :ctx].permute(1, 0, 2)[None]), nl)
    result = kernel_row(err, kms, pms, (2 * ctx * hk * d + 2 * hq * d) * 2, 4 * hq * d * ctx,
                        "bf16", lms)
    detail[row] = dict(result, share=result["bound_ms"] / result["ms"])
    print(f"{what}: flash_decode at its attention ({hq}/{hk} heads, D {d}, ctx {ctx} of MAX "
          f"{max_len}): kernel {kms:.5f} ms, plain {pms:.4f} ms, SDPA {lms:.5f} ms, bound "
          f"{result['bound_ms']:.6f} ms ({result['bound_by']}) = share "
          f"{result['bound_ms'] / kms:.3f}; max abs err {err:.3e} [{CARD}]")
    return result


def tree_run(name: str, dev, card: str) -> int:
    """One model of phase 23. Returns the flash_decode launches of its
    generate and engine runs."""
    import gc
    import torch
    t0 = time.perf_counter()
    mod, cfg, model = tree_model(name, dev)
    family = TREE_FAMILIES[name][1]
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(model.params)
                 if isinstance(t, torch.Tensor))
    secs = {"build": round(time.perf_counter() - t0, 1)}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    report = [f"{nbytes / 1e9:.2f} GB of weights and tables"]
    ms, tok_s, fwd_prof = tree_forward(mod, cfg, model, dev, name)
    report.append(f"forward {TR_FWD_S} tokens {ms:.3f} ms device (graph replay) = "
                  f"{tok_s:.0f} tok/s, no kernel launched; forward " + fwd_prof)
    lap("forward")
    n_decode = 0
    if family == "llama4":
        gen_tok_s, gen_l = tree_generate(model, cfg, TR_L4_PROMPT, TR_L4_NEW, name)
        report.append(f"generate {TR_L4_NEW} tokens after a {TR_L4_PROMPT}-token prompt (a "
                      f"forward a token, no cache) {gen_tok_s:.2f} tok/s, identical twice, "
                      f"launches {json.dumps(gen_l)}")
    else:
        gen_tok_s, gen_l = tree_generate(model, cfg, TR_PROMPT, TR_NEW, name)
        per_step = gen_l.get("flash_decode", 0) / (TR_NEW - 1)
        n_att = sum(cfg.is_attn(i) for i in range(cfg.num_layers)) if family == "lfm2" else 0
        check(per_step == n_att, f"{name}: generate launched flash_decode {per_step} times a "
              f"step, expected {n_att} (its attention layers)")
        n_decode += gen_l.get("flash_decode", 0)
        pos = torch.tensor([TR_PROMPT + TR_NEW], dtype=torch.int32, device=dev)
        tok = torch.tensor([1], dtype=torch.int32, device=dev)
        step_prof = kernel_profile(lambda i: mod.decode_step_fn(cfg, model.params,
                                                                model.caches, tok, pos), n=1)
        report.append(f"generate {TR_NEW} tokens after a {TR_PROMPT}-token prompt "
                      f"{gen_tok_s:.1f} tok/s replayed, identical, launches "
                      f"{json.dumps(gen_l)} ({per_step:.0f} flash_decode a step); one decode "
                      f"step at pos {TR_PROMPT + TR_NEW} " + profile_line(step_prof, 5))
    lap("generate")
    if name == "mamba-2.8b":
        report.append(tree_blocked(model, cfg, name))
        lap("blocked prefill")
    if name in ("mamba-2.8b", "lfm2-1.2b"):
        model.init_fixed_cache(SA_MAX)
        eng_tok_s, ttft, eng_l = standalone_engine(model, cfg, name)
        n_decode += eng_l.get("flash_decode", 0)
        report.append(f"hybrid engine ({SA_BATCH} slots, MAX {SA_MAX}, {SA_REQS} requests of "
                      f"{SA_REQ_NEW} new tokens, {SA_STEPS} steps a dispatch, its programs "
                      f"captured by a warm-up) {eng_tok_s:.1f} tok/s replayed, TTFT p50/p95 "
                      f"{ttft[0]:.1f}/{ttft[1]:.1f} ms, every stream its prompt's generate, "
                      f"launches {json.dumps(eng_l)}")
        lap("engine")
    if name != "falcon-mamba-7b":
        report.append(tree_cpu_slice(mod, cfg, model, name))
        lap("cpu slice")
    if hasattr(model, "graphs"):
        model.graphs.reset()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    layers = getattr(cfg, "num_layers", getattr(cfg, "num_hidden_layers", None))
    print(f"phase 23: {name} ({TREE_FAMILIES[name][0]}, {layers} layers, hidden "
          f"{cfg.hidden_size}): " + "; ".join(report)
          + f"; {time.perf_counter() - t0:.1f} s (by section {json.dumps(secs)}) [{card}]")
    return n_decode


def trees_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 23 (``--phases trees``): each model of TREE_FAMILIES, one at a
    time, the card freed between them, then row 15 at LFM2-1.2B's shape.
    Returns (the D64_ROWS row's launches: flash_decode's on LFM2-1.2B's
    generate and engine runs, and its kernels-line numbers)."""
    t0 = time.perf_counter()
    runs = {name: tree_run(name, dev, card) for name in TREE_FAMILIES}
    detail: dict = {}
    results = {"flash_decode_lfm2": decode_row(dev, detail, TR_DECODE_ROW, "flash_decode_lfm2",
                                               "phase 23: lfm2-1.2b", 2323)}
    launches = {row: runs[fam] for row, (_, fam) in D64_ROWS.items()}
    for row, n in launches.items():
        check(n > 0, f"trees: {row} never launched on {D64_ROWS[row][1]}'s path")
    print("phase 23: lfm2 " + json.dumps(detail))
    print(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    return launches, results


# phase 24: Qwen3-Next at the config.json values of
# Qwen/Qwen3-Next-80B-A3B-Instruct, written here as numbers, recalled, not
# read from the file (nothing is downloaded). The file gives no
# layer_types: every fourth layer is full attention (full_attention_interval
# 4, as transformers derives it). 8 of the 48 layers run (full attention at
# layers 3 and 7; 27.75 GB of bf16 weights and tables: 48 layers are about
# 158 GB)
QWEN3NEXT = ("Qwen/Qwen3-Next-80B-A3B-Instruct", dict(
    model_type="qwen3_next", vocab_size=151936, hidden_size=2048, num_hidden_layers=48,
    num_attention_heads=16, num_key_value_heads=2, head_dim=256, intermediate_size=5120,
    linear_num_value_heads=32, linear_num_key_heads=16, linear_key_head_dim=128,
    linear_value_head_dim=128, linear_conv_kernel_dim=4, num_experts=512,
    num_experts_per_tok=10, moe_intermediate_size=512, shared_expert_intermediate_size=512,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    partial_rotary_factor=0.25, rope_theta=10000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=262144, full_attention_interval=4, tie_word_embeddings=False),
    8)
# the card's delta rules at a layer's widths: tokens, value heads, Dk, Dv,
# and the true length of the padded check; the reference test's tolerance
Q3N_DELTA = (2048, 32, 128, 128, 1000)
Q3N_DELTA_TOL = dict(rtol=1e-4, atol=1e-5)
# the 2-layer slice (a DeltaNet and an attention layer; T * k = 160 rows:
# the card's experts on gmm) and its prompt
Q3N_SLICE, Q3N_SLICE_S = (2, 4), 16
# row 15 at the attention layers: (Hq, Hk, D, MAX, ctx, layers cycled)
Q3N_DECODE_ROW = (16, 2, 256, SA_MAX, TR_PROMPT + TR_NEW, 8)
# the kernels line's rows of rows 15 and 19 at Qwen3-Next's shapes
Q3N_ROWS = {"flash_decode_qwen3next": ("flash_decode", "qwen3next"),
            "gmm_qwen3next": ("gmm", "qwen3next")}


def qwen3next_config(layers: int | None = QWEN3NEXT[2]):
    """QWEN3NEXT's config, cut to its first ``layers`` layers."""
    import dataclasses
    from pygpukit_tpu_torch.llm.models.qwen3next import Qwen3NextConfig
    cfg = Qwen3NextConfig.from_hf(QWEN3NEXT[1])
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers, layer_types=cfg.layer_types[:layers])


def qwen3next_delta(mod, dev) -> str:
    """The chunked delta rule against the recurrent one on the card at a
    layer's widths (Q3N_DELTA), outputs and final states within the
    reference test's tolerance; rows past the true length as identity
    steps (g 0, beta 0) leave the recurrent state at that length."""
    import torch
    s, h, dk, dv, tl = Q3N_DELTA
    g = torch.Generator(device=dev)
    g.manual_seed(242)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k, v = rnd(s, h, dk), rnd(s, h, dk), rnd(s, h, dv)
    gd, beta = -rnd(s, h).abs(), torch.sigmoid(rnd(s, h))
    s0 = torch.zeros((h, dk, dv), device=dev)

    def close(a, b) -> float:
        bad = (a - b).abs() - (Q3N_DELTA_TOL["atol"] + Q3N_DELTA_TOL["rtol"] * b.abs())
        return float(bad.max())
    t0 = time.perf_counter()
    o1, s1 = mod._delta_scan(q, k, v, gd, beta, s0)
    o2, s2 = mod._delta_chunked(q, k, v, gd, beta, s0)
    valid = (torch.arange(s, device=dev) < tl)[:, None]
    o3, s3 = mod._delta_scan(q[:tl], k[:tl], v[:tl], gd[:tl], beta[:tl], s0)
    o4, s4 = mod._delta_chunked(q, k, v, torch.where(valid, gd, 0.0),
                                torch.where(valid, beta, 0.0), s0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    worst = max(close(o2, o1), close(s2, s1), close(s4, s3), close(o4[:tl], o3))
    err = max(float((o2 - o1).abs().max()), float((s2 - s1).abs().max()),
              float((s4 - s3).abs().max()), float((o4[:tl] - o3).abs().max()))
    check(worst <= 0, f"qwen3next: chunked delta rule against the recurrent one at S {s}, "
          f"{h} heads, {dk} x {dv}: max abs err {err:.3e} beyond rtol "
          f"{Q3N_DELTA_TOL['rtol']} / atol {Q3N_DELTA_TOL['atol']}")
    return (f"chunked delta rule against the recurrent one at S {s}, {h} heads, {dk} x {dv} "
            f"(and rows past {tl} as identity steps): max abs err {err:.3e}, within rtol "
            f"{Q3N_DELTA_TOL['rtol']} / atol {Q3N_DELTA_TOL['atol']} ({secs:.1f} s)")


def qwen3next_slice(mod, cfg, params: dict, dev) -> str:
    """Q3N_SLICE's two layers (a DeltaNet and an attention layer, both MoE)
    on the card against the CPU plain path (the one-hot experts, every
    product in f32, the same bf16 weights) at the card's routing: a
    random 512-way router has near-ties that bf16 rounding flips on most
    rows (a first run unpinned: 0.95 quantile of the rows 0.147), so the
    CPU's router takes the experts the card's chose, its weights from its
    own probabilities, and the rows whose own top-10 differs are counted.
    The Q3N_SLICE_S-token forward's rows: the largest relative L2 within
    FWD_TOL. Then the card's MoE block at Q3N_SLICE_S rows on gmm_experts
    against gather_experts (the gather formula) on the same routing,
    within SA_GATHER_TOL."""
    import dataclasses
    import numpy as np
    import torch
    from pygpukit_tpu_torch.ops import moe
    lo, hi = Q3N_SLICE
    scfg = dataclasses.replace(cfg, num_layers=hi - lo, layer_types=cfg.layer_types[lo:hi])

    def tree(where):
        p = {k: (None if v is None else v.to(where)) for k, v in params.items()
             if k != "layers"}
        p["layers"] = [{k: v.to(where) for k, v in lp.items()} for lp in params["layers"][lo:hi]]
        return p
    router, picks, moved = mod._router, [], []

    def recording(c, lp, y):
        w, eidx = router(c, lp, y)
        picks.append(eidx.cpu())
        return w, eidx

    def pinned(c, lp, y):
        eidx = picks[len(moved)]
        probs = torch.softmax(torch.matmul(y.float(), lp["w_router"].float()), dim=-1)
        own = router(c, lp, y)[1]
        moved.append(int((own.sort(-1).values != eidx.sort(-1).values).any(-1).sum()))
        w = torch.gather(probs, -1, eidx)
        return w / torch.sum(w, dim=-1, keepdim=True), eidx
    ids = torch.tensor(np.random.default_rng(244).integers(1, cfg.vocab_size, Q3N_SLICE_S))
    reset_counts()
    mod._router = recording
    try:
        lc = mod.forward_fn(scfg, tree(dev), ids.to(dev)).cpu().numpy()
        torch.cuda.synchronize()
        n_gmm = launch_counts().get("gmm", 0)
        reset_counts()
        t0 = time.perf_counter()
        mod._router = pinned
        lr = mod.forward_fn(scfg, tree("cpu"), ids).numpy()
        cpu_s = time.perf_counter() - t0
    finally:
        mod._router = router
    rows = np.linalg.norm(lc - lr, axis=1) / np.linalg.norm(lr, axis=1)
    check(rows.max() <= FWD_TOL and n_gmm == 6,
          f"qwen3next: 2-layer slice card vs CPU at the card's routing: the largest row's "
          f"relative L2 {rows.max():.3e} (limit {FWD_TOL}), {n_gmm} gmm launches (6 expected)")
    lp = {k: v.to(dev) for k, v in params["layers"][lo].items()}
    g = torch.Generator(device=dev)
    g.manual_seed(245)
    x = torch.randn((Q3N_SLICE_S, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    w, eidx = router(cfg, lp, x)

    def act(outs, _):
        return (torch.nn.functional.silu(outs[0]) * outs[1]).to(x.dtype)
    stacks = ((lp["w_experts_gate"], lp["w_experts_up"]), lp["w_experts_down"])
    reset_counts()
    a = moe.gmm_experts(x, *stacks, w, eidx, act)
    torch.cuda.synchronize()
    n_route = launch_counts().get("gmm", 0)
    reset_counts()
    b = moe.gather_experts(x, *stacks, w, eidx, act)
    rel = ((a - b).norm() / b.norm()).item()
    check(n_route == 3 and rel <= SA_GATHER_TOL,
          f"qwen3next: gmm route against the gather formula on {Q3N_SLICE_S} rows: relative "
          f"L2 {rel:.3e} (limit {SA_GATHER_TOL}), {n_route} gmm launches")
    return (f"2-layer slice (layers {Q3N_SLICE}, the card's experts on gmm: {n_gmm} launches), "
            f"card vs CPU plain path at the card's routing (one-hot experts in f32, "
            f"{cpu_s:.1f} s; rows whose CPU top-10 differs: {moved} of {Q3N_SLICE_S} a layer), "
            f"{Q3N_SLICE_S}-token forward rows' relative L2: median {np.median(rows):.3e}, "
            f"max {rows.max():.3e} (limit {FWD_TOL}); the MoE block on gmm against the gather "
            f"formula at the same routing: relative L2 {rel:.3e} (limit {SA_GATHER_TOL})")


def qwen3next_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 24 (``--phases qwen3next``; module docstring). Returns (the
    Q3N_ROWS rows' launches on the model's main path: flash_decode's in its
    generate and engine runs, gmm's in its forward and prefills; their
    kernels-line numbers)."""
    import gc
    import torch
    from pygpukit_tpu_torch.llm.models import qwen3next as mod
    t0 = time.perf_counter()
    cfg = qwen3next_config()
    model = mod.Qwen3NextModel(cfg, mod.init_params(cfg, 0, torch.bfloat16, dev),
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(model.params)
                 if isinstance(t, torch.Tensor))
    secs = {"build": round(time.perf_counter() - t0, 1)}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    n_att = [i for i in range(cfg.num_layers) if cfg.is_attn(i)]
    report = [f"{nbytes / 1e9:.2f} GB of weights and tables, attention at layers {n_att}"]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    f_l, ms, tok_s, fwd_prof = standalone_forward(mod, cfg, model, dev, n_moe, "qwen3next")
    report.append(f"forward {SA_FWD_S} tokens {ms:.3f} ms device (graph replay) = "
                  f"{tok_s:.0f} tok/s, launches {json.dumps(f_l)}; forward " + fwd_prof)
    lap("forward")
    g = torch.Generator(device=dev)
    g.manual_seed(243)
    lp = model.params["layers"][0]
    tot = expert_gmm(cfg, dev, g, [("gate", lp["w_experts_gate"]), ("up", lp["w_experts_up"])],
                     lp["w_experts_down"], cfg.num_experts, "phase 24: qwen3next")
    gm = kernel_row(tot["err"], tot["ms"], tot["plain_ms"], tot["bytes"], tot["ops"], "bf16",
                    tot["lib_ms"])
    detail = {"gmm_qwen3next": dict(gm, share=gm["bound_ms"] / gm["ms"], rows=tot["rows"],
                                    empty_groups=tot["empty"])}
    report.append(f"gmm at the expert shape (one MoE layer's products at M {tot['rows']}, "
                  f"{tot['empty']} of {cfg.num_experts} groups empty): {gm['ms']:.4f} ms, "
                  f"bound {gm['bound_ms']:.4f} ms by {gm['bound_by']} = share "
                  f"{gm['bound_ms'] / gm['ms']:.3f}, plain {gm['plain_ms']:.4f} ms, "
                  "torch._grouped_mm "
                  + ("—" if gm["library_ms"] is None else f"{gm['library_ms']:.4f} ms"))
    lap("gmm")
    gen_tok_s, gen_l = tree_generate(model, cfg, TR_PROMPT, TR_NEW, "qwen3next")
    per_step = gen_l.get("flash_decode", 0) / (TR_NEW - 1)
    check(per_step == len(n_att), f"qwen3next: generate launched flash_decode {per_step} "
          f"times a step, expected {len(n_att)} (its attention layers)")
    check(gen_l.get("gmm", 0) == 3 * n_moe,
          f"qwen3next: generate's {TR_PROMPT}-token prefill launched gmm "
          f"{gen_l.get('gmm', 0)} times, expected {3 * n_moe}")
    pos = torch.tensor([TR_PROMPT + TR_NEW], dtype=torch.int32, device=dev)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    step_prof = kernel_profile(lambda i: mod.decode_step_fn(cfg, model.params, model.caches,
                                                            tok, pos), n=1)
    report.append(f"generate {TR_NEW} tokens after a {TR_PROMPT}-token prompt "
                  f"{gen_tok_s:.1f} tok/s replayed, identical, launches {json.dumps(gen_l)} "
                  f"({per_step:.0f} flash_decode a step); one decode step at pos "
                  f"{TR_PROMPT + TR_NEW} " + profile_line(step_prof, 6))
    lap("generate")
    model.init_fixed_cache(SA_MAX)
    eng_tok_s, ttft, eng_l = standalone_engine(model, cfg, "qwen3next")
    report.append(f"hybrid engine ({SA_BATCH} slots, MAX {SA_MAX}, {SA_REQS} requests of "
                  f"{SA_REQ_NEW} new tokens, {SA_STEPS} steps a dispatch, its programs "
                  f"captured by a warm-up) {eng_tok_s:.1f} tok/s replayed, TTFT p50/p95 "
                  f"{ttft[0]:.1f}/{ttft[1]:.1f} ms, every stream its prompt's generate, "
                  f"launches {json.dumps(eng_l)}")
    lap("engine")
    report.append(qwen3next_delta(mod, dev))
    lap("delta rules")
    model.graphs.reset()
    params = model.params
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report.append(qwen3next_slice(mod, cfg, params, dev))
    lap("cpu slice")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    results = {"gmm_qwen3next": gm,
               "flash_decode_qwen3next": decode_row(dev, detail, Q3N_DECODE_ROW,
                                                    "flash_decode_qwen3next",
                                                    "phase 24: qwen3next", 2424)}
    launches = {"flash_decode_qwen3next": gen_l.get("flash_decode", 0)
                + eng_l.get("flash_decode", 0),
                "gmm_qwen3next": f_l.get("gmm", 0) + gen_l.get("gmm", 0) + eng_l.get("gmm", 0)}
    for row, n in launches.items():
        check(n > 0, f"qwen3next: {row} never launched on the model's path")
    print(f"phase 24: qwen3next ({QWEN3NEXT[0]}, {cfg.num_layers} of 48 layers, hidden "
          f"{cfg.hidden_size}): " + "; ".join(report)
          + f"; {time.perf_counter() - t0:.1f} s (by section {json.dumps(secs)}) [{card}]")
    print("phase 24: qwen3next " + json.dumps(detail))
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    return launches, results


# phase 25: openai/whisper-large-v3's config.json values, recalled (the
# repository holds no copy; nothing is downloaded): 128 mel bins, width
# 1280, 32 + 32 layers of 20 heads, FFN 5120, vocab 51866, the exact GELU;
# about 1.54 B parameters, written as a bf16 checkpoint and loaded in f32
WHISPER = ("openai/whisper-large-v3", dict(
    model_type="whisper", num_mel_bins=128, d_model=1280, encoder_layers=32,
    decoder_layers=32, encoder_attention_heads=20, decoder_attention_heads=20,
    encoder_ffn_dim=5120, decoder_ffn_dim=5120, vocab_size=51866, max_source_positions=1500,
    max_target_positions=448, activation_function="gelu", eos_token_id=50257,
    decoder_start_token_id=50258))
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|> in large-v3's
# vocabulary (recalled), the new tokens, the cached steps held against the
# uncached decoder, the streamed chunks (count, seconds), the CPU slice's
# layers and decoder tokens
WH_SOT = [50258, 50259, 50360, 50364]
WH_NEW, WH_CHECK_STEPS, WH_STREAM, WH_SLICE, WH_SLICE_TOKENS = 64, 24, (6, 5.0), 2, 16
# card against CPU: the features (absolute), the cached steps' logits
# against the uncached decoder's (relative L2 a row; f32, TF32 off)
WH_MEL_TOL, WH_STEP_TOL = 1e-3, 1e-3


def whisper_audio(sr: int, seconds: float = 30.0):
    """A seeded test signal at ``sr``: a chirp from 200 Hz rising 60 Hz a
    second, a 330 Hz tone and noise, the same function of time at every
    rate."""
    import numpy as np
    t = np.arange(int(sr * seconds), dtype=np.float64) / sr
    noise = np.random.default_rng(250).standard_normal(len(t)) * 0.05
    return (0.3 * np.sin(2 * np.pi * (200.0 * t + 30.0 * t * t))
            + 0.1 * np.sin(2 * np.pi * 330.0 * t) + noise).astype(np.float32)


def whisper_flops(cfg, t: int, frames: int) -> float:
    """Products of one 30 s encode: the two stems, then per layer the four
    projections, the FFN and the attention's two products over t rows."""
    e, f = cfg.d_model, cfg.ffn_dim
    stems = 2 * frames * e * cfg.n_mels * 3 + 2 * t * e * e * 3
    return stems + cfg.encoder_layers * (2 * t * (4 * e * e + 2 * e * f) + 4 * t * t * e)


def whisper_checkpoint(root: Path, hf: dict, dev):
    """Random bf16 Whisper params of the Hugging Face config ``hf`` (seed 0)
    written under ``root`` (emptied first) as model.safetensors with
    "model." names and config.json; returns the params."""
    import shutil
    import torch
    from pygpukit_tpu_torch.asr.whisper import model as wm
    from pygpukit_tpu_torch.llm.safetensors import save_safetensors
    src = wm.init_params(wm.WhisperConfig.from_hf(hf), 0, torch.bfloat16, dev)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    save_safetensors(root / "model.safetensors",
                     {"model." + k: v for k, v in wm.hf_tensors(src).items()})
    (root / "config.json").write_text(json.dumps(hf))
    return src


def whisper_phase(dev, card: str) -> None:
    """Phase 25 (``--phases whisper``; module docstring)."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from pygpukit_tpu_torch.asr.whisper import WhisperModel
    from pygpukit_tpu_torch.asr.whisper import model as wm
    t0 = time.perf_counter()
    secs: dict = {}
    t_lap = [t0]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    cfg = wm.WhisperConfig.from_hf(WHISPER[1])
    root = ROOT / "build" / "whisper_phase"
    report = []
    try:
        src = whisper_checkpoint(root, WHISPER[1], dev)
        ckpt_gb = (root / "model.safetensors").stat().st_size / 1e9
        lap("write")
        t1 = time.perf_counter()
        model = WhisperModel.from_safetensors(root, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        same = all(a.dtype == torch.float32 and torch.equal(a, b.float()) for a, b in zip(
            torch.utils._pytree.tree_leaves(model.params), torch.utils._pytree.tree_leaves(src)))
        check(same and model.config == cfg,
              "whisper: the loaded f32 params are not the written bf16 ones")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del src
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(model.params))
    report.append(f"{nbytes / 1e9:.2f} GB of f32 params loaded from a {ckpt_gb:.2f} GB "
                  f"bf16 checkpoint in {load_s:.1f} s, bitwise the written values")
    lap("load")
    # the CPU plain path: the first WH_SLICE layers of each stack at full width
    scfg = dataclasses.replace(cfg, encoder_layers=WH_SLICE, decoder_layers=WH_SLICE)

    def sliced(where):
        p = {k: v.to(where) for k, v in model.params.items() if not isinstance(v, dict)}
        for stack in ("enc_layers", "dec_layers"):
            p[stack] = {k: v[:WH_SLICE].to(where) for k, v in model.params[stack].items()}
        return p
    cpu = WhisperModel(scfg, sliced("cpu"))
    # 1. the features at 16 kHz and at 44.1 kHz, against the CPU and again
    mel_err, mels = [], {}
    for sr in (16000, 44100):
        audio = whisper_audio(sr)
        t1 = time.perf_counter()
        mel = model.compute_mel(audio, sr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        err = float((mel.cpu() - cpu.compute_mel(audio, sr)).abs().max())
        again = torch.equal(mel, model.compute_mel(audio, sr))
        check(mel.shape == (3000, cfg.n_mels) and err <= WH_MEL_TOL and again,
              f"whisper: compute_mel at {sr} Hz: shape {tuple(mel.shape)}, max abs err "
              f"{err:.3e} against the CPU (limit {WH_MEL_TOL}), second run bitwise {again}")
        mel_err.append(f"{sr} Hz {err:.3e} ({ms:.1f} ms wall)")
        mels[sr] = mel
    report.append(f"compute_mel [3000, {cfg.n_mels}] against the CPU, max abs err: "
                  + ", ".join(mel_err)
                  + "; second runs bitwise")
    lap("features")
    # 2. the encoder: device ms by graph replay, a profile, a bitwise second encode
    mel = mels[16000]
    reset_counts()
    feats = model.encode(mel)
    check(torch.equal(feats, model.encode(mel)) and torch.isfinite(feats).all()
          and feats.shape == (cfg.max_source_positions, cfg.d_model),
          "whisper: a second encode differs (or the features are not finite)")
    with model._prec():
        enc_ms = time_ms(lambda i: wm.encoder_fn(cfg, model.params, mel), 1, reps=5)
        enc_prof = kernel_profile(lambda i: wm.encoder_fn(cfg, model.params, mel), n=1)
    flops = whisper_flops(cfg, cfg.max_source_positions, mel.shape[0])
    rate = flops / (enc_ms * 1e-3)
    report.append(f"encode 30 s: {enc_ms:.3f} ms device (graph replay) = {rate / 1e12:.2f} "
                  f"TFLOP/s of {flops / 1e12:.3f} TFLOP, {rate / PEAK_OPS_S['f32']:.3f} of the "
                  f"{PEAK_OPS_S['f32'] / 1e12:.0f} TFLOP/s f32 peak, bound "
                  f"{flops / PEAK_OPS_S['f32'] * 1e3:.3f} ms; second encode bitwise; encode "
                  + profile_line(enc_prof, 5))
    lap("encode")
    # 3. greedy transcription twice, tok/s; one step timed and profiled
    audio = whisper_audio(16000)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = model.transcribe_tokens(audio, WH_SOT, max_new_tokens=WH_NEW)
        t_all = time.perf_counter() - t1
        max_len = len(WH_SOT) + WH_NEW + 1
        t1 = time.perf_counter()
        raw = model.greedy_tokens(feats, WH_SOT, max_len, WH_NEW)
        torch.cuda.synchronize()
        runs.append((toks, raw.tolist(), t_all, time.perf_counter() - t1))
    (toks1, raw1, _, _), (toks2, raw2, t_all, t_greedy) = runs
    launched = {k: n for k, n in launch_counts().items() if n}
    check(toks1 == toks2 and raw1 == raw2 and len(raw2) == WH_NEW,
          "whisper: a second transcription's tokens differ")
    check(not launched, f"whisper: the path launched port kernels {launched}")
    exe = model.graphs.get((max_len, WH_NEW, tuple(feats.shape)))
    n = cfg.decoder_layers
    kc = torch.zeros((n, max_len, cfg.d_model), device=dev)
    vc = torch.zeros_like(kc)
    with model._prec():
        ck, cv = wm.cross_kv_fn(cfg, model.params, feats)
        pos = torch.tensor([max_len // 2], dtype=torch.int32, device=dev)
        tok = torch.tensor([WH_SOT[0]], dtype=torch.int32, device=dev)

        def step(i):
            return wm.decoder_step_fn(cfg, model.params, kc, vc, ck, cv, tok, pos)[2]
        step_ms = time_ms(step, 1, reps=20)
        step_eager = eager_ms(step, 1, iters=5)
        step_prof = kernel_profile(step, n=1)
    # a step reads the decoder's weights but the cross K/V projections, the
    # tied head, the cross K/V and the self caches, each once
    read = [v for k, v in model.params["dec_layers"].items()
            if not k.startswith(("cross.k", "cross.v"))]
    read += [model.params["tok_embed"], ck, cv, kc, vc]
    step_bound = sum(t.numel() * t.element_size() for t in read) / HBM_BYTES_S * 1e3
    report.append(
        f"transcribe_tokens ({len(WH_SOT)}-token prompt, {WH_NEW} new) twice, identical "
        f"({len(toks2)} tokens before EOS): {t_all * 1e3:.1f} ms wall a call; its greedy "
        f"loop ({max_len - 1} replays of the captured step, {exe.node_count} graph nodes) "
        f"{t_greedy * 1e3:.1f} ms = {WH_NEW / t_greedy:.1f} tok/s; one step "
        f"{step_ms:.3f} ms device (graph replay), {step_eager:.2f} ms eager wall, bound "
        f"{step_bound:.3f} ms by bytes; no port kernel "
        "launched; step " + profile_line(step_prof, 5))
    lap("transcribe")
    # 4. the cached steps against the uncached decoder over the same tokens
    seq = (WH_SOT + raw2)[:WH_CHECK_STEPS]
    kc.zero_()
    vc.zero_()
    with model._prec():
        rows = torch.stack([wm.decoder_step_fn(cfg, model.params, kc, vc, ck, cv, t, i)[2]
                            for i, t in enumerate(seq)])
    full = model.decoder_logits(seq, feats)
    rel = ((rows - full).norm(dim=-1) / full.norm(dim=-1)).max().item()
    greedy_ok = rows[len(WH_SOT) - 1:-1].argmax(-1).tolist() == seq[len(WH_SOT):]
    check(rel <= WH_STEP_TOL and greedy_ok,
          f"whisper: cached steps against decoder_logits over {len(seq)} tokens: largest "
          f"row's relative L2 {rel:.3e} (limit {WH_STEP_TOL}), argmax the stream's {greedy_ok}")
    report.append(f"cached steps against decoder_logits over {len(seq)} tokens: largest "
                  f"row's relative L2 {rel:.3e} (limit {WH_STEP_TOL}), argmax the stream's")
    lap("steps vs uncached")
    # 5. streaming over WH_STREAM chunks
    n_chunks, chunk_s = WH_STREAM
    chunk = int(16000 * chunk_s)
    t1 = time.perf_counter()
    outs = list(model.transcribe_streaming(
        (audio[i * chunk:(i + 1) * chunk] for i in range(n_chunks)), WH_SOT,
        chunk_seconds=chunk_s))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t1
    first = model.transcribe_tokens(audio[:chunk], WH_SOT)
    check(len(outs) == n_chunks and outs[0] == first,
          f"whisper: streaming gave {len(outs)} windows (expected {n_chunks}), the first "
          "not the window's own transcription")
    report.append(f"transcribe_streaming over {n_chunks} chunks of {chunk_s:.0f} s: "
                  f"{len(outs)} windows in {stream_s:.2f} s wall, the first window's tokens "
                  "its own transcription's")
    lap("streaming")
    # 6. the 2-layer slice at full width against the CPU plain path
    card_slice = WhisperModel(scfg, sliced(dev))
    f_card = card_slice.encode(mel)
    f_cpu = cpu.encode(mel.cpu())
    l_card = card_slice.decoder_logits(seq[:WH_SLICE_TOKENS], f_card)
    l_cpu = cpu.decoder_logits(seq[:WH_SLICE_TOKENS], f_cpu)
    enc_rel, dec_rel = rel_l2(f_card.cpu(), f_cpu), rel_l2(l_card.cpu(), l_cpu)
    check(enc_rel <= FWD_TOL and dec_rel <= FWD_TOL,
          f"whisper: {WH_SLICE}-layer slice card vs CPU: encoder relative L2 {enc_rel:.3e}, "
          f"decoder logits {dec_rel:.3e} (limit {FWD_TOL})")
    report.append(f"{WH_SLICE} + {WH_SLICE}-layer slice at full width, card vs CPU plain path: "
                  f"encoder output relative L2 {enc_rel:.3e}, decoder logits over "
                  f"{WH_SLICE_TOKENS} tokens {dec_rel:.3e} (limit {FWD_TOL})")
    lap("cpu slice")
    del model, card_slice, feats, ck, cv, kc, vc
    torch.cuda.empty_cache()
    print(f"phase 25: whisper ({WHISPER[0]} widths, {cfg.encoder_layers} + "
          f"{cfg.decoder_layers} layers, random weights seed 0): " + "; ".join(report)
          + f"; by section {json.dumps(secs)} [{card}]")
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s")


# phase 26: hexgrad/Kokoro-82M's config.json values as KokoroDims records
# them (178 tokens, style 128, hidden 512; ALBERT 768 wide, 12 heads, FFN
# 2048, 12 shared layers; decoder 1024, generator 512 channels, n_fft 20,
# hop 5, ups (10, 6), resblock kernels (3, 7, 11); 81.2 M f32
# parameters), random (init_random_flat, seed 0, scale 0.05), the voice
# seeded. The short string (8 ids) is synthesized on the card and on the
# CPU; the text is cut to KOK_IDS phoneme ids, a budget of (50 + 2) x 20 =
# 1040 frames (624 000 samples); the streamed text is three sentences
KOK_SHORT = "ðə kˈæts"
KOK_TEXT = ("The quick brown fox jumps over the lazy dog, and then the small "
            "computer reads every word of the sentence again.")
KOK_IDS = 50
KOK_STREAM = "The cat sat. The dog ran. The pig ran."
# card against the CPU on the short string. The float durations (relative)
# decide the alignment: a rounded duration that differs fails the phase
# rather than comparing audio under two alignments. The audio (relative
# L2): the sine source's phase is a cumulative sum times 2 pi 300, so sin()
# carries about |phase| 2^-24 of input error; and the harmonic's STFT phase
# at a bin whose spectrum is real up to rounding (the first and last frames
# are symmetric under the window) is +pi or -pi by the sign of a rounding
# residue, a flip that moved a tiny model's audio by 6.7e-3 on the CPU.
# Expected 1e-5 with no flip, up to a few 1e-2 with several.
KOK_DUR_RTOL, KOK_AUDIO_TOL = 1e-4, 5e-2
# the simple KokoroModel, card against CPU (relative L2; no STFT phase on
# its path: its vocoder's phase is pi tanh of a conv output)
KOK_SIMPLE_TOL = 1e-3
# the pipelines: the LLM at CFG_1B's widths, 2 of 22 layers, int4; its new
# tokens; the voice reply's tokens; Whisper at large-v3's widths, 2 + 2
# layers (phase 25 runs the full depth)
KOK_LLM_LAYERS, KOK_LLM_NEW, KOK_REPLY, KOK_WH_LAYERS = 2, 32, 16, 2


class EchoTokenizer:
    """The reference pipeline test's character tokenizer
    (tests/test_pipeline.py:58-63): ids to letters, text to ids below 97."""

    def encode(self, text):
        return [min(ord(c), 96) for c in text][:8]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


def kokoro_phonemes(model, text: str, n: int) -> str:
    """The first ``n`` vocabulary symbols of ``text``'s IPA (the string
    synthesize(phonemes=) encodes to ``n`` ids)."""
    ps = model.phonemizer.phonemize(text).replace("tʃ", "ʧ").replace("dʒ", "ʤ")
    kept = [c for c in ps if c in model.phonemizer.vocab]
    check(len(kept) >= n, f"kokoro: the text gives {len(kept)} phoneme ids, fewer than {n}")
    return "".join(kept[:n])


def kokoro_durations(model, ids, ref_s):
    """The float durations [S + 2] of ``ids`` (the bos/eos ids added) on the
    model's device, before rounding."""
    import torch
    from pygpukit_tpu_torch.ops.precision import f32_matmul_context
    from pygpukit_tpu_torch.tts.kokoro import arch
    p, d = model.params, model.dims
    zero = torch.zeros(1, dtype=ids.dtype, device=ids.device)
    with f32_matmul_context(p):
        bert = arch.albert_forward(torch.cat([zero, ids, zero]), p["bert"],
                                   n_layers=d.albert_layers, n_heads=d.albert_heads)
        d_en = arch.linear(bert, p["bert_encoder"]).T[None]
        return arch.predict_durations(d_en, ref_s[128:], p["predictor"], 1.0)[1]


def replay_ms(exe, args, reps: int = 5) -> float:
    """Device ms of one replay of the captured ``exe`` (CUDA events around
    ``reps`` back-to-back replays, after one)."""
    import torch
    exe.replay(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        exe.replay(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(rows: list) -> dict:
    """Device ms and kernel counts of a profile by kind: cuDNN convolutions,
    cuBLAS products (the LSTM steps' and the linears'), FFTs, elementwise
    kernels, the rest."""
    kinds = {"convs": ("conv", "cudnn", "xmma", "implicit"), "gemm": ("gemm", "gemv", "gemmk"),
             "fft": ("fft",), "elementwise": ("elementwise",)}
    out = {k: [0, 0.0] for k in (*kinds, "other")}
    for name, n, ms in rows:
        low = name.lower()
        kind = next((k for k, keys in kinds.items() if any(w in low for w in keys)), "other")
        out[kind][0] += n
        out[kind][1] += ms
    return {k: {"kernels": n, "ms": round(ms, 3)} for k, (n, ms) in out.items()}


def lstm_inputs(dims, s_len: int, frames: int, dev):
    """The 12 LSTM directions of one forward as (params, input) pairs: the
    text encoder's (512 wide), the duration encoder's three and the
    predictor's (640), over s_len tokens; the shared one over the frames."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(26)

    def x(n, w):
        return torch.randn((n, w), generator=g, device=dev) * 0.5
    h, sty = dims.hidden_dim, dims.style_dim
    return [("text_encoder", x(s_len, h)), ("duration", x(s_len, h + sty)),
            ("predictor", x(s_len, h + sty)), ("shared", x(frames, h + sty))]


def kokoro_phase(dev, card: str) -> dict:
    """Phase 26 (``--phases kokoro``; module docstring). Returns the
    launches of rows 1 and 15 in the pipelines' LLM runs."""
    import shutil
    import numpy as np
    import torch
    from pygpukit_tpu_torch.asr.whisper import WhisperModel
    from pygpukit_tpu_torch.llm import TransformerConfig
    from pygpukit_tpu_torch.ops.precision import f32_matmul_context
    from pygpukit_tpu_torch.pipeline import (LLMTTSConfig, LLMTTSPipeline, VADConfig,
                                             VoicePipeline)
    from pygpukit_tpu_torch.tts.kokoro import Kokoro82M, KokoroModel, arch, checkpoint, g2p
    from pygpukit_tpu_torch.tts.kokoro.model import carry_arrays
    from pygpukit_tpu_torch.tts.kokoro.pretrained import SAMPLE_RATE, _forward
    t0 = time.perf_counter()
    secs: dict = {}
    t_lap = [t0]

    def lap(what: str) -> None:
        now = time.perf_counter()
        secs[what] = round(now - t_lap[0], 1)
        t_lap[0] = now
    leaves = torch.utils._pytree.tree_leaves
    report = []
    root = ROOT / "build" / "kokoro_phase"
    shutil.rmtree(root, ignore_errors=True)
    (root / "voices").mkdir(parents=True)
    try:
        flat = checkpoint.init_random_flat(seed=0, scale=0.05)
        n_params = sum(a.size for a in flat.values())
        nested: dict = {}
        for name, arr in flat.items():
            top, rest = name.split(".", 1)
            nested.setdefault(top, {})[f"module.{rest}"] = torch.from_numpy(arr)
        torch.save(nested, root / "kokoro-v1_0.pth")
        del nested
        d = checkpoint.KokoroDims()
        (root / "config.json").write_text(json.dumps(
            {"n_token": d.n_token, "style_dim": d.style_dim, "hidden_dim": d.hidden_dim,
             "vocab": g2p.default_vocab()}))
        voice = np.random.default_rng(260).standard_normal((510, 1, 256)).astype(np.float32)
        torch.save(torch.from_numpy(voice * 0.1), root / "voices" / "af_heart.pt")
        lap("write")
        t1 = time.perf_counter()
        model = Kokoro82M.from_pretrained(root, voice="af_heart", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        cpu = Kokoro82M.from_pretrained(root, voice="af_heart", device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = leaves(checkpoint.load_params(flat, device="cpu"))
    del flat
    check(model.current_voice == "af_heart" and all(
        torch.equal(a.cpu(), b) for a, b in zip(leaves(model.params), want)),
        "kokoro: the loaded params are not the written checkpoint's")
    report.append(f"{n_params / 1e6:.2f} M f32 params written as a nested .pth and loaded "
                  f"on the card in {load_s:.2f} s, bitwise the written values")
    lap("load")

    # 1. a short phoneme string, card against CPU, the same draws
    ids_l = model.phonemizer.encode(phonemes=KOK_SHORT)
    check(8 <= len(ids_l) <= 12, f"kokoro: the short string has {len(ids_l)} ids")
    ids = torch.tensor(ids_l, dtype=torch.int32)
    ref_s = cpu.ref_s(len(ids_l))
    draws = cpu.draws(len(ids_l), seed=26)
    reset_counts()
    on_card = [model.forward(ids.to(dev), ref_s.to(dev), 1.0, [t.to(dev) for t in draws])
               for _ in range(2)]
    check(not {k: n for k, n in launch_counts().items() if n},
          "kokoro: the synthesis launched a port kernel (its path has none)")
    check(all(torch.equal(a, b) for a, b in zip(*on_card)),
          "kokoro: a second card run of the short string differs")
    on_cpu = cpu.forward(ids, ref_s, 1.0, draws)
    dur_card = kokoro_durations(model, ids.to(dev), ref_s.to(dev)).cpu()
    dur_cpu = kokoro_durations(cpu, ids, ref_s)
    dur_rel = float(((dur_card - dur_cpu).abs() / dur_cpu.abs()).max())
    margins = [float(((d - d.floor()) - 0.5).abs().min()) for d in (dur_card, dur_cpu)]
    print(f"phase 26: short string ({len(ids_l)} ids) float durations card vs CPU: largest "
          f"relative difference {dur_rel:.3e} (limit {KOK_DUR_RTOL}), the nearest to a "
          f"rounding boundary {margins[0]:.4f} (card) / {margins[1]:.4f} (CPU)")
    check(dur_rel <= KOK_DUR_RTOL, "kokoro: the float durations differ card vs CPU")
    check(torch.equal(on_card[0][1].cpu(), on_cpu[1]),
          f"kokoro: a rounded duration differs card vs CPU ({on_card[0][1].tolist()} against "
          f"{on_cpu[1].tolist()}): not comparing audio under two alignments")
    audio_rel = rel_l2(on_card[0][0].cpu(), on_cpu[0])
    total_s = len(on_cpu[0]) / SAMPLE_RATE
    check(torch.isfinite(on_card[0][0]).all() and audio_rel <= KOK_AUDIO_TOL,
          f"kokoro: short string card vs CPU audio relative L2 {audio_rel:.3e} (limit "
          f"{KOK_AUDIO_TOL})")
    report.append(f"short string ({len(ids_l)} ids, {int(on_cpu[2])} frames, {total_s:.2f} s "
                  f"of budget) card vs CPU: durations equal (float {dur_rel:.3e}, margins "
                  f"{margins[0]:.4f}/{margins[1]:.4f}), audio relative L2 {audio_rel:.3e} "
                  f"(limit {KOK_AUDIO_TOL}), a second card run bitwise, no port kernel")
    del cpu
    lap("short vs cpu")

    # 2. the ~50-phoneme text: twice bitwise, replayed and eager times, a profile
    ps = kokoro_phonemes(model, KOK_TEXT, KOK_IDS)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs.append(model.synthesize(phonemes=ps, seed=0))
        runs[-1] = (runs[-1], time.perf_counter() - t1)
    (r1, first_s), (r2, wall_s) = runs
    check(np.array_equal(r1.audio, r2.audio) and np.isfinite(r2.audio).all(),
          "kokoro: a second synthesis of the text differs (or is not finite)")
    lap("text synthesis")
    total = (KOK_IDS + 2) * model.max_frames_per_token
    exe = model.graphs.get((KOK_IDS, total))
    ids50 = torch.tensor(model.phonemizer.encode(phonemes=ps), dtype=torch.int32, device=dev)
    args = (model.params, ids50, model.ref_s(KOK_IDS), 1.0, *model.draws(KOK_IDS, 0))
    dev_ms = replay_ms(exe, args)
    fwd = functools.partial(_forward, model.dims, total, model.max_frames_per_token)
    with f32_matmul_context(model.params):
        wall_ms = eager_ms(lambda i: fwd(*args), 1, iters=2)
        prof = kernel_profile(lambda i: fwd(*args), n=1)
        lstm_args = lstm_inputs(model.dims, KOK_IDS + 2, total, dev)
        pred = model.params["predictor"]
        lstm_p = {"text_encoder": model.params["text_encoder"]["lstm"],
                  "duration": pred["text_encoder"]["blocks"][0]["lstm"],
                  "predictor": pred["lstm"], "shared": pred["shared"]}
        per = {k: time_ms(lambda i, k=k, x=x: arch.bilstm(x, lstm_p[k]), 1, reps=3)
               for k, x in lstm_args}
    lstm_ms = per["text_encoder"] + 3 * per["duration"] + per["predictor"] + per["shared"]
    audio_s = len(r2.audio) / SAMPLE_RATE
    split = kernel_split(prof)
    report.append(
        f"text of {KOK_IDS} ids ({total} frames, {len(r2.audio)} samples = {audio_s:.2f} s): "
        f"twice bitwise; {dev_ms:.3f} ms device by graph replay ({exe.node_count} graph "
        f"nodes), {wall_ms:.1f} ms eager wall, synthesize {wall_s * 1e3:.1f} ms wall "
        f"(first call {first_s:.2f} s, capture included) = {audio_s / wall_s:.1f} audio s a "
        f"wall s; the 12 LSTM directions alone {lstm_ms:.3f} ms by graph replay (the shared "
        f"one over {total} frames {per['shared']:.3f}); one eager call by kind "
        f"{json.dumps(split)}; " + profile_line(prof, 5))
    lap("text timing")

    # 3. streaming over three sentences
    t1 = time.perf_counter()
    outs = list(model.synthesize_streaming(KOK_STREAM))
    stream_s = time.perf_counter() - t1
    check(len(outs) == 3 and all(np.isfinite(o.audio).all() and len(o.audio) for o in outs),
          f"kokoro: streaming gave {len(outs)} segments (expected 3) or non-finite audio")
    report.append(f"synthesize_streaming over 3 sentences: {len(outs)} segments, "
                  f"{sum(len(o.audio) for o in outs) / SAMPLE_RATE:.2f} s of audio in "
                  f"{stream_s:.2f} s wall")
    lap("streaming")

    # 4. the simple KokoroModel at its default config, card against CPU
    simple_cpu = KokoroModel(device="cpu")
    simple = KokoroModel(device=dev)
    carry_arrays(simple, simple_cpu)
    a, b = simple.synthesize("hello world."), simple_cpu.synthesize("hello world.")
    simple_rel = rel_l2(torch.from_numpy(a.audio), torch.from_numpy(b.audio)) \
        if a.audio.shape == b.audio.shape else float("inf")
    check(simple_rel <= KOK_SIMPLE_TOL,
          f"kokoro: the simple model card vs CPU: {a.audio.shape} against {b.audio.shape} "
          f"samples, relative L2 {simple_rel:.3e} (limit {KOK_SIMPLE_TOL})")
    report.append(f"the simple KokoroModel (default config) card vs CPU on the CPU's weights: "
                  f"{len(a.audio)} samples, relative L2 {simple_rel:.3e} "
                  f"(limit {KOK_SIMPLE_TOL})")
    del simple, simple_cpu
    lap("simple model")

    # 5. the LLM -> TTS pipeline on the 2-layer 1.1B int4 LLM
    llm = build_model(TransformerConfig(**dict(CFG_1B, num_layers=KOK_LLM_LAYERS)), 0, dev)
    texts: list = []
    reset_counts()
    t1 = time.perf_counter()
    outs = list(LLMTTSPipeline(llm, EchoTokenizer(), model, LLMTTSConfig(
        max_new_tokens=KOK_LLM_NEW, temperature=0.0)).run([5, 10, 15], on_text=texts.append))
    pipe_s = time.perf_counter() - t1
    pipe_launches = {k: n for k, n in launch_counts().items() if n}
    check(outs and all(np.isfinite(o.audio).all() and len(o.audio) for o in outs)
          and len("".join(texts)) == KOK_LLM_NEW,
          "kokoro: the LLM -> TTS pipeline gave no finite audio (or not its tokens' text)")
    check(pipe_launches.get("w4a8_gemv", 0) > 0 and pipe_launches.get("flash_decode", 0) > 0,
          f"kokoro: the pipeline's LLM launched {pipe_launches}, not rows 1 and 15")
    report.append(f"LLMTTSPipeline (1.1B widths, {KOK_LLM_LAYERS} layers, int4, greedy, "
                  f"{KOK_LLM_NEW} tokens): {len(outs)} sentence(s), "
                  f"{sum(len(o.audio) for o in outs) / SAMPLE_RATE:.2f} s of audio in "
                  f"{pipe_s:.2f} s wall, launches {json.dumps(pipe_launches)}")
    lap("llm tts")

    # 6. the voice pipeline: Whisper (large-v3 widths, 2 + 2 layers) -> LLM -> Kokoro
    wroot = ROOT / "build" / "kokoro_whisper"
    try:
        whisper_checkpoint(wroot, dict(WHISPER[1], encoder_layers=KOK_WH_LAYERS,
                                       decoder_layers=KOK_WH_LAYERS), dev)
        asr = WhisperModel.from_safetensors(wroot, dtype=torch.float32, device=dev)
    finally:
        shutil.rmtree(wroot, ignore_errors=True)
    t = np.arange(8000) / 16000
    tone = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    chunks = [np.zeros(4000, np.float32), tone, np.zeros(4000, np.float32)]
    reset_counts()
    t1 = time.perf_counter()
    events = list(VoicePipeline(asr, llm, EchoTokenizer(), model, sot_sequence=WH_SOT,
                                vad_config=VADConfig(min_speech_frames=2),
                                max_reply_tokens=KOK_REPLY).run(chunks))
    voice_s = time.perf_counter() - t1
    voice_launches = {k: n for k, n in launch_counts().items() if n}
    kinds = [e.kind for e in events]
    want = EchoTokenizer().decode(asr.transcribe_tokens(np.concatenate(chunks[1:]), WH_SOT))
    check(kinds == ["speech_start", "transcript", "reply", "audio"]
          and events[1].text == want and np.isfinite(events[3].audio).all(),
          f"kokoro: the voice pipeline's events {kinds} (the transcript "
          f"{events[1].text if len(events) > 1 else None!r} against {want!r})")
    report.append(f"VoicePipeline (Whisper large-v3 widths {KOK_WH_LAYERS} + {KOK_WH_LAYERS} "
                  f"layers f32, the LLM, Kokoro-82M) on silence, 0.5 s of 220 Hz, silence: "
                  f"events {kinds}, the transcript ({len(want)} tokens) transcribe_tokens', "
                  f"{len(events[3].audio) / SAMPLE_RATE:.2f} s of reply audio, {voice_s:.2f} s "
                  f"wall, launches {json.dumps(voice_launches)}")
    lap("voice")
    del asr, llm, model
    torch.cuda.empty_cache()
    print(f"phase 26: kokoro (hexgrad/Kokoro-82M dims, random weights seed 0): "
          + "; ".join(report) + f"; by section {json.dumps(secs)} [{card}]")
    print(f"phase 26 took {time.perf_counter() - t0:.1f} s")
    return {k: pipe_launches.get(k, 0) + voice_launches.get(k, 0)
            for k in ("w4a8_gemv", "flash_decode")}


def main(argv: list[str]) -> int:
    t_script = time.perf_counter()
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; a subset prints no summary and no device line")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    bad = sorted(set(phases) - set(PHASES))
    if bad:
        ap.error(f"unknown phases {bad}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "pygpukit_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: pygpukit_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from pygpukit_tpu_torch import require_cuda, set_deterministic_numerics
    from pygpukit_tpu_torch.core.device import card_peaks
    from pygpukit_tpu_torch.kernels import _build
    from pygpukit_tpu_torch.llm import TransformerConfig

    global CARD, HBM_BYTES_S, PEAK_OPS_S
    dev = require_cuda()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    HBM_BYTES_S = peaks["hbm_bytes_s"]
    PEAK_OPS_S = {kind: peaks[kind] for kind in ("bf16", "int8", "f32")}
    set_deterministic_numerics()     # TF32 off: the plain integer dots stay exact
    card = CARD = smi_line()
    print(f"card: {card}")
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc: {nvcc_v}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    t_start = time.perf_counter()
    lib = _build.build()
    print(f"phase 2: built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t_start:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "(C75" in line:
            print("  ptxas: " + line.strip())

    results: dict = {}
    if "kernels" in phases:
        results, detail = check_kernels(dev)
        g = torch.Generator(device=dev)
        g.manual_seed(4321)
        results.update(check_ladder_kernels(dev, g, detail))
        check_conv_kernels(dev, g, detail)
        results.update(check_flash_kernels(dev, g, detail))
        results.update(check_gemm_kernels(dev, g, detail))
        results.update(check_fused_decode(TransformerConfig(**CFG_1B), dev, g, detail))
        results.update(check_gmm_kernels(dev, g, detail))
        print("phase 3: kernels match their plain versions")
        print("kernel_times " + json.dumps(detail))
        print("phase 3: bounds " + json.dumps({
            name: {"ms": r["ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"]}
            for name, r in results.items()}))

    cfg = TransformerConfig(**CFG_1B)
    rng = np.random.default_rng(0)
    requests = dense_requests(cfg, rng)
    launches: dict = {}
    # launches per decode step, prefill or forward, by kernel, recorded by
    # the phase that drives each path: name -> (launches, what ran once)
    per_step: dict = {}
    if {"dense", "paged", "tight"} & set(phases):
        t0 = time.perf_counter()
        model = build_model(cfg, 0, dev)
        torch.cuda.synchronize()
        print(f"phase 4: 1.1B int4 model built in {time.perf_counter() - t0:.1f} s")
        # each kernel's launches from the run of the path it belongs to
        if "dense" in phases:
            dense = dense_path(model, requests, per_step)
            launches.update({name: dense[name] for name in DENSE_KERNELS})
        if "paged" in phases:
            launches["paged_attention"] = paged_path(model, cfg, rng,
                                                     per_step)["paged_attention"]
        if "tight" in phases:
            tight_pool(model, cfg, rng)
        print(f"phases 4-8 took {time.perf_counter() - t0:.1f} s")
        del model
        torch.cuda.empty_cache()
    if "ladder" in phases:
        t0 = time.perf_counter()
        for name, n in ladder(cfg, dev, card, per_step).items():  # w4a8_gemv: phase 4's
            launches.setdefault(name, n)
        print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    if "block" in phases:
        t0 = time.perf_counter()
        block_engine(cfg, dev, requests)
        print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    if "parity" in phases:
        cpu_parity(cfg, dev, requests[0][0])
    if "forward" in phases:
        launches["flash_attention"] = forward_phase(cfg, dev, card,
                                                    per_step)["flash_attention"]
    if "ops" in phases:
        launches.update(ops_phase(cfg, dev, card, per_step))
    if "decode" in phases:
        launches.update(decode_phase(cfg, dev, card, per_step))
    if "moe" in phases:
        launches["gmm"] = moe_phase(dev, card, per_step)["gmm"]
    if "kv" in phases:
        kv_phase(cfg, dev, card)
    if "strategies" in phases:
        launches_16 = strategies_phase(cfg, dev, card, per_step)
        print("phase 16: launches " + json.dumps(launches_16))
    if "graphs" in phases:
        launches_17 = graphs_phase(cfg, dev, card, requests)
        print("phase 17: launches " + json.dumps({k: n for k, n in launches_17.items() if n}))
    if "load" in phases:
        load_phase(cfg, dev, card)
    if "families" in phases:
        d256_launches, d256 = families_phase(dev, card)
        launches.update(d256_launches)
        results.update(d256)
    if "rope" in phases:
        d96_launches, d96 = rope_phase(dev, card)
        launches.update(d96_launches)
        results.update(d96)
    if "conventions" in phases:
        d80_launches, d80 = conventions_phase(dev, card)
        launches.update(d80_launches)
        results.update(d80)
    if "standalone" in phases:
        launches["gmm"] = launches.get("gmm", 0) + standalone_phase(dev, card)
    if "trees" in phases:
        d64_launches, d64 = trees_phase(dev, card)
        launches.update(d64_launches)
        results.update(d64)
    if "qwen3next" in phases:
        q3n_launches, q3n = qwen3next_phase(dev, card)
        launches.update(q3n_launches)
        results.update(q3n)
    if "whisper" in phases:
        whisper_phase(dev, card)
    if "kokoro" in phases:
        for name, n in kokoro_phase(dev, card).items():   # rows 1 and 15 in the pipelines
            launches[name] = launches.get(name, 0) + n
    print(f"total {time.perf_counter() - t_start:.1f} s after the build began, "
          f"{time.perf_counter() - t_script:.1f} s the whole script")
    if set(phases) != set(PHASES):
        print(f"partial run ({args.phases}): no summary")
        return 0

    print("launches_per_step " + json.dumps(per_step))
    summary = {"kernels": []}
    sources = dict(SOURCES, **{row: SOURCES[base]
                               for row, (base, _) in {**D256_ROWS, **D96_ROWS,
                                                      **D80_ROWS, **D64_ROWS,
                                                      **Q3N_ROWS}.items()})
    for name, (src, rep) in sources.items():
        summary["kernels"].append({"name": name, "route": "cuda", "source": src,
                                   "replaces": rep, "launches": launches[name],
                                   **results[name]})
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
