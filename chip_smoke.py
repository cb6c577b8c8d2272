#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

  python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each of which raises on failure:
  1. card: name and power limit (nvidia-smi); build the CUDA kernels from
     src/repro_torch/csrc with nvcc, all sources in parallel; print
     ptxas' registers, spills and notes, and fail if it serialized
     sampled_softmax.cu's wgmma pipeline (C7512/C7518/C7520).
  2. kernels vs plain versions on the card, at glm4_9b's widths (H=32,
     K=2, hd=128, 16-token pages), over bf16, int8 and fp8 pools (the
     narrow ones with fp32 per-row scales, dequantized in-tile): each
     output row within 1e-2 relative to its norm, every value within 1e-2
     absolute (1e-2 relative above a magnitude of 1).
     a. decode (8 sequences up to 2048 tokens) and a 256-row prefill
        chunk: a 1-row chunk equals a decode step bit for bit; inactive
        and padding rows are exact zeros; decode and chunk at zamba2's
        shared attention (H = K = 32, hd 80, bf16); window + softcap at hd
        128 and 16; the gather from the 151552 x 4096 embedding table
        and from mamba2_370m's and zamba2_2p7b's tables (bit for bit; at
        glm4's table 1, 8, 256 and 4096 ids, ids 0 and V - 1 and
        out-of-range ids, which count from the end when negative and are
        then clamped, as jnp indexes); its times at 8, 256
        and 4096 ids beside index_select's, by events and from the
        profiler, and the event time of a one-element launch (the floor).
     b. the packed (ragged) kernel: T=512 flat rows, S=4 sequences with
        q_lens [200, 96, 150, 40] at ctx [2048, 96, 700, 1000] (one fresh
        prompt, 26 rows that no sequence owns), without and with the
        fused KV write: a 1-sequence launch equals the chunk kernel and
        each packed sequence equals its unpacked launch, bit for bit; pool
        bytes after the fused write equal the separate scatter; the fused
        output equals the kernel run after that scatter, bit for bit;
        unowned rows are exact zeros.
     c. the SSD scan at mamba2_370m's (nh 32, hp 64, N 128) and
        zamba2_2p7b's (nh 80, hp 64, N 64) widths, 256-row chunks, one and
        two sequences of one and two chunks, plus the smoke widths and a
        grouped case: y rows within 1e-2 of their norm, h_last within
        1e-3 of max(1, |plain|); one launch over 512 rows equals two
        launches of 256 with the state carried, and rows with dt = 0
        leave h_last and the earlier rows' y unchanged, bit for bit, eager
        and under CUDA-graph replay (the replay equal to the eager
        launch); the one-launch graph's edges by type show whether the
        capture kept the programmatic dependent launch. Its two launches
        (C B^T, then the scan) timed by events, by the profiler (their
        sum and each) and as a span on the device.
     d. the flash attention forward at glm4_9b's training shape (B=2,
        S=2048, H=32, K=2, hd=128, causal), with window 512 and cap 50,
        256 rows at q_offset 1792, non-causal 200 rows, hd 16 (the mma
        route), and on the hd-128 route's 128-row and 128-key tile edges
        (Sq 129 and 255, Skv 130 non-causal, 148 rows at q_offset 1900,
        window 100 with cap 50): o rows within 1e-2 of dense_attention's,
        lse within 1e-3 of the plain logsumexp, FlashAttention's dq/dk/dv
        within 1e-2 of each gradient's max against autograd through
        dense_attention, and two launches bit-equal. The hd-128 route's
        time beside scaled_dot_product_attention's (events and profiler,
        TFLOP/s), the hd-16 route's time, and the hd-128 route at one key
        tile per block, non-causal S=2048 and causal S=8192.
     e. the sampled-softmax loss at glm4_9b's 151552 x 4096 bf16 head,
        n = 8192 sampled ids, T = 4096 and 4095, no cap and cap 30; the
        GEMM launch's tile edges there (n = 8000 and 64, T = 100) and
        zamba2_2p7b's 32000 x 2560 head; accidental hits planted: within
        1e-4 relative of the plain loss, two launches bit-equal. Its
        device time by launch (the two gathers, the GEMM launch and its
        TFLOP/s, row loss, mean) and torch.mm's time for the same bf16
        product (gemm_ms, a yardstick the port never calls).
     f. the rest of the dense family's heads at hd 128, bf16 pools:
        gemma2_27b (H=32, K=16) with its local layers' window 4096, cap
        50 and scale 144^-0.5 at contexts to 6144 (and its global layers'
        cap and scale), qwen3_32b (64, 8) and starcoder2_3b (24, 2)
        causal at glm4's lengths: decode (8 sequences), a 256-row chunk
        and the packed kernel (T=512, S=4, fused write) against their
        plain versions, decode == chunk(C=1), packed S=1 == chunk, packed
        == unpacked and fused == scatter bit for bit; the flash forward at
        gemma2's 6144-token prompt (window, cap, scale) and causal S=2048
        at the other two, and at phase 10's static prefill shapes (B=8,
        S=512 for each; B=2, S=6000 for gemma2, a partial last row tile),
        gemma2 also with its global layers' options: o within 1e-2 of the
        plain version (fp32, one rounding; each value, and each row) and
        each row within 1e-2 of dense_attention's, lse within 1e-3 of the
        plain one, two launches bit-equal; beside SDPA where SDPA computes the same function (no
        softcap: for gemma2 SDPA's causal time is a yardstick); the gather at each member's table (256000 x 4608,
        152064 x 5120, 49152 x 3072). Under "<member>_" keys of each
        kernel's row.
     g. this slice's shapes: the flash forward's hd-64 route ("wgmma64",
        a row of its own: "flash_attention_wgmma64") at whisper's heads (H
        = K = 20): the encoder's non-causal 1500 x 1500 (B 1 and 8), a
        chunk's cross attention (256 x 1500), causal S 512 (B 8) and
        window 256 + cap 30 at q_offset 300 (700 x 1000), each o held as
        in 2f, lse within 1e-3, two launches bit-equal, each timed (CUDA
        events and profiler device time) beside its bound, all but the
        last beside SDPA (the same function) under both timers, the first
        against its plain version too; decode, a 256-row
        chunk (decode == chunk(C=1) bit for bit, padding rows zero) at
        whisper's hd 64, G 1, and decode, chunk and packed at qwen3_moe's
        (H 32, K 4) and grok1's (48, 8, cap 30) heads; the flash forward
        at qwen3_moe's and qwen2_vl's (12, 2) static prefill shapes; the
        gather at the four tables (152064 x 2048, 131072 x 6144, 51968 x
        1280, 152064 x 1536). Under "qwen3_moe_", "grok1_", "whisper_",
        "qwen2_vl_" keys.
     h. the flash forward's hd-80 route ("wgmma80", a row of its own:
        "flash_attention_wgmma80") at zamba2's shared block (H = K = 32):
        causal B 2 x S 2048 (training), B 8 x S 512 (phase 14's static
        prefill), causal S 1500 (ragged) and window 256 + cap 30 at
        q_offset 300, held and timed as in 2g; the mma route ("mma", row
        "flash_attention_mma") at hd 16, 8 and 12 (4 q heads, 2 kv heads;
        causal S 300, hd 12 with window 64, cap 30 and q_offset 100, hd 8
        non-causal 130 x 200) likewise, and over 64 seeded draws of each
        of those shapes against the plain fp32 version (its o in bf16,
        and unrounded), the worst row errors printed ("draws_" keys); the SSD autograd function (the
        kernel forward, the plain recompute backward) at mamba2's and
        zamba2's widths, b 2 x S 2048, 256-row chunks: its gradients for
        x, dt, A, B and C against autograd through ssd_chunked, every row
        within 1e-2 of its norm, its forward and backward times ("mamba2_"
        and "zamba2_function_" keys of the ssd row).
     Times each kernel, its plain version and the one-call library
     equivalent where there is one, with the L2 cache flushed per call.
  3. serving: glm4_9b at full width and depth (40 layers, random weights
     from a seed) through repro_torch.serving.InferenceEngine: 8 requests
     of 512 tokens sharing a 256-token prefix, 32 new tokens each, 256-
     token chunks, bf16 pools. Phases 3-6 run the engine's default on the
     card, its two step shapes as CUDA graphs; phase 3, phase 4's first
     run and every phase 5 run are repeated eager (cuda_graphs=False, the
     same weights and requests) and their greedy tokens must be
     byte-identical. A graph engine captures both shapes before its run
     (engine.capture_graphs, as at a server's start-up; the time is
     printed apart). Each run prints tok/s, TTFT, token gap, the mean
     wall time of decode and chunk steps (each shape's first step left
     out), the body's device span per step by CUDA events around the
     replay (or the eager body), the busy share by those events (their
     sum over the run's wall time; for eager, whose events also span the
     host's launch gaps, the graph run's device time over the eager
     wall), peak memory, the graph pool's memory and the decode step's
     bytes floor (weights and the fp32 head at HBM rate).
  4. packed serving over int8 pools: the same model and weights,
     prefill_pack 4, max_batch 8, a 520-token step budget (512-row chunk
     row), 16 requests at step 0 with prompts of 96-480 tokens (seed 0),
     the first 8 sharing a 128-token prefix, 16 new tokens each: some
     step carries >= 2 chunks, prefix hits, int8 pools. Then four shorter
     runs of the first 8 requests (4 new tokens) cover the other pool and
     pack pairs: (4, bf16), (4, fp8), (1, int8), (1, fp8).
  5. SSM and hybrid serving at full width and depth (random weights from
     seed 0, max_batch 8, a 264-token budget: 256-token chunks, the SSD
     chunk size): mamba2_370m (48 layers) with 8 prompts of 512 tokens
     (32 new tokens each), then 8 of 300-500 tokens (16 new: a quantized
     256-token chunk and a final exempt one); zamba2_2p7b (54 mamba
     layers, the shared attention block every 6) with 8 of 512 tokens (16
     new). The ssd kernel launches once per mamba layer and chunk.
     The chunk graph's edges by type (full, programmatic) are printed.
     Before every serving run each kernel's launch count is zeroed; after
     it the run's kernels must have launched, replay-aware: the counters'
     own launches (a graph's warm-up and capture) plus, per step shape,
     replays x the launches its capture recorded; on graphs each kernel
     must be in a replayed graph. Every kernel variant in the summary
     launched on one of these full-width graph runs.
  6. card vs CPU: the same engine at smoke size on both, same weights and
     requests: glm4 at (prefill_pack, kv_dtype) = (1, bf16), (4, bf16),
     (4, int8) and (1, fp8), mamba2 and zamba2 with quantized chunks (and
     zamba2 preempting): greedy tokens must agree, except after a first
     difference whose top-2 logit margin is below the bf16 tolerance. On
     the card, pack 4 and pack 1 give the same bf16 tokens. gemma2_27b's
     smoke config at packs 1 and 4 (its 16-token window, both softcaps
     and post-block norms through the hd-16 kernels).
  7. training: glm4_9b at full width with 8 of its 40 layers (seeded fp32
     masters, bf16 working params, AdamW with fp32 slots, remat full),
     6 steps of B=2 x S=2048 from ShardedSource(seed=0) through
     launch.train.train: every loss finite, the last below the first,
     every parameter leaf with a finite non-zero gradient on step 1, the
     flash kernel launched 2 x layers x steps times on its hd-128 (wgmma)
     route and never on the hd-16 one, and the gather once per step;
     per-step ms, tokens/s and peak memory (after collecting the earlier
     phases' garbage); then one more step
     under torch.profiler (device time by kernel, busy share).
  8. training card vs CPU at smoke size: the same fp32 masters and three
     batches, 2 microbatches, remat full, SGD: losses within 1e-2, grad
     norms within 1e-2 relative, masters within 1e-2 of the largest
     update (glm4); then mamba2, zamba2, qwen3_moe, grok1, whisper (seeded
     frames) and qwen2_vl (its smoke config, hd 12 on the flash kernel's
     mma route), each held to the larger of those limits
     and twice its noise floor (CPU runs with one-ulp flips in 0.5% of
     the embedding outputs and of whisper's frames), the masters held
     leaf by leaf (each leaf's difference over its own update against
     twice that leaf's floor); a MoE model's CPU runs replay the card's
     routing.
  9. the sampling surface at glm4_9b's full width and depth (phase 3's
     weights, CUDA graphs; run between phases 4 and 5, while they are on
     the card): a. jax's threefry bits for 64 (seed, rid, counter, tag)
     keys over 151552 words equal on the card and the CPU, the Gumbel
     noise within 2 ulp of max(1, |g|), the first words printed; the
     in-graph draw's device time over (9, 151552) rows (plain, full, an
     argmax). b. a
     greedy + temperature/top-k batch alone (greedy and plain graphs) and
     beside one logprobs request (full graphs): byte-identical tokens;
     eight mixed requests (greedy; t 0.8 top-k 50; top-p 0.9 min-p 0.05;
     repetition/presence/frequency penalties; logprobs 5; a stop sequence
     from the first run's greedy output; min_new over an EOS; top-k +
     top-p + logprobs 3) on graphs and eager: tokens and logprobs
     byte-identical, the stop retires its request where the greedy stream
     completes it. Per (shape, mode): step ms, replay device ms, capture
     s and the graph pool. c. speculative decoding, k = 2: a self-draft
     sharing the weights, a fresh glm4_9b draft of 4 layers, the
     self-draft at t = 0.8; greedy runs equal the plain greedy graph run
     (near-tie rule on the card's logits; whether bitwise is printed);
     mean_accept_len, tok/s, spec step ms, peak GiB. Phase 2a times the
     chunk kernel at the verify shape (B=8, C=3, ctx up to 2048) against
     its plain version ("verify_" keys of its summary row, with its
     launches inside phase 9c's verify passes, counted around the verify
     call and replay-aware: ``verify_launches``, the replays' part
     ``verify_replayed_launches``).
  10. the rest of the dense family at full width and depth (failing if a
     model does not fit the card), random weights from seed 0, one model
     at a time, each freed before the next: qwen3_32b (64 layers),
     gemma2_27b (46) and starcoder2_3b (30). Phase 3's traffic on CUDA
     graphs and eager (byte-identical greedy tokens); the static path
     (models.api.generate_static: prefill through the flash kernel,
     plain decode attention over dense caches) on the same prompts: the
     logits after the prompts of the static prefill and of the engine
     path are held against an fp32 reading of the same weights (plain
     attention, no kernel), the static path at most twice as far from it
     as the engine path, and its greedy tokens must equal the engine's
     up to a near-tie below the sum of those two distances (or 1e-2);
     a prefill_pack 4 run of the same prompts (4 new tokens), equal to
     the pack-1 run's first 4 up to a near-tie below twice the engine
     path's distance (or 1e-2). gemma2 serves two 6000-token prompts the
     same three ways, past its 4096-key window. Per run: tok/s, decode
     and chunk step ms (wall and device), busy share, TTFT, token gap,
     peak memory and the decode step's bytes floor; each member's
     launches per kernel ("<member>_launches", replay-aware) go into the
     kernels' rows.
  11. abort, the host swap tier, the front end and the fleet, at glm4_9b's
     full width and depth on phase 3's weights and traffic, on CUDA graphs
     (run after phase 9, while those weights are on the card):
     a. 80 allocatable blocks with a 1 GiB pinned host tier, swap_policy
        "always" (graphs and eager), "never" (recompute), and a pool that
        never preempts; then the same three over int8 pools at
        prefill_pack 4: greedy tokens byte-identical in all, >= 2 swap
        preemptions, swapped bytes = blocks x block bytes, every block and
        host slot free at the end; the swap copies' device times per swap
        beside a plain pinned copy_ of the same bytes ("[serve-swap]").
     b. the 8 requests through AsyncEngineDriver over the swap engine:
        when request 0 has 4 tokens it and one waiting request (a swapped
        one if any) are aborted; the other 6 streams equal a run without
        the two, byte for byte ("[serve-abort]").
     c. FrontendServer on 127.0.0.1 (port 0), 8 concurrent SSE clients,
        one gone after 4 tokens: the other 7 equal engine.run()'s tokens,
        one abort, /health 200, /metrics parses as Prometheus text with
        repro_engine_tokens_total == the tokens streamed; TTFT and token
        gap as the clients saw them ("[serve-http]").
     d. ReplicaRouter over 2 engines on the one card sharing the weights
        and a 512-slot SharedPrefixIndex (320 MiB pinned), then with
        disaggregate=True, n_prefill=1: tokens byte-identical to dp = 1,
        blocks published and adopted across replicas; a full-sampling
        request submitted mid-run makes one replica capture its graphs in
        the middle of the other's run (the other's replays timed: some
        before, none inside, under the process-wide device lock, some
        after), and its tokens and logprobs equal its eager run alone;
        tok/s, peak memory and the handoff's bytes and copy time
        ("[serve-fleet]").
     Each run's launches go into the kernels' rows, replay-aware.
     ``python3 chip_smoke.py --phase 11`` runs the build and phase 11
     alone (a development run: no result line).
  12. mixture of experts, the encoder-decoder and M-RoPE at full width
     (run last; random weights from seed 0; one model at a time, each
     freed before the next; "[serve-slice]", "[static]" lines):
     a. qwen3_moe_30b_a3b (24 of its 48 layers since phase 18): phase 3's
        traffic on graphs and
        eager (byte-identical), a prefill_pack 4 run over int8 pools (4
        new; the MoE block at T = 512); at capacity factor 16 (no drops)
        and 4 of the 48 layers (at 48 the fp32 reading no longer tells
        the two bf16 paths apart) an eager engine run (8 new) recording
        each row's experts, and the static path held against the fp32
        reading as in phase 10, every run there replaying the engine's
        routing (``RouteLog``: bf16 rounding sends some rows to other
        experts on each path, which moves their outputs by far more than
        a rounding; the distances without the replay are printed
        beside).
     b. grok1_314b at full width with 4 of its 64 layers: phase 3's
        traffic, 16 new, graphs == eager.
     c. whisper_large_v3 (32 + 32 layers): 8 requests of 128 tokens with
        distinct seeded frames (1500 x 1280), 32 new, graphs == eager; the
        static path's tokens == the engine's up to a near-tie; a 41-block
        pool that preempts (encodes >= 8 + preemptions, tokens == the
        roomy run's up to a near-tie); the encode's device time.
     d. qwen2_vl_2b (28 layers), static path: B 8 x S 512 with distinct
        M-RoPE planes (a 16 x 16 image grid, then text), 32 new; prefill
        logits 4 times closer to the fp32 reading at those planes than
        the fp32 reading at 1-D positions is, first tokens == the fp32
        reading's up to a near-tie.
     Per run: tok/s, decode step ms (wall, device) beside its bytes floor
     (a MoE decode reads every expert), peak GiB; each member's launches
     per kernel ("<member>_launches"). ``python3 chip_smoke.py --phase
     12`` runs the build and phase 12 alone, ``--phase 2g`` the build and
     phase 2g (development runs: no result line).
  13. training of every family at full width (run after phase 12; each
     model freed before the next; "[train-family]" lines): mamba2_370m (24
     of its 48 layers), zamba2_2p7b (30 of 54), qwen3_moe_30b_a3b (4 of
     48), whisper (32 encoder + 16 of 32 decoder layers; 1500 x 1280
     seeded frames, 448 tokens), qwen2_vl_2b (14 of 28; phase 12d's
     3-plane positions; the cuts since phase 18, for the run's time
     limit), B 2 x 2048, seeded fp32 masters, 4 AdamW
     steps (remat full) on one fixed batch: finite losses, the last below
     the first; a finite, non-zero gradient on every parameter leaf on
     step 1; launches: the ssd kernel once per mamba layer per forward
     and recompute, flash on wgmma80 / wgmma / wgmma64 likewise (whisper: its
     encoder, decoder self and cross attention), the gather once a step;
     step ms, tok/s, peak GiB (qwen3_moe's aux beside ce); one profiled
     step of each SSM model (device ms by kernel, the SSD forward's and
     its plain backward's shares); mamba2 and qwen3_moe one step's loss
     and gradient under remat none, full and dots (within 1e-6 relative;
     bitwise equality and each mode's peak printed).
  14. the SSM static path (inside phase 5, on its weights and 512-token
     prompts; "[static]", "[static-ssm]" lines): generate_static with 32
     new tokens at full depth (tok/s, prefill and decode step times,
     launches: the ssd kernel once per mamba layer, wgmma80 once per
     period) held against the engine path by static_vs_engine (the fp32
     reading, the static path at most twice as far), tokens counted;
     then at mamba2's first 4 layers and zamba2's first 6 (one period)
     against an eager engine run there, tokens held to the near-tie rule
     (deeper, the random weights amplify bf16 rounding past what the
     fp32 reading resolves).
  15. checkpoint and resume (inside phase 13's mamba2 run): the state
     after step 2 saved asynchronously, restored onto the card, step 3
     rerun: loss, grad norm and every master equal to the uninterrupted
     step 3, bit for bit; restored onto the CPU with restore_to: equal to
     the state the card saved, bf16 leaves through their uint16 view.
  16. the paper's dataflow core and the parameter-server trainer
     (``repro_torch.core``, ``repro_torch.ps``; run last, under 120 s;
     "[core]", "[core-gather]", "[fig9]", "[fig6]", "[fig7]", "[fig8]",
     "[dispatch]" lines): a. test_core_engine's graphs (autodiff, a
     variable across tasks, scatter-add, Switch/Merge, Figure 3's
     partition/gather/stitch with gradients at rows of 2 and 16 floats,
     queue back-pressure, Send/Recv, 16 concurrent steps, the reference's
     two placement faults) with every task on the card against the same
     graphs on the CPU: lookups, stitches, state and integers bit for bit,
     the rest within 1e-5 of the largest value; fetches stay on the card;
     an out-of-range Gather id is clamped on the card and raises
     IndexError on the CPU. b. (inside phase 2 in the whole run, where
     the profiler's traces hold) the gather kernel at the core's float32
     rows (4 and 8 bytes on its 4-byte word path, 64 and 2048 on the
     16-byte one), 1, 32 and 4096 ids with negative and out-of-range
     ones: bit-equal to gather_plain; times (events, profiler) beside
     gather_plain, index_select and the bytes bound ("core_" keys of the
     gather row); the copy a Gather from a transposed shard makes.
     c. Figure 9: the
     LSTM LM at LSTM-512-512, vocabulary 40,000, 512 sampled classes,
     batch 64, unroll 8, full and sampled softmax over 1, 2 and 4 PS
     tasks, async with 2 workers: words/s, step ms, busy share (profiler
     device time over wall), ops a replica step; a replica step alone and
     at a 0.2 ms interpreter switch interval; one sync step's loss and
     gradients on the card against the CPU (each within 1e-4 of its max
     magnitude); the PS tasks on the CPU with the workers on the card
     (bytes and copy time a step). d. Figure 6's null steps over 4 PS
     tasks: scalar, dense 100 MB and 1 GB, sparse (a 1 GB table of
     16-float rows, 32 rows gathered and scatter-added), 1/2/4/8 client
     threads: median step ms. e. Figures 7 and 8 at the JAX package's
     linear_model shapes: examples/s; median step, normalized speedup and
     discards with 0-3 backup workers. f. 2,000 chained Identity (and
     Neg) ops: ops/s against the paper's 2,000,000. The gather launches
     of c and d count as the gather's main-path launches.
  17. tensor-parallel paged serving and the kernels' partials (run last):
     a. the decode and chunk kernels' block_mask / return_lse partials at
        glm4_9b's widths (H 32, K 2, hd 128) over bf16, int8 and fp8
        pools, half the table entries attended: o rows within 1e-2 and
        lse within 1e-3 of the plain partials, the same rows empty; a
        full mask's o in bf16 byte-equal to the plain launch; P = 2 == P
        = 1 byte for byte; paged_shard_attention over 1-4 shards within
        1e-2 of the unsharded kernel; each variant timed beside its
        bound (rows "<kernel>_partial", "<kernel>_<pool>_partial"), and
        its entry points driven once with the counters zeroed (their
        launches are the rows' main-path launches).
     b-c. glm4_9b at full width, 20 of its 40 layers since phase 18
        (phase 3's traffic, 16 new),
        zamba2_2p7b at full width with 6 of 54 layers and whisper with 4
        + 4 of 32 + 32 (16 and 32 new), each first on one eager engine in
        a spawned process (tp = 1), then on 2 spawned ranks over a mesh
        model=2 (gloo with both on cuda:0 on a one-card machine, NCCL
        with a card each): both ranks' tokens, the bits of every emitted
        token's fp32 logits row and the scheduling stats equal tp = 1's
        (a failure names the first difference, both top-2 margins there
        and the first decoder block whose output differs), each rank's
        kv-head cache half of tp = 1's; the backend and the rank-to-card
        map, tok/s, gathers and staged copies and bytes ("[tp]" lines).
        Every rank's exit code and result is checked.
  18. multi-rank training (``train_mesh``; "[train-mesh]" lines):
     glm4_9b at full width and 4 of its 40 layers, global batch 4 x 2048
     from ShardedSource(seed=0), remat full, AdamW, 3 steps, each mesh in
     spawned processes sharing the card over gloo (every collective
     staged through pinned host memory). a. tp = dp = 1, run twice (the
     same bits), and card vs CPU at phase 8's smoke setup and the same
     depth: the floors; the tolerance is 4 x the larger. b. data=2 with
     ZeRO-1: losses and grad norms within it, both ranks' working params
     the same bits after every step, then save_global of the state. c.
     model=2: the same gaps; the norms (unsharded) the same bits on both
     ranks. d. 18b's checkpoint through restore_for_mesh at model=2,
     every shard its leaf's slice bit for bit, then a fourth step within
     the tolerance of 18a's. Per rank: flash (hd 128) 2 x layers x steps
     and gather ``steps`` launches; ms a step, tok/s, staged bytes a
     step and peak memory a rank, beside the card's name and power
     limit. A rank that fails or hangs past its timeout fails the run,
     naming its rank and phase.
  19. weight-sharded tensor-parallel serving (``shard_params=True``) and
     the MoE block's mesh modes (its runs share phase 17's spawned
     processes, before phase 18; "[tp-shard]", "[moe-mesh]" lines), two
     ranks on a mesh model=2 (gloo, both on cuda:0 on a one-card
     machine), eager, phase 3's traffic (32 new tokens a request), each
     against a tp = 1 run of the same seed-0 weights in the tp = 1
     process: a. qwen3_moe_30b_a3b at full width, 12 of its 48 layers
     (decode steps "ep_psum", 256-row chunks "ep_a2a"); b. glm4_9b at
     phase 17's depth (its tp = 1 run is phase 17's); c. grok1_314b, 2
     of its 64 layers, ``expert_ff_2d``. A MoE run's base is tp = 1
     replaying the mesh's routing (``models.moe_replay``: the mesh's
     experts at every row, its mode's capacity rule), a dense run's tp =
     1 itself. Rank 0's tokens equal the base's up to a first difference
     at a near-tie (the base's scores put rank 0's token less than TOL,
     or twice the two rows' largest |difference| there, below its own);
     the largest |difference| between every emitted token's fp32 logits
     row up to each parting and the base's is at most
     SHARD_FLOOR_FACTOR x the floor measured in the same run, the base
     again with one-ulp flips in FLIP_SHARE of its embedding outputs
     (printed against TOL). A MoE run also: every call replayed, every
     keep mask the mesh's capacity rule's, the router log-probabilities
     of the rows both runs share within SHARD_FLOOR_FACTOR x the floor's,
     each row the replay's own router routes elsewhere within twice its
     gap of a tie (the widest printed). 19b's control, rank 1's ``wo`` of
     layer CONTROL_LAYER zeroed, must land past its gate. Both ranks the
     same tokens; scheduling stats equal tp = 1's; each rank's weight
     bytes at most 0.55 of tp = 1's; the paged decode and chunk kernels
     and the gather launched on both ranks; the MoE modes each run must
     show. Printed: tok/s, weight bytes and peak GiB a rank, mode counts,
     collectives and their bytes, launches by rank. d. qwen3_moe's MoE
     block alone at full width, "ep_psum" on 8 decode rows and "ep_a2a"
     on a 512-row chunk, against the plain one-process emulation of the
     same per-shard capacity on the card: every row within TOL of its
     norm, on both ranks.
  Every kernel must have launched on a serving or training path, except
  sampled_softmax_loss, which no model path of either package calls.
  ``python3 chip_smoke.py --phase 2h,14,13,8`` runs some phases alone, in
  the order given (also 2g, 12, 16, 17, 17a, 18 and 19; "13 ARCH ..."
  some of phase 13's models): development runs, no result line.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or run from a
directory that does not hold the repo, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
TOL = 1e-2
DEV = "cuda"                     # every phase runs on the card
WATCHDOG_S = 1140                # the run's time limit is 1200 s
KV_DTYPES = ("bf16", "int8", "fp8")
DECODE_SRC = "src/repro_torch/csrc/paged_attention.cu"
RAGGED_SRC = "src/repro_torch/csrc/ragged_paged_attention.cu"
SSD_SRC = "src/repro_torch/csrc/ssd.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
SAMPLED_SRC = "src/repro_torch/csrc/sampled_softmax.cu"
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:203",
            "paged_prefill_attention":
                "src/repro/kernels/paged_attention.py:417",
            "ragged_paged_prefill_attention":
                "src/repro/kernels/paged_attention.py:682",
            "gather": "src/repro/kernels/embedding.py:23",
            "ssd": "src/repro/kernels/ssd.py:80",
            "flash_attention": "src/repro/kernels/flash_attention.py:202",
            "sampled_softmax_loss":
                "src/repro/kernels/sampled_softmax.py:47"}
# the ssd kernel's final state against the plain scan: 1e-3 absolute
# (tests/test_kernels.py's tolerance) where the state is below 1 in
# magnitude, 1e-3 relative above
SSD_H_TOL = 1e-3
# keys of a kernel's row that its summary carries besides the contract's
SUMMARY_EXTRAS = ("kernel_route", "tflops", "floor_ms", "ms_8", "ms_4096",
                  "library_ms_8", "library_ms_4096", "span_ms", "gemm_ms",
                  "gemm_device_ms")
# the flash kernel's lse against the plain logsumexp of the masked logits
LSE_TOL = 1e-3
# sampled-softmax loss, kernel against plain: both sum exact bf16 products
# in fp32, in other orders
SAMPLED_TOL = 1e-4
# ptxas' notes that it serialized a kernel's wgmma.mma_async instructions
# (a silent 25-50% slowdown)
WGMMA_SERIALIZED = ("C7512", "C7518", "C7520")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card: bytes over HBM rate or
    operations over the bf16 peak, whichever is larger. The paged kernels
    dequantize int8/fp8 keys and values to bf16 before the products, so
    their operations count at the bf16 rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# the counter key whose launches keep the kernel's own summary name: the
# bf16 pool for the paged kernels, the hd-128 route for flash attention
MAIN_VARIANT = {"flash_attention": "wgmma"}


def variant(kernel: str, key: str) -> str:
    """Summary name of a kernel's launches under one counter key (a pool
    dtype, or a flash route)."""
    return kernel if key == MAIN_VARIANT.get(kernel, "bf16") \
        else f"{kernel}_{key}"


def kv_row_bytes(kv: str, K: int, hd: int) -> int:
    """Bytes of one token's K (or V) across its kv heads, scales included."""
    return K * (2 * hd if kv == "bf16" else hd + 4)


class Timer:
    """Per-call device time by CUDA events, the L2 cache flushed (a
    256 MB write) before every call, as the engine's 40 layers see it."""

    # the L2 flush's kernel names, from the first trace of it alone
    flush_keys = None

    def __init__(self, torch):
        self.torch = torch
        self.scratch = torch.empty(256 << 20, dtype=torch.uint8,
                                   device=DEV)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def span(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Device time per call from its first kernel's start to its last
        one's end, gaps included: CUDA events around the call, enqueued
        behind a ~1 ms sleep kernel so that the host's enqueue time is off
        the clock (it is not for __call__); the L2 flushed before each."""
        torch = self.torch
        total = 0.0
        for i in range(warmup + iters):
            self.scratch.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= warmup:
                total += start.elapsed_time(end)
        return total / iters

    def trace(self, f, iters: int) -> dict:
        """{kernel name: (launches, device us)} of ``iters`` calls of
        ``f``, each after the L2 flush, under torch.profiler. A trace can
        miss the launches of its first moments (on the card, after some
        engines had run), so eight spin kernels, a wait and 20 ms go
        first; they are left out."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(iters):
                self.scratch.zero_()
                f()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.device_type.name == "CUDA"
                and "spin_kernel" not in e.key}

    def kernels(self, fn, iters: int = 10, tries: int = 4):
        """Device time per call of ``fn`` by kernel name, in ms, the
        flush's kernels left out; None (not measured) where no trace of
        ``tries`` passes its check. A trace can lose records or gain an
        earlier one's (one showed the kernel under test in the flush's own
        trace, and so its time as 0), so the flush is the check: its
        kernels, named from one trace of the flush alone, must show
        exactly ``iters`` times, and every other kernel a whole multiple
        of ``iters``, at least one."""
        if not Timer.flush_keys:
            alone = self.trace(lambda: None, 5)
            Timer.flush_keys = {k for k, (n, _) in alone.items() if n == 5}
        fn()
        for _ in range(tries):
            got = self.trace(fn, iters)
            mine = {k: v for k, v in got.items() if k not in Timer.flush_keys}
            if Timer.flush_keys and mine and all(
                    got.get(k, (0,))[0] == iters
                    for k in Timer.flush_keys) and all(
                    n % iters == 0 for n, _ in mine.values()):
                return {k: t / iters / 1e3 for k, (_, t) in mine.items()}
        print(f"[timer] no trace of {tries} passed its check ({iters} "
              "calls): flush kernels " + json.dumps(
                  {k[:60]: got.get(k, (0,))[0]
                   for k in Timer.flush_keys or ()}) + ", launches not a "
              f"multiple of {iters}: " + json.dumps(
                  {k[:60]: n for k, (n, _) in mine.items() if n % iters}),
              flush=True)
        return None

    def device(self, fn, iters: int = 10):
        """Device time per call of ``fn`` from ``kernels``, summed; None
        where the trace failed its check."""
        by_kernel = self.kernels(fn, iters)
        return None if by_kernel is None else sum(by_kernel.values())


def fmt(v, spec: str = ".5f") -> str:
    """A time, or "not measured" where the profiler's trace failed its
    check."""
    return "not measured" if v is None else format(v, spec)


def per_ms(work, ms):
    """``work`` per second over ``ms`` milliseconds, in units of 1e12
    (TFLOP/s for flops); None where the time was not measured."""
    return None if ms is None else work / ms * 1e-9


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def paged_case(torch, gen, B, H, K, hd, bs, nb, ctx, C=None):
    """Random bf16 pools, disjoint random block tables, int32 metadata."""
    N = 1 + B * nb
    qshape = (B, H, hd) if C is None else (B, C, H, hd)
    q = torch.randn(qshape, generator=gen, device=DEV).bfloat16()
    kp = torch.randn((N, bs, K, hd), generator=gen, device=DEV).bfloat16()
    vp = torch.randn((N, bs, K, hd), generator=gen, device=DEV).bfloat16()
    perm = torch.randperm(N - 1, generator=gen, device=DEV) + 1
    bt = perm[:B * nb].reshape(B, nb).to(torch.int32).contiguous()
    ctx = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    return q, kp, vp, bt, ctx


def pools_in(kv, kp, vp):
    """bf16 pools -> (k, v, scale keywords) stored as ``kv``."""
    if kv == "bf16":
        return kp, vp, {}
    from repro_torch.models.quant import quantize_kv
    k, ks = quantize_kv(kp, kv)
    v, vs = quantize_kv(vp, kv)
    return k, v, {"k_scale": ks, "v_scale": vs}


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_err(a, b) -> float:
    """Largest relative error over the output rows (one head's hd
    values): ||a - b|| / ||b||. A zero row of b must be zero in a too
    (0/0 counts as 0, x/0 as huge). This scales the tolerance to each
    row, so a long context's small outputs are held as tightly as a short
    one's."""
    import torch
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1)
    return float(torch.nan_to_num(rel, nan=0.0).max())


def check_close(name: str, a, b) -> tuple[float, float]:
    """Kernel vs plain: every row within TOL relative to its norm, and
    every value within TOL absolute as an outer cap, TOL relative where
    the plain value exceeds 1 in magnitude (there one bf16 ulp of the
    output is 2^-8 relative: 0.0156 between 2 and 4, which rows that see
    only a few keys reach). Returns (max abs err, max row relative
    err)."""
    e, r = err(a, b), row_err(a, b)
    scaled = float(((a.float() - b.float()).abs()
                    / b.float().abs().clamp(min=1.0)).max())
    check(scaled <= TOL and r <= TOL, f"{name}: max abs err {e} ({scaled} "
          f"scaled to max(1, |plain|)), max row relative err {r} (limit "
          f"{TOL})")
    return e, r


def same_bytes(a, b) -> bool:
    import torch
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def timed(timer, kernel, plain, prefix="") -> dict:
    """Event and profiler device times of a kernel and its plain version:
    {prefix}ms, {prefix}device_ms, {prefix}plain_ms,
    {prefix}plain_device_ms."""
    return {f"{prefix}ms": timer(kernel),
            f"{prefix}device_ms": timer.device(kernel),
            f"{prefix}plain_ms": timer(plain),
            f"{prefix}plain_device_ms": timer.device(plain)}


def check_paged(torch, timer, gen, rows):
    """Decode and chunk kernels over every pool dtype (phase 2a)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import paged_chunk_attention_xla

    H, K, hd, bs = 32, 2, 128, 16
    # decode: 8 sequences, contexts up to 2048, one inactive slot
    ctx = [2048, 1536, 1024, 777, 2000, 1, 0, 300]
    B, nb = len(ctx), 2048 // bs
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb,
                                         ctx)
    ones = torch.ones(B, dtype=torch.int32, device=DEV)
    S = sum(ctx)
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        o_k = pa.paged_attention(q, kp, vp, bt, ctxt, **sc)
        o_p = ref.paged_attention_ref(q, kp, vp, bt, ctxt, **sc)
        e, rel = check_close(f"paged_attention[{kv}] vs plain", o_k, o_p)
        check(bool((o_k[6] == 0).all()),
              f"paged_attention[{kv}]: ctx=0 row not zero")
        # a one-row chunk is a decode step, bit for bit
        o_c = pa.paged_prefill_attention(q[:, None].contiguous(), kp, vp, bt,
                                         ctxt, ones, **sc)
        check(torch.equal(o_c[:, 0], o_k), f"[{kv}] chunk(C=1) != decode "
              "bitwise")
        check(same_bytes(o_k, pa.paged_attention(q, kp, vp, bt, ctxt, **sc)),
              f"paged_attention[{kv}]: two launches differ")
        b_dec = (2 * q.numel() * 2 + 2 * S * kv_row_bytes(kv, K, hd)
                 + bt.numel() * 4 + B * 4)
        if kv == "bf16":
            split = timer.kernels(lambda: pa.paged_attention(q, kp, vp, bt,
                                                             ctxt))
            print("[kernels] paged_attention device ms by kernel: " + (
                "not measured" if split is None else ", ".join(
                    f"{k.split('<')[0].split()[-1]} {v:.4f}"
                    for k, v in split.items())), flush=True)
        rows[variant("paged_attention", kv)] = dict(
            kernel="paged_attention", source=DECODE_SRC,
            max_abs_err=e, max_row_rel_err=rel,
            **timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt,
                                                      **sc),
                    lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                    **sc)),
            library_ms=None,
            shape=f"B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_dec, 4.0 * S * H * hd))))

    # chunked prefill: one 256-row chunk ending at 2048 tokens, 200 rows
    # valid (the rest are padding and must come out as exact zeros)
    C, qlen, ctx1 = 256, 200, 2048
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, 1, H, K, hd, bs, nb,
                                         [ctx1], C=C)
    ql = torch.tensor([qlen], dtype=torch.int32, device=DEV)
    keys = sum(ctx1 - qlen + i + 1 for i in range(qlen))   # causal pairs
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **sc)
        o_p = paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql, **sc)
        e, rel = check_close(f"paged_prefill_attention[{kv}] vs plain",
                             o_k[:, :qlen], o_p[:, :qlen])
        check(bool((o_k[:, qlen:] == 0).all()),
              f"[{kv}] chunk padding rows not zero")
        check(same_bytes(o_k, pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                         ql, **sc)),
              f"paged_prefill_attention[{kv}]: two launches differ")
        b_chk = (2 * q.numel() * 2 + 2 * ctx1 * kv_row_bytes(kv, K, hd)
                 + bt.numel() * 4 + 8)
        rows[variant("paged_prefill_attention", kv)] = dict(
            kernel="paged_prefill_attention", source=DECODE_SRC,
            max_abs_err=e, max_row_rel_err=rel,
            **timed(timer, lambda: pa.paged_prefill_attention(
                        q, kp, vp, bt, ctxt, ql, **sc),
                    lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                                      **sc)),
            library_ms=None,
            shape=f"B=1 C={C} q_len={qlen} ctx={ctx1} H={H} K={K} hd={hd}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_chk, 4.0 * keys * H * hd))))

    # the speculative verify pass at glm4's widths: the chunk kernel over
    # the whole decode batch, k + 1 = 3 rows a sequence, contexts up to
    # 2048 (one slot inactive), bf16 pools
    ctxv = [2048, 1536, 1024, 777, 2000, 3, 0, 300]
    Bv, Cv = len(ctxv), 3
    q, kp, vp, bt, ctxt = paged_case(torch, gen, Bv, H, K, hd, bs, nb, ctxv,
                                     C=Cv)
    ql = torch.tensor([Cv if c else 0 for c in ctxv], dtype=torch.int32,
                      device=DEV)
    o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)
    o_p = paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql)
    # the plain version averages every value of an empty (ctx 0) row,
    # which the engine discards; the kernel writes zeros there
    act = [i for i, c in enumerate(ctxv) if c]
    e, rel = check_close("paged_prefill_attention verify shape vs plain",
                         o_k[act], o_p[act])
    check(bool((o_k[6] == 0).all()), "verify shape: inactive row not zero")
    keys_v = sum(c - Cv + i + 1 for c in ctxv if c for i in range(Cv))
    b_v = (2 * q.numel() * 2 + 2 * sum(ctxv) * kv_row_bytes("bf16", K, hd)
           + bt.numel() * 4 + 2 * Bv * 4)
    vb = bound_ms(b_v, 4.0 * keys_v * H * hd)
    rows["paged_prefill_attention"].update(
        **timed(timer, lambda: pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                          ql),
                lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql),
                "verify_"),
        verify_bound_ms=vb[0], verify_bound_by=vb[1], verify_max_abs_err=e,
        verify_max_row_rel_err=rel,
        verify_shape=f"B={Bv} C={Cv} ctx={ctxv} H={H} K={K} hd={hd}")
    r = rows["paged_prefill_attention"]
    print(f"[kernels] chunk kernel at the verify shape (B={Bv}, C={Cv}): "
          f"device {fmt(r['verify_device_ms'])} ms (events "
          f"{r['verify_ms']:.5f}), plain device "
          f"{fmt(r['verify_plain_device_ms'])}, bound {vb[0]:.5f} "
          f"({vb[1]}), max abs err {e:.3g}", flush=True)

    # zamba2_2p7b's shared attention: H = K = 32 (G = 1), hd = 80, bf16
    # pools (the hybrid runner keeps bf16), decode and a 256-row chunk
    H8, K8, hd8 = 32, 32, 80
    ctx8 = [1024, 700, 300, 1, 0, 512, 999, 64]
    nb8 = 1024 // bs
    q, kp, vp, bt, ctxt = paged_case(torch, gen, len(ctx8), H8, K8, hd8, bs,
                                     nb8, ctx8)
    o_k = pa.paged_attention(q, kp, vp, bt, ctxt)
    e, rel = check_close("paged_attention hd=80 G=1 vs plain", o_k,
                         ref.paged_attention_ref(q, kp, vp, bt, ctxt))
    check(bool((o_k[4] == 0).all()), "paged_attention hd=80: ctx=0 row "
          "not zero")
    row = rows["paged_attention"]
    b_dec = (2 * q.numel() * 2 + 2 * sum(ctx8) * kv_row_bytes("bf16", K8, hd8)
             + bt.numel() * 4 + len(ctx8) * 4)
    hd80 = bound_ms(b_dec, 4.0 * sum(ctx8) * H8 * hd8)
    row.update(**timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt),
                       lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt),
                       "hd80_"),
               hd80_bound_ms=hd80[0], hd80_bound_by=hd80[1],
               hd80_max_abs_err=e, hd80_max_row_rel_err=rel,
               hd80_shape=f"B={len(ctx8)} H={H8} K={K8} hd={hd8} bs={bs} "
                          f"ctx={ctx8}")
    C8, qlen8, c8 = 256, 256, 768
    q, kp, vp, bt, ctxt = paged_case(torch, gen, 1, H8, K8, hd8, bs, nb8,
                                     [c8], C=C8)
    ql = torch.tensor([qlen8], dtype=torch.int32, device=DEV)
    o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)
    e, rel = check_close("paged_prefill_attention hd=80 G=1 vs plain", o_k,
                         paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql))
    keys8 = sum(c8 - qlen8 + i + 1 for i in range(qlen8))
    b_chk = (2 * q.numel() * 2 + 2 * c8 * kv_row_bytes("bf16", K8, hd8)
             + bt.numel() * 4 + 8)
    hd80 = bound_ms(b_chk, 4.0 * keys8 * H8 * hd8)
    rows["paged_prefill_attention"].update(
        **timed(timer, lambda: pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                          ql),
                lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql),
                "hd80_"),
        hd80_bound_ms=hd80[0], hd80_bound_by=hd80[1], hd80_max_abs_err=e,
        hd80_max_row_rel_err=rel,
        hd80_shape=f"B=1 C={C8} q_len={qlen8} ctx={c8} H={H8} K={K8} "
                   f"hd={hd8}")
    print(f"[kernels] decode and chunk at hd=80, G=1 (zamba2_2p7b): within "
          f"{TOL}", flush=True)

    # window + softcap, multi-sequence chunks with an empty one, at the
    # full head dim and the smoke head dim
    for (Hs, Ks, hds) in ((H, K, hd), (4, 2, 16)):
        q, kp16, vp16, bt, ctxt = paged_case(torch, gen, 3, Hs, Ks, hds, bs,
                                             8, [128, 37, 0], C=40)
        ql = torch.tensor([40, 11, 0], dtype=torch.int32, device=DEV)
        q1 = q[:, 0].contiguous()
        ctx_d = torch.tensor([128, 27, 0], dtype=torch.int32, device=DEV)
        kw = dict(window=50, cap=30.0)
        for kv in KV_DTYPES:
            kp, vp, sc = pools_in(kv, kp16, vp16)
            o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **kw,
                                             **sc)
            o_r = ref.paged_prefill_attention_ref(q, kp, vp, bt, ctxt, ql,
                                                  **kw, **sc)
            check_close(f"window+cap chunk hd={hds} [{kv}]", o_k, o_r)
            check(bool((o_k[1, 11:] == 0).all() and (o_k[2] == 0).all()),
                  f"window+cap chunk hd={hds} [{kv}]: padding rows not "
                  "zero")
            o_d = pa.paged_attention(q1, kp, vp, bt, ctx_d, **kw, **sc)
            check_close(f"window+cap decode hd={hds} [{kv}]", o_d,
                        ref.paged_attention_ref(q1, kp, vp, bt, ctx_d, **kw,
                                                **sc))
        print(f"[kernels] window=50 cap=30 hd={hds}: chunk and decode "
              f"within {TOL} over {'/'.join(KV_DTYPES)} pools", flush=True)


# contexts of the bitwise decode == chunk(C=1) cases: the edges of the
# kernel's 64-key steps and 256-key segments (csrc/paged_attention.cuh's
# kStep and kSeg), four segments and three keys, one key, an inactive slot
EDGE_CTX = [63, 65, 255, 257, 1027, 64, 1, 0]
# (H, K, hd): glm4_9b, zamba2_2p7b's shared attention, their smoke heads
HEAD_SHAPES = [(32, 2, 128), (32, 32, 80), (4, 2, 16)]
EDGE_OPTS = [{}, {"window": 50, "cap": 30.0}]
EDGE_CHUNK = 70           # rows of the chunk ending at max(EDGE_CTX)


def check_paged_edges(torch, gen):
    """Phase 2a's bitwise cases, at every head shape, block sizes 8 and 32,
    every pool, without and with window 50 + cap 30: decode ==
    chunk(C=1) at EDGE_CTX; a chunk of EDGE_CHUNK rows ending at 1027
    keys equals one decode step per row; two launches equal; ctx = 0 rows
    exact zeros; both within TOL of the plain decode."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    n, worst = 0, 0.0
    for H, K, hd in HEAD_SHAPES:
        for bs in (8, 32):
            B, nb = len(EDGE_CTX), -(-max(EDGE_CTX) // bs)
            q, kp16, vp16, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs,
                                                 nb, EDGE_CTX)
            ones = torch.ones(B, dtype=torch.int32, device=DEV)
            # the chunk: sequence 4's table (1027 keys), rows at positions
            # 957..1026; as decode steps, row i sees ctx 958 + i
            C, end = EDGE_CHUNK, max(EDGE_CTX)
            qc = torch.randn((1, C, H, hd), generator=gen,
                             device=DEV).bfloat16()
            btc = bt[4:5].contiguous()
            ctxc = torch.tensor([end], dtype=torch.int32, device=DEV)
            qlc = torch.tensor([C], dtype=torch.int32, device=DEV)
            bt_rows = btc.expand(C, nb).contiguous()
            ctx_rows = torch.arange(end - C + 1, end + 1, dtype=torch.int32,
                                    device=DEV)
            for kv in KV_DTYPES:
                kp, vp, sc = pools_in(kv, kp16, vp16)
                for opts in EDGE_OPTS:
                    name = (f"edges H={H} K={K} hd={hd} bs={bs} [{kv}] "
                            f"{opts or 'no window/cap'}")
                    o_d = pa.paged_attention(q, kp, vp, bt, ctxt, **opts,
                                             **sc)
                    o_c = pa.paged_prefill_attention(
                        q[:, None].contiguous(), kp, vp, bt, ctxt, ones,
                        **opts, **sc)
                    check(torch.equal(o_c[:, 0], o_d),
                          f"{name}: chunk(C=1) != decode")
                    check(same_bytes(o_d, pa.paged_attention(
                        q, kp, vp, bt, ctxt, **opts, **sc)),
                          f"{name}: two decode launches differ")
                    check(bool((o_d[EDGE_CTX.index(0)] == 0).all()),
                          f"{name}: ctx=0 row not zero")
                    worst = max(worst, check_close(
                        f"{name} decode vs plain", o_d,
                        ref.paged_attention_ref(q, kp, vp, bt, ctxt, **opts,
                                                **sc))[1])
                    o_ch = pa.paged_prefill_attention(qc, kp, vp, btc, ctxc,
                                                      qlc, **opts, **sc)
                    o_rows = pa.paged_attention(qc[0], kp, vp, bt_rows,
                                                ctx_rows, **opts, **sc)
                    check(torch.equal(o_ch[0], o_rows),
                          f"{name}: a {C}-row chunk != its rows as decode "
                          "steps")
                    n += 1
    print(f"[kernels] paged edges: decode == chunk(C=1) at ctx {EDGE_CTX} "
          f"and a {EDGE_CHUNK}-row chunk == its rows as decode steps, bit "
          f"for bit, two launches equal, ctx=0 rows zero, over {n} cases "
          f"(heads {HEAD_SHAPES}, bs 8/32, {'/'.join(KV_DTYPES)}, "
          f"{EDGE_OPTS}); decode within {worst:.3g} of plain (row relative)",
          flush=True)


def mma_zero_rows_probe(torch, gen, warps=4096) -> dict:
    """mma.sync m16n8k16 with zero A rows on random bf16 B and random fp32
    C (an eighth of it +0.0 or -0.0): the zero rows' results against C,
    bit for bit. A skipped, fully masked step relies on them being
    equal."""
    import ctypes
    from repro_torch.kernels import build
    vp, i = ctypes.c_void_p, ctypes.c_int
    probe = build.load("paged_attention").paged_mma_zero_rows_probe
    probe.argtypes, probe.restype = [vp] * 4 + [i, vp], i

    def words(n):
        x = torch.randn(2 * n, generator=gen, device=DEV).bfloat16()
        return x.view(torch.int32)

    a, b = words(warps * 128), words(warps * 64)
    c = torch.randn(warps * 128, generator=gen, device=DEV)
    pick = torch.randint(0, 16, c.shape, generator=gen, device=DEV)
    c[pick == 0] = 0.0
    c[pick == 1] = -0.0
    out = torch.empty_like(c)
    rc = probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
               warps, build.current_stream(c))
    check(rc == 0, f"mma zero-rows probe launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    zero_rows = (torch.arange(c.numel(), device=DEV) // 32) % 4 < 2
    cz, oz = c[zero_rows], out[zero_rows]
    same = cz.view(torch.int32) == oz.view(torch.int32)
    neg0 = cz.view(torch.int32) == torch.tensor(-0.0).view(torch.int32)
    res = {"values": int(cz.numel()), "bit_equal": int(same.sum()),
           "differ_nonzero_c": int((~same & (cz != 0)).sum()),
           "neg_zero_c": int(neg0.sum()),
           "neg_zero_kept": int((same & neg0).sum()),
           "other_rows_finite": bool(torch.isfinite(out[~zero_rows]).all())}
    print(f"[kernels] mma.sync zero A rows: {res}", flush=True)
    check(res["differ_nonzero_c"] == 0 and res["other_rows_finite"],
          "mma.sync with zero A rows changed a non-zero C value")
    return res


def ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx):
    """Random packed inputs: q (T, H, hd), bf16 pools, tables, the packing
    of ``q_lens`` into T rows (pack_ragged), new K/V rows (T, K, hd)."""
    import numpy as np
    from repro_torch.serving.engine import pack_ragged
    S, nb = len(q_lens), -(-max(ctx) // bs)
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, S, H, K, hd, bs, nb,
                                         ctx, C=T)
    _, seq, st, en = (torch.from_numpy(a).to(DEV) for a in pack_ragged(
        [np.zeros(n) for n in q_lens], T, S))
    pad = torch.ones(T, dtype=torch.bool, device=DEV)
    for a, b in zip(st.tolist(), en.tolist()):
        pad[a:b] = False
    check(int(pad.sum()) == T - sum(q_lens), "packing")
    kn16 = torch.randn((T, K, hd), generator=gen, device=DEV).bfloat16()
    vn16 = torch.randn((T, K, hd), generator=gen, device=DEV).bfloat16()
    return dict(q=q[0].contiguous(), kp16=kp16, vp16=vp16,
                seqs=(bt, ctxt, st, en), seq=seq, pad=pad, kn16=kn16,
                vn16=vn16)


def ragged_checks(torch, inp, kv, name, opts=None) -> dict:
    """The packed kernel over one pool dtype, bit for bit: a 1-sequence
    launch equals the chunk kernel, each packed sequence its unpacked
    launch, pool bytes after the fused write the separate scatter, the
    fused output the kernel after that scatter, two launches each other;
    unowned rows exact zeros; within TOL of plain without and with the
    write. ``opts``: window, cap and scale, for every launch. Returns the
    tensors the timings reuse and the errors."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import (ragged_chunk_attention_xla,
                                              update_paged_cache_ragged)
    from repro_torch.models.quant import quantize_kv

    opts = opts or {}
    q, seqs, seq, pad = inp["q"], inp["seqs"], inp["seq"], inp["pad"]
    bt, ctxt, st, en = seqs
    own = ~pad
    zero1 = torch.zeros(1, dtype=torch.int32, device=DEV)
    kp, vp, sc = pools_in(kv, inp["kp16"], inp["vp16"])
    o_k = pa.ragged_paged_prefill_attention(q, kp, vp, *seqs, **sc, **opts)
    check(same_bytes(o_k, pa.ragged_paged_prefill_attention(
        q, kp, vp, *seqs, **sc, **opts)),
          f"{name}: two launches differ")
    o_p = ragged_chunk_attention_xla(q, kp, vp, *seqs, seq, **sc, **opts)
    e_n, rel_n = check_close(f"{name} vs plain", o_k[own], o_p[own])
    check(bool((o_k[pad] == 0).all()), f"{name}: unowned rows not zero")
    # one sequence alone == the chunk kernel; packed == unpacked
    for s, (a, b) in enumerate(zip(st.tolist(), en.tolist())):
        one = torch.zeros_like(q)
        one[:b - a] = q[a:b]
        tab, cx = bt[s:s + 1].contiguous(), ctxt[s:s + 1].contiguous()
        ql = (en - st)[s:s + 1].contiguous()
        o_c = pa.paged_prefill_attention(one[None], kp, vp, tab, cx, ql,
                                         **sc, **opts)[0]
        o_1 = pa.ragged_paged_prefill_attention(one, kp, vp, tab, cx,
                                                zero1, ql, **sc, **opts)
        check(torch.equal(o_1, o_c), f"{name}: S=1 != chunk kernel "
              f"(sequence {s})")
        check(torch.equal(o_k[a:b], o_c[:b - a]),
              f"{name}: packed != unpacked (sequence {s})")
    # the fused write: new rows quantized first, their scale rows in the
    # scale pools before the launch
    kn, vn, nsc = inp["kn16"], inp["vn16"], {}
    if kv != "bf16":
        kn, ksr = quantize_kv(inp["kn16"], kv)
        vn, vsr = quantize_kv(inp["vn16"], kv)
        nsc = {n: update_paged_cache_ragged(sc[n].clone(), r[None], *seqs,
                                            seq)
               for n, r in (("k_scale", ksr), ("v_scale", vsr))}
    k1, v1 = kp.clone(), vp.clone()
    o_w, _, _ = pa.ragged_paged_prefill_attention(
        q, k1, v1, *seqs, k_new=kn, v_new=vn, **nsc, **opts)
    k2 = update_paged_cache_ragged(kp.clone(), kn[None], *seqs, seq)
    v2 = update_paged_cache_ragged(vp.clone(), vn[None], *seqs, seq)
    check(same_bytes(k1[1:], k2[1:]) and same_bytes(v1[1:], v2[1:]),
          f"{name}: pool bytes after the fused write != the scatter")
    check(not same_bytes(k1, kp), f"{name}: the fused write wrote nothing")
    check(torch.equal(o_w, pa.ragged_paged_prefill_attention(
        q, k2, v2, *seqs, **nsc, **opts)),
          f"{name}: fused != scatter + kernel")
    e, rel = check_close(f"{name} fused vs plain", o_w[own],
                         ragged_chunk_attention_xla(q, k2, v2, *seqs, seq,
                                                    **nsc, **opts)[own])
    return dict(kp=kp, vp=vp, sc=sc, k1=k1, v1=v1, k2=k2, v2=v2, kn=kn,
                vn=vn, nsc=nsc, e=e, rel=rel, e_n=e_n, rel_n=rel_n)


# the small packed cases of phase 2b at the other head shapes: a 70-row
# chunk ending at 1027 keys, a decode-like row, a chunk across a segment
# edge, a fresh prompt; 19 rows no sequence owns
RAGGED_SMALL = (160, [70, 1, 50, 20], [1027, 65, 257, 20])


def check_ragged(torch, timer, gen, rows):
    """The packed kernel, without and with the fused write (phase 2b)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import (ragged_chunk_attention_xla,
                                              update_paged_cache_ragged)

    T, q_lens, ctx = RAGGED_SMALL
    for H, K, hd in HEAD_SHAPES[1:]:
        for bs in (8, 32):
            inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx)
            for kv in KV_DTYPES:
                ragged_checks(torch, inp, kv, f"ragged H={H} K={K} hd={hd} "
                              f"bs={bs} [{kv}]")
    print(f"[kernels] ragged at heads {HEAD_SHAPES[1:]}, bs 8/32, T={T} "
          f"q_lens={q_lens} ctx={ctx}: S=1 == chunk kernel, packed == "
          "unpacked, fused write == scatter (bit for bit) over "
          f"{'/'.join(KV_DTYPES)}", flush=True)

    H, K, hd, bs, T = 32, 2, 128, 16, 512
    q_lens, ctx = [200, 96, 150, 40], [2048, 96, 700, 1000]
    S = len(q_lens)
    inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx)
    q, seqs, seq = inp["q"], inp["seqs"], inp["seq"]
    bt = seqs[0]
    pairs = sum(n * (c - n) + n * (n + 1) // 2 for n, c in zip(q_lens, ctx))
    flops = 4.0 * pairs * H * hd
    for kv in KV_DTYPES:
        name = f"ragged_paged_prefill_attention[{kv}]"
        r = ragged_checks(torch, inp, kv, name)
        kp, vp, sc, k1, v1, k2, v2 = (r[k] for k in ("kp", "vp", "sc", "k1",
                                                      "v1", "k2", "v2"))
        kn, vn, nsc = r["kn"], r["vn"], r["nsc"]

        def plain_fused():
            update_paged_cache_ragged(k2, kn[None], *seqs, seq)
            update_paged_cache_ragged(v2, vn[None], *seqs, seq)
            return ragged_chunk_attention_xla(q, k2, v2, *seqs, seq, **nsc)

        qb = 2 * q.numel() * 2                      # q read + out written
        rb = kv_row_bytes(kv, K, hd)
        eb = 2 if kv == "bf16" else 1
        meta = bt.numel() * 4 + 3 * S * 4
        b_read = qb + 2 * sum(ctx) * rb + meta
        b_write = (qb + 2 * (sum(ctx) - sum(q_lens)) * K * hd * eb
                   + 2 * sum(ctx) * (rb - K * hd * eb)
                   + 4 * sum(q_lens) * K * hd * eb + meta)
        nw_bound = bound_ms(b_read, flops)
        rows[variant("ragged_paged_prefill_attention", kv)] = dict(
            kernel="ragged_paged_prefill_attention", source=RAGGED_SRC,
            max_abs_err=r["e"], max_row_rel_err=r["rel"],
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        q, k1, v1, *seqs, k_new=kn, v_new=vn, **nsc),
                    plain_fused),
            library_ms=None,
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        q, kp, vp, *seqs, **sc),
                    lambda: ragged_chunk_attention_xla(q, kp, vp, *seqs, seq,
                                                       **sc), "no_write_"),
            no_write_bound_ms=nw_bound[0], no_write_max_abs_err=r["e_n"],
            no_write_max_row_rel_err=r["rel_n"],
            shape=f"T={T} S={S} q_lens={q_lens} ctx={ctx} H={H} K={K} "
                  f"hd={hd} bs={bs}; fused KV write ({pairs} row-key pairs)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_write, flops))))
        print(f"[kernels] {name}: S=1 == chunk kernel, packed == unpacked, "
              "fused write == scatter (bit for bit)", flush=True)


# id counts of the gather's timings: a decode step, a 256-token chunk, a
# training batch (B x S = 2 x 2048)
GATHER_IDS = (8, 256, 4096)


def check_gather(torch, timer, gen, rows):
    """The gather against table[ids], bit for bit: the full glm4 table at
    1, 8, 256 and 4096 ids, ids 0 and V - 1, out-of-range ids (jnp's rule:
    a negative id counts from the end, then the row is clamped into [0,
    V)); 256- and 8-id rows at
    mamba2_370m's and zamba2_2p7b's tables. Times at 8, 256 and 4096 ids
    beside index_select, by events and from the profiler, and the event
    time of a one-element elementwise launch as the floor (phase 2a)."""
    from repro_torch.kernels import embedding as emb

    V, d = 151552, 4096
    table = torch.randn((V, d), generator=gen, device=DEV).bfloat16()
    ids = {n: torch.randint(0, V, (n,), generator=gen, device=DEV,
                            dtype=torch.int32) for n in (1,) + GATHER_IDS}
    edge = torch.tensor([0, V - 1, -1, V, V + 7, -(2 ** 31), 2 ** 31 - 1,
                         -V, -V - 1, V - 1, 0], dtype=torch.int32,
                        device=DEV)
    cases = [(f"{n} ids", i) for n, i in ids.items()] + [
        ("ids (1, 256)", ids[256].reshape(1, 256)),
        ("ids (8, 1)", ids[8].reshape(8, 1)),
        ("ids 0, V - 1 and out of range", edge)]
    for name, i in cases:
        # jnp's rule: a negative id counts from the end, then clamped
        want = table[torch.where(i < 0, i + V, i).clamp(0, V - 1).long()]
        check(torch.equal(emb.gather(table, i), want),
              f"gather != table[ids] at glm4 ({V}x{d}), {name}")
    # the same two id shapes at the SSM and hybrid models' tables
    from repro_torch.config import get_config
    for arch in ("mamba2_370m", "zamba2_2p7b"):
        c = get_config(arch)
        Va, da = c.padded_vocab_size, c.d_model
        t = torch.randn((Va, da), generator=gen, device=DEV).bfloat16()
        for shape in ((1, 256), (8, 1)):
            i = torch.randint(0, Va, shape, generator=gen, device=DEV,
                              dtype=torch.int32)
            check(torch.equal(emb.gather(t, i), emb.gather_plain(t, i)),
                  f"gather != table[ids] at {arch} ({Va}x{da}), ids {shape}")
        del t
    print("[kernels] gather == table[ids] (bit for bit) at glm4_9b (1, 8, "
          "256, 4096 ids, 0, V - 1 and out-of-range ids), mamba2_370m and "
          "zamba2_2p7b widths", flush=True)
    one = torch.zeros(1, device=DEV)
    times = {"floor_ms": timer(lambda: one.add_(1.0))}
    for n in GATHER_IDS:
        i = ids[n]
        times[f"ms_{n}"] = timer(lambda: emb.gather(table, i))
        times[f"library_ms_{n}"] = timer(lambda: torch.index_select(
            table, 0, i))
        times[f"device_ms_{n}"] = timer.device(lambda: emb.gather(table, i))
        times[f"library_device_ms_{n}"] = timer.device(
            lambda: torch.index_select(table, 0, i))
    print("[kernels] gather times (ms): " + ", ".join(
        f"{k} {fmt(v, '.4f')}" for k, v in times.items()), flush=True)
    i256 = ids[256]
    rows["gather"] = dict(
        kernel="gather", source="src/repro_torch/csrc/embedding.cu",
        max_abs_err=0.0, max_row_rel_err=0.0, ms=times["ms_256"],
        plain_ms=timer(lambda: emb.gather_plain(table, i256)),
        library_ms=times["library_ms_256"],
        shape=f"table {V}x{d} bf16, 256 ids; times at 8 and 4096 ids, "
              "profiler device times and the one-element launch floor in "
              "the other keys",
        **{k: v for k, v in times.items()
           if k not in ("ms_256", "library_ms_256")},
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(2 * 256 * d * 2 + 256 * 4, 0.0))))


def ssd_inputs(torch, gen, b, S, nh, hp, G, N):
    """Inputs drawn as tests/test_kernels.py's SSD cases draw them: x, B,
    C ~ N(0, 1) in bf16, dt ~ U(0.001, 0.1), A ~ -U(0.5, 4), h0 ~ N(0,
    0.5^2) fp32."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEV)

    def bf(*shape):
        return torch.randn(shape, generator=gen, device=DEV).bfloat16()

    return (bf(b, S, nh, hp), u((b, S, nh), 0.001, 0.1), -u((nh,), 0.5, 4.0),
            bf(b, S, G, N), bf(b, S, G, N),
            0.5 * torch.randn((b, nh, hp, N), generator=gen, device=DEV))


def ssd_bound(b, S, nh, hp, G, N, Q):
    """Each input read once, each output written once; the operations of
    the causal chunked scan (C.B and scores.xdt over the row pairs j <= i
    of each chunk, the state read-out and update), at the bf16 rate."""
    nbytes = (2 * b * S * nh * hp * 2 + b * S * nh * 4 + nh * 4
              + 2 * b * S * G * N * 2 + 2 * b * nh * hp * N * 4)
    nc = S // Q
    flops = b * nh * nc * (Q * (Q + 1) * (N + hp) + 4 * Q * N * hp)
    return bound_ms(nbytes, flops), flops


def check_ssd_close(name, y_k, h_k, y_p, h_p) -> tuple[float, float, float]:
    """y: every (row, head) within TOL relative to its norm; h_last within
    SSD_H_TOL of max(1, |plain|). Returns (y abs err, y row rel err,
    h abs err)."""
    ey, ry = err(y_k, y_p), row_err(y_k, y_p)
    eh = err(h_k, h_p)
    scaled = float(((h_k - h_p).abs() / h_p.abs().clamp(min=1.0)).max())
    check(ry <= TOL and scaled <= SSD_H_TOL,
          f"{name}: y max row relative err {ry} (limit {TOL}), h_last max "
          f"err {eh} ({scaled} scaled to max(1, |plain|); limit "
          f"{SSD_H_TOL})")
    return ey, ry, eh


def check_ssd(torch, timer, gen, rows):
    """The SSD scan kernel against ssd_chunked at both models' widths,
    and its two bitwise invariants (phase 2c)."""
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.models.ssm import ssd_chunked

    Q = 256
    widths = {"mamba2_370m": (32, 64, 1, 128), "zamba2_2p7b": (80, 64, 1, 64)}
    for arch, (nh, hp, G, N) in widths.items():
        for b, S in ((1, Q), (2, 2 * Q)):
            x, dt, A, B, C, h0 = ssd_inputs(torch, gen, b, S, nh, hp, G, N)
            y_k, h_k = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
            y_p, h_p = ssd_chunked(x, dt, A, B, C, Q, h0=h0)
            e = check_ssd_close(f"ssd {arch} b={b} S={S}", y_k, h_k, y_p, h_p)
            if arch == "mamba2_370m" and b == 1:
                main = (x, dt, A, B, C, h0, e)
    # the smoke widths and a grouped case (G = 2), without h0
    for (b, S, nh, hp, G, N, q) in ((2, 16, 4, 16, 1, 16, 8),
                                    (2, 96, 4, 32, 2, 16, 16)):
        x, dt, A, B, C, _ = ssd_inputs(torch, gen, b, S, nh, hp, G, N)
        check_ssd_close(f"ssd b={b} S={S} nh={nh} hp={hp} G={G} N={N} Q={q}",
                        *ssd_k.ssd(x, dt, A, B, C, chunk=q),
                        *ssd_chunked(x, dt, A, B, C, q))

    # (a) one launch over 2Q rows == two launches of Q, h0 carried
    nh, hp, G, N = widths["mamba2_370m"]
    x, dt, A, B, C, h0 = ssd_inputs(torch, gen, 1, 2 * Q, nh, hp, G, N)
    y2, h2 = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
    halves = [t[:, :Q].contiguous() for t in (x, dt, B, C)]
    ya, ha = ssd_k.ssd(halves[0], halves[1], A, halves[2], halves[3],
                       chunk=Q, h0=h0)
    rest = [t[:, Q:].contiguous() for t in (x, dt, B, C)]
    yb, hb = ssd_k.ssd(rest[0], rest[1], A, rest[2], rest[3], chunk=Q, h0=ha)
    check(torch.equal(y2, torch.cat([ya, yb], dim=1)) and torch.equal(h2, hb),
          "ssd: one launch over 2Q rows != two launches of Q, bit for bit")
    # ... and under CUDA-graph replay, where the capture turns the scan's
    # programmatic dependent launch into a graph edge
    (y2r, h2r), g_one = graph_replay(torch, lambda: ssd_k.ssd(
        x, dt, A, B, C, chunk=Q, h0=h0))

    def two_launches():
        ya, ha = ssd_k.ssd(*halves[:2], A, *halves[2:], chunk=Q, h0=h0)
        yb, hb = ssd_k.ssd(*rest[:2], A, *rest[2:], chunk=Q, h0=ha)
        return torch.cat([ya, yb], dim=1), hb

    (yabr, hbr), _ = graph_replay(torch, two_launches)
    check(torch.equal(y2r, y2) and torch.equal(h2r, h2)
          and torch.equal(yabr, y2) and torch.equal(hbr, h2),
          "ssd under graph replay: 2Q in one launch, two launches of Q and "
          "the eager launches differ, bit for bit")
    edges = graph_edge_types(g_one)
    # (b) rows with dt = 0 past row n: whatever they hold, h_last and the
    # first n rows' y are unchanged; a whole chunk of them is the identity
    n = 100
    x, dt, A, B, C, h0 = ssd_inputs(torch, gen, 1, Q, nh, hp, G, N)
    dt[:, n:] = 0.0
    y1, h1 = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
    x2, _, _, B2, C2, _ = ssd_inputs(torch, gen, 1, Q, nh, hp, G, N)
    for t, t2 in ((x, x2), (B, B2), (C, C2)):
        t2[:, :n] = t[:, :n]
    y2, h2 = ssd_k.ssd(x2, dt, A, B2, C2, chunk=Q, h0=h0)
    check(torch.equal(h1, h2) and torch.equal(y1[:, :n], y2[:, :n]),
          "ssd: dt = 0 rows changed h_last or earlier rows' y")
    (y1r, h1r), _ = graph_replay(torch, lambda: ssd_k.ssd(
        x, dt, A, B, C, chunk=Q, h0=h0))
    (y2r, h2r), _ = graph_replay(torch, lambda: ssd_k.ssd(
        x2, dt, A, B2, C2, chunk=Q, h0=h0))
    check(torch.equal(y1r, y1) and torch.equal(h1r, h1)
          and torch.equal(h2r, h1) and torch.equal(y2r[:, :n], y1[:, :n]),
          "ssd under graph replay: dt = 0 rows changed h_last or earlier "
          "rows' y, or the replay differs from the eager launch")
    zero_chunk = [torch.cat([t, t2], dim=1) for t, t2 in ((x, x2), (B, B2),
                                                           (C, C2))]
    dt_z = torch.cat([dt, torch.zeros_like(dt)], dim=1)
    y3, h3 = ssd_k.ssd(zero_chunk[0], dt_z, A, zero_chunk[1], zero_chunk[2],
                       chunk=Q, h0=h0)
    check(torch.equal(h3, h1) and torch.equal(y3[:, :Q], y1),
          "ssd: a chunk of dt = 0 rows is not the identity on the state")
    print("[kernels] ssd: 2Q in one launch == two launches of Q, dt = 0 "
          "rows leave h_last and earlier y unchanged (bit for bit), eager "
          "and under CUDA-graph replay (== eager); the one-launch graph's "
          f"edges by type (0 full, 1 programmatic): {edges}", flush=True)

    x, dt, A, B, C, h0, (ey, ry, eh) = main
    b, S = x.shape[:2]
    (bnd, by), flops = ssd_bound(b, S, nh, hp, G, N, Q)
    zb = widths["zamba2_2p7b"]
    xz, dtz, Az, Bz, Cz, h0z = ssd_inputs(torch, gen, 1, Q, *zb)

    def kernel():
        return ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)

    def kernel_z():
        return ssd_k.ssd(xz, dtz, Az, Bz, Cz, chunk=Q, h0=h0z)

    rows["ssd"] = dict(
        kernel="ssd", source=SSD_SRC, max_abs_err=ey, max_row_rel_err=ry,
        h_last_max_abs_err=eh, library_ms=None, bound_ms=bnd, bound_by=by,
        fp32_cuda_core_ms=flops / 67e12 * 1e3,
        **timed(timer, kernel, lambda: ssd_chunked(x, dt, A, B, C, Q, h0=h0)),
        **timed(timer, kernel_z,
                lambda: ssd_chunked(xz, dtz, Az, Bz, Cz, Q, h0=h0z),
                prefix="zamba2_"),
        span_ms=timer.span(kernel), zamba2_span_ms=timer.span(kernel_z),
        device_ms_by_kernel=timer.kernels(kernel),
        zamba2_bound_ms=ssd_bound(1, Q, *zb, Q)[0][0],
        shape=f"b={b} S={S} nh={nh} hp={hp} G={G} N={N} Q={Q} "
              f"({flops / 1e9:.3f} GFLOP); zamba2 nh={zb[0]} N={zb[3]}")


def graph_replay(torch, fn):
    """``fn``'s outputs from a CUDA graph of it: one eager warm-up call on
    a side stream, the capture (kept for ``graph_edge_types``), one
    replay. Returns (outputs, graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = fn()
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    return out, g


def causal_pairs(Sq, Skv, causal, window, q_offset) -> int:
    """(query row, key) pairs the mask lets through."""
    if not causal:
        return Sq * Skv
    n = 0
    for i in range(Sq):
        hi = min(Skv, q_offset + i + 1)
        lo = 0 if window is None else max(0, q_offset + i - window + 1)
        n += max(0, hi - lo)
    return n


# name, B, Sq, Skv, H, K, hd, causal, window, cap, q_offset: glm4_9b's
# attention at chip_smoke's training shape (B=2, S=2048) and its variants
FLASH_CASES = [
    ("glm4 causal", 2, 2048, 2048, 32, 2, 128, True, None, None, 0),
    ("glm4 window 512 cap 50", 2, 2048, 2048, 32, 2, 128, True, 512, 50.0, 0),
    ("glm4 Sq 256 at q_offset 1792", 2, 256, 2048, 32, 2, 128, True, None,
     None, 1792),
    ("glm4 non-causal Sq 200", 2, 200, 2048, 32, 2, 128, False, None, None,
     0),
    ("hd 16 window 64 cap 30", 2, 300, 300, 4, 2, 16, True, 64, 30.0, 0),
    # the edges of the hd-128 route's 128-row and 128-key tiles
    ("Sq 129 causal", 2, 129, 129, 32, 2, 128, True, None, None, 0),
    ("Sq 255 causal", 2, 255, 255, 32, 2, 128, True, None, None, 0),
    ("Skv 130 non-causal", 2, 96, 130, 32, 2, 128, False, None, None, 0),
    ("Sq 148 at q_offset 1900", 2, 148, 2048, 32, 2, 128, True, None, None,
     1900),
    ("window 100 cap 50", 2, 600, 600, 32, 2, 128, True, 100, 50.0, 0)]
# glm4_9b's head (V, d), the sampled ids n and the rows T of phase 2e
SAMPLED_SHAPE = (151552, 4096, 8192, 4096)


def check_flash(torch, timer, gen, rows):
    """The flash forward kernel against dense_attention (o) and the plain
    logsumexp (lse); FlashAttention's gradients against autograd through
    dense_attention; two launches give the same bits (phase 2d)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import dense_attention

    for (name, B, Sq, Skv, H, K, hd, causal, window, cap, off) in FLASH_CASES:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        opts = dict(causal=causal, window=window, cap=cap, q_offset=off)
        o_k, lse_k = fa.flash_attention(q, k, v, **opts)
        o_2, lse_2 = fa.flash_attention(q, k, v, **opts)
        check(same_bytes(o_k, o_2) and same_bytes(lse_k, lse_2),
              f"flash {name}: two launches differ")
        e, rel = check_close(f"flash {name} vs dense_attention", o_k,
                             dense_attention(q, k, v, **opts))
        o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, **opts)
        e_lse = err(lse_k, lse_p)
        check(e_lse <= LSE_TOL, f"flash {name}: lse max abs err {e_lse} "
              f"(limit {LSE_TOL})")
        # gradients: the kernel forward + plain backward against autograd
        # through dense_attention (bf16 probabilities), each within TOL of
        # that gradient's largest magnitude
        do = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        grads = []
        for attend in (lambda *a: fa.FlashAttention.apply(
                           *a, causal, window, cap, None, off),
                       lambda *a: dense_attention(*a, **opts)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            attend(*leaves).backward(do)
            grads.append([t.grad for t in leaves])
            del leaves
        g_err = []
        for gname, a, b in zip("qkv", *grads):
            big = float(b.float().abs().max())
            g_err.append(err(a, b) / big)
            check(g_err[-1] <= TOL, f"flash {name}: d{gname} max abs err "
                  f"{err(a, b)} (limit {TOL} x max |d{gname}| {big})")
        del grads
        print(f"[kernels] flash {name} (route {fa.route(hd)}): o max row "
              f"rel err {rel:.3g}, lse max abs err {e_lse:.3g}, dq/dk/dv "
              f"err / max {g_err}, two launches bit-equal", flush=True)
        if hd == 16:
            mma_ms = timer(lambda: fa.flash_attention(q, k, v, **opts))
            mma_shape = f"{name}: B={B} Sq={Sq} Skv={Skv} H={H} K={K}"
            print(f"[kernels] flash route mma (hd 16) at {mma_shape}: "
                  f"{mma_ms:.4f} ms", flush=True)
        if name != "glm4 causal":
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = causal_pairs(Sq, Skv, causal, window, off)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * lse_k.numel()
        bwd_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o_b = fa.FlashAttention.apply(*bwd_leaves, causal, window, cap, None,
                                      off)
        flops = 4.0 * B * H * hd * pairs

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        ms = timer(lambda: fa.flash_attention(q, k, v, **opts))
        main = dict(
            kernel="flash_attention", source=FLASH_SRC, max_abs_err=e,
            max_row_rel_err=rel, lse_max_abs_err=e_lse,
            grad_err_over_max=g_err, kernel_route=fa.route(hd), ms=ms,
            tflops=flops / ms * 1e-9,
            device_ms=timer.device(lambda: fa.flash_attention(q, k, v,
                                                              **opts)),
            plain_ms=timer(lambda: ref.flash_attention_fwd_plain(
                q, k, v, **opts)),
            library_ms=timer(sdpa), library_device_ms=timer.device(sdpa),
            bwd_plain_ms=timer(lambda: torch.autograd.grad(
                o_b, bwd_leaves, do, retain_graph=True), iters=5),
            shape=f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} causal "
                  f"({pairs} row-key pairs per batch row, "
                  f"{flops / 1e9:.1f} GFLOP)",
            **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, flops))))
        del bwd_leaves, o_b
    main.update(mma_route_ms=mma_ms, mma_route_shape=mma_shape,
                scaling=flash_scaling(torch, timer, gen))
    rows["flash_attention"] = main


# B, Sq, Skv, causal at glm4's heads (H=32, K=2, hd 128): one key tile per
# block and sixteen (the per-block cost and the per-tile cost), and a long
# causal sequence
FLASH_SCALING = [(2, 2048, 128, False), (2, 2048, 2048, False),
                 (1, 8192, 8192, True)]


def flash_scaling(torch, timer, gen) -> list:
    """The hd-128 route beside scaled_dot_product_attention at other
    shapes: event and profiler times, TFLOP/s, and the profiler time per
    block slot (x 132 SMs / blocks), which says what one 128-row block
    costs at each key count."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    out = []
    for B, Sq, Skv, causal in FLASH_SCALING:
        H, K, hd = 32, 2, 128
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops = 4.0 * B * H * hd * causal_pairs(Sq, Skv, causal, None, 0)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        r = dict(B=B, Sq=Sq, Skv=Skv, causal=causal, ms=timer(kernel),
                 device_ms=timer.device(kernel), library_ms=timer(sdpa),
                 library_device_ms=timer.device(sdpa))
        r["tflops"] = flops / r["ms"] * 1e-9
        r["library_tflops"] = flops / r["library_ms"] * 1e-9
        r["us_per_block_slot"] = None if r["device_ms"] is None else (
            1e3 * r["device_ms"] * 132 / (B * H * -(-Sq // 128)))
        print(f"[kernels] flash wgmma B={B} Sq={Sq} Skv={Skv} causal="
              f"{causal}: {r['ms']:.4f} ms ({r['tflops']:.0f} TFLOP/s), "
              f"device {fmt(r['device_ms'], '.4f')} ms, "
              f"{fmt(r['us_per_block_slot'], '.2f')} "
              f"us per block slot; SDPA {r['library_ms']:.4f} ms "
              f"({r['library_tflops']:.0f} TFLOP/s)", flush=True)
        out.append(r)
    return out


def sampled_inputs(torch, gen, V, d, n, T):
    """A (V, d) bf16 table scaled by d^-0.5, n distinct sampled ids, x
    (T, d) bf16 and labels (T,), the first 8 labels set to sampled ids
    (accidental hits)."""
    table = (torch.randn((V, d), generator=gen, device=DEV)
             * d ** -0.5).bfloat16()
    sids = torch.randperm(V, generator=gen, device=DEV)[:n].to(torch.int32)
    x = torch.randn((T, d), generator=gen, device=DEV).bfloat16()
    labels = torch.randint(0, V, (T,), generator=gen, device=DEV,
                           dtype=torch.int32)
    labels[:8] = sids[:8]
    return table, sids, x, labels


def check_sampled_case(torch, name, x, table, labels, sids, cap):
    """One phase 2e case: kernel within SAMPLED_TOL relative of the plain
    loss, two launches bit-equal. Returns (abs err, relative err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sampled_softmax as ss
    l_k = ss.sampled_softmax_loss(x, table, labels, sids, cap=cap)
    l_2 = ss.sampled_softmax_loss(x, table, labels, sids, cap=cap)
    check(same_bytes(l_k.reshape(1), l_2.reshape(1)),
          f"{name}: two launches differ")
    l_p = ref.sampled_softmax_loss_ref(x, table, labels, sids, cap=cap)
    e = abs(float(l_k) - float(l_p))
    rel = e / abs(float(l_p))
    check(rel <= SAMPLED_TOL, f"{name}: kernel {float(l_k)} plain "
          f"{float(l_p)}, relative err {rel} (limit {SAMPLED_TOL})")
    print(f"[kernels] {name}: loss {float(l_k):.6f} plain {float(l_p):.6f} "
          f"rel err {rel:.3g}, two launches bit-equal", flush=True)
    return e, rel


# phase 2e's cases besides the main shape's four: the edges of the GEMM
# launch's 128-row and 256-column tiles at glm4's head (the main table,
# the first n sampled ids, the first T rows), and zamba2_2p7b's head
# (32000 x 2560: 40 steps of 64 over d); name, n, T, cap, (V, d) or None
SAMPLED_EDGES = [("n not a multiple of 256", 8000, 4096, None, None),
                 ("n below one column tile", 64, 4096, 30.0, None),
                 ("T below one row tile", 8192, 100, None, None),
                 ("zamba2's head, d=2560", 8192, 4096, 30.0, (32000, 2560))]


def check_sampled_softmax(torch, timer, gen, rows):
    """The sampled-softmax kernel against its plain version at glm4's
    head (151552 x 4096 bf16), n = 8192 sampled ids, T = 4096 and 4095,
    no cap and cap 30, then SAMPLED_EDGES, accidental hits planted
    (phase 2e); its per-launch device times and cuBLAS's bf16 product of
    the same shape (gemm_ms, a yardstick the port never calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sampled_softmax as ss

    V, d, n, T0 = SAMPLED_SHAPE
    table, sids, x_all, lab_all = sampled_inputs(torch, gen, V, d, n, T0)
    for T in (T0, T0 - 1):
        for cap in (None, 30.0):
            e, rel = check_sampled_case(
                torch, f"sampled_softmax_loss T={T} cap={cap}", x_all[:T],
                table, lab_all[:T], sids, cap)
            if T == T0 and cap is None:
                main = (e, rel)
    for name, n_e, T, cap, head in SAMPLED_EDGES:
        if head is None:
            args = (x_all[:T], table, lab_all[:T], sids[:n_e])
        else:
            t_e, s_e, x_e, l_e = sampled_inputs(torch, gen, *head, n_e, T)
            args = (x_e, t_e, l_e, s_e)
        check_sampled_case(torch, f"sampled_softmax_loss {name}: "
                           f"T={T} n={n_e} cap={cap}", *args, cap)
    e, rel = main
    x, labels, T = x_all, lab_all, T0
    nbytes = 2 * (T * d + T * d + n * d) + 4 * (T + n) + 4
    flops = 2.0 * T * n * d

    def kernel():
        return ss.sampled_softmax_loss(x, table, labels, sids)

    w_samp = table[sids.long()]
    by_kernel = timer.kernels(kernel)
    gemm = [v for k, v in (by_kernel or {}).items()
            if "sampled_lse_kernel" in k]
    check(by_kernel is None or len(gemm) == 1, "sampled_softmax_loss: no "
          f"single GEMM launch in the profile: {sorted(by_kernel or {})}")
    rows["sampled_softmax_loss"] = dict(
        kernel="sampled_softmax_loss", source=SAMPLED_SRC, max_abs_err=e,
        max_row_rel_err=rel, library_ms=None,
        **timed(timer, kernel,
                lambda: ref.sampled_softmax_loss_ref(x, table, labels, sids)),
        device_ms_by_kernel=by_kernel,
        tflops=per_ms(flops, gemm[0] if gemm else None),
        gemm_ms=timer(lambda: torch.mm(x, w_samp.t())),
        gemm_device_ms=timer.device(lambda: torch.mm(x, w_samp.t())),
        shape=f"T={T} d={d} n={n}, table {V}x{d} bf16 (gathers included; "
              "loss relative error in max_row_rel_err; tflops: the GEMM "
              "launch alone)",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(nbytes, flops + 2.0 * T * d))))
    r = rows["sampled_softmax_loss"]
    print(f"[kernels] sampled_softmax_loss device ms by kernel: "
          f"{json.dumps(by_kernel)}; GEMM launch {fmt(r['tflops'], '.1f')} "
          f"TFLOP/s; torch.mm of the same shape (cuBLAS, yardstick): events "
          f"{r['gemm_ms']:.5f} ms, device {fmt(r['gemm_device_ms'])} ms",
          flush=True)


# the kernels of the family's serving path (bf16 pools, the flash kernel's
# hd-128 route), whose rows carry each member's numbers
FAMILY_KERNELS = ("paged_attention", "paged_prefill_attention",
                  "ragged_paged_prefill_attention", "flash_attention",
                  "gather")
# phase 2f: the paged, flash and gather kernels at the heads and tables of
# the rest of the dense family (hd 128): name -> (arch, H, K, the layer
# options of its windowed layers). gemma2_27b's local layers: a 4096-key
# window, attention softcap 50, scale 144^-0.5 (its global layers drop
# the window); qwen3_32b and starcoder2_3b: causal, hd^-0.5
FAMILY = {"gemma2": ("gemma2_27b", 32, 16,
                     dict(window=4096, cap=50.0, scale=144 ** -0.5)),
          "qwen3": ("qwen3_32b", 64, 8, {}),
          "starcoder2": ("starcoder2_3b", 24, 2, {})}
# decode contexts (8 sequences, one inactive) and the chunk's end: past
# gemma2's window, glm4's lengths for the others (MEMBER_CTX: phase 2g's)
GLM4_CTX = ([2048, 1536, 1024, 777, 2000, 1, 0, 300], 2048)
# gemma2's past its window; whisper's (phase 12c: 128-token prompts, 32
# new) and a chunk across its 256-key segment edge
MEMBER_CTX = {"gemma2": ([6144, 6000, 4097, 4095, 5000, 1, 0, 300], 6144),
              "whisper": ([160, 150, 140, 129, 257, 1, 0, 65], 300)}
# packed: phase 2b's q_lens at these contexts (gemma2's first past the
# window)
GLM4_PACKED = [2048, 96, 700, 1000]
MEMBER_PACKED = {"gemma2": [6144, 96, 4700, 5000]}
# flash: (B, S) per family member, the member's layer options. The first
# is the row's timed shape (gemma2 at a long prompt past its window, the
# others causal at 2048); the rest are the shapes phase 10's static path
# gives the kernel: its 8 x 512 prompts, and gemma2's two 6000-token
# prompts (a partial last 128-row tile)
FAMILY_FLASH = {"gemma2": [(1, 6144), (8, 512), (2, 6000)],
                "qwen3": [(1, 2048), (8, 512)],
                "starcoder2": [(1, 2048), (8, 512)],
                "qwen3_moe": [(1, 2048), (8, 512)],
                "qwen2_vl": [(1, 2048), (8, 512)]}


def visible_keys(pos: int, window) -> int:
    """Keys a query at absolute position ``pos`` sees."""
    return pos + 1 if window is None else min(pos + 1, window)


def family_row(rows, kernel, prefix, **kw) -> None:
    """A family member's numbers as ``prefix``-ed keys of a kernel's
    row."""
    rows[kernel].update({prefix + k: v for k, v in kw.items()})


def check_flash_o(name, o_k, q, k, v, fo, ref, dense_attention,
                  dense=True):
    """The flash kernel's o at the family and per-route shapes: within TOL
    of its plain version (``ref.flash_attention_fwd_plain``: fp32
    throughout, one rounding), row by row and value by value
    (``check_close``), and, with ``dense``, every row within TOL relative
    of ``dense_attention``. The value cap is not held against
    ``dense_attention``: it rounds p to bf16 after normalizing and the
    kernel before, so one value of each can sit a bf16 ulp on either side
    of the exact one, two ulps apart, past the cap between 1 and 1.56 in
    magnitude. Returns (max abs err, max row relative err) against the
    plain version."""
    e, rel = check_close(f"{name} vs the plain version", o_k,
                         ref.flash_attention_fwd_plain(q, k, v, **fo)[0])
    if dense:
        r_dense = row_err(o_k, dense_attention(q, k, v, **fo))
        check(r_dense <= TOL, f"{name} vs dense_attention: max row "
              f"relative err {r_dense} (limit {TOL})")
    return e, rel


def check_family_flash(torch, timer, gen, arch, H, K, hd, variants, B, S,
                       F, fa, ref, dense_attention) -> dict:
    """The flash forward at one family shape, for each of the member's
    layer options (``variants``; the first is timed): two launches
    bit-equal, o held by ``check_flash_o``, lse within LSE_TOL of the
    plain one; the first's times (SDPA's where SDPA computes the same
    function) and bound."""
    q = torch.randn((B, S, H, hd), generator=gen, device=DEV).bfloat16()
    k = torch.randn((B, S, K, hd), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, S, K, hd), generator=gen, device=DEV).bfloat16()
    for o in reversed(variants):
        fo = dict(causal=True, **o)
        o_k, lse_k = fa.flash_attention(q, k, v, **fo)
        o_2, lse_2 = fa.flash_attention(q, k, v, **fo)
        check(same_bytes(o_k, o_2) and same_bytes(lse_k, lse_2),
              f"flash {arch} B={B} S={S} {o}: two launches differ")
        del o_2, lse_2
        e, rel = check_flash_o(f"flash {arch} B={B} S={S} {o}", o_k, q, k,
                               v, fo, ref, dense_attention)
        e_lse = err(lse_k, ref.flash_attention_fwd_plain(q, k, v, **fo)[1])
        check(e_lse <= LSE_TOL, f"flash {arch} B={B} S={S} {o}: lse max abs "
              f"err {e_lse} (limit {LSE_TOL})")
    opts = variants[0]
    pairs = causal_pairs(S, S, True, opts.get("window"), 0)
    flops = 4.0 * B * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse_k.numel()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    ms = timer(lambda: fa.flash_attention(q, k, v, **fo))
    if opts:
        # SDPA has no softcap: no library call computes gemma2's function;
        # SDPA's causal time on the same tensors is a yardstick only
        lib = dict(library_ms=None, sdpa_causal_no_cap_ms=timer(sdpa))
    else:
        lib = dict(library_ms=timer(sdpa), library_device_ms=timer.device(sdpa))
    return dict(
        max_abs_err=e, max_row_rel_err=rel, lse_max_abs_err=e_lse, ms=ms,
        tflops=flops / ms * 1e-9,
        device_ms=timer.device(lambda: fa.flash_attention(q, k, v, **fo)),
        plain_ms=timer(lambda: ref.flash_attention_fwd_plain(q, k, v, **fo),
                       iters=5),
        shape=f"{arch}: B={B} S={S} H={H} K={K} hd={hd} causal {opts} "
              f"({pairs} row-key pairs per batch row)",
        **lib, **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, flops))))


def check_member(torch, timer, gen, rows, name, arch, H, K, opts, parts):
    """One member's kernels at its heads (hd from its config), bf16
    pools, its windowed layers' options (and gemma2's global layers
    without the window): decode ("d") and a 256-row chunk ("c") within TOL
    of the plain versions, decode == chunk(C=1) bit for bit, padding rows
    zero; the packed kernel ("p": packed S=1 == chunk, packed == unpacked,
    fused write == scatter, bit for bit); the flash forward ("f") vs
    dense_attention (its lse vs the plain one) at the member's shapes,
    beside SDPA where SDPA computes the same function; the gather ("g")
    == table[ids] at the member's embedding table. Times, bounds and
    errors go into each kernel's row under the member's prefix."""
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.kernels import embedding as emb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import (dense_attention,
                                              paged_chunk_attention_xla,
                                              ragged_chunk_attention_xla)

    c = get_config(arch)
    hd, bs, p = c.head_dim, 16, name + "_"
    window = opts.get("window")
    # gemma2's global layers: cap and scale, no window (checked only)
    variants = [opts] + ([{k: v for k, v in opts.items()
                           if k != "window"}] if window else [])
    ctx, c_end = MEMBER_CTX.get(name, GLM4_CTX)
    if "d" in parts:
        B, nb = len(ctx), -(-max(ctx) // bs)
        q, kp, vp, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb,
                                         ctx)
        ones = torch.ones(B, dtype=torch.int32, device=DEV)
        for o in variants:
            o_k = pa.paged_attention(q, kp, vp, bt, ctxt, **o)
            check_close(f"paged_attention {name} {o} vs plain", o_k,
                        ref.paged_attention_ref(q, kp, vp, bt, ctxt, **o))
            check(bool((o_k[ctx.index(0)] == 0).all()),
                  f"paged_attention {name}: ctx=0 row not zero")
            o_c = pa.paged_prefill_attention(q[:, None].contiguous(), kp, vp,
                                             bt, ctxt, ones, **o)
            check(torch.equal(o_c[:, 0], o_k),
                  f"{name} {o}: chunk(C=1) != decode bitwise")
        keys = sum(visible_keys(x - 1, window) for x in ctx if x)
        b_dec = (2 * q.numel() * 2 + 2 * keys * kv_row_bytes("bf16", K, hd)
                 + bt.numel() * 4 + B * 4)
        e, rel = check_close(f"paged_attention {name} vs plain",
                             pa.paged_attention(q, kp, vp, bt, ctxt, **opts),
                             ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                     **opts))
        family_row(
            rows, "paged_attention", p, max_abs_err=e, max_row_rel_err=rel,
            shape=f"{arch}: B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx} "
                  f"{opts}",
            **timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt,
                                                      **opts),
                    lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                    **opts)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_dec, 4.0 * keys * H * hd))))

    if "c" in parts:
        # a 256-row chunk, 200 rows valid, ending at c_end
        C, qlen = 256, 200
        nb = -(-c_end // bs)
        q, kp, vp, bt, ctxt = paged_case(torch, gen, 1, H, K, hd, bs, nb,
                                         [c_end], C=C)
        ql = torch.tensor([qlen], dtype=torch.int32, device=DEV)
        for o in variants:
            o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **o)
            check_close(f"paged_prefill_attention {name} {o} vs plain",
                        o_k[:, :qlen], paged_chunk_attention_xla(
                            q, kp, vp, bt, ctxt, ql, **o)[:, :qlen])
            check(bool((o_k[:, qlen:] == 0).all()),
                  f"{name}: chunk padding rows not zero")
        pos0 = c_end - qlen
        pairs = sum(visible_keys(pos0 + i, window) for i in range(qlen))
        span = c_end - (0 if window is None else max(0, pos0 - window + 1))
        b_chk = (2 * q.numel() * 2 + 2 * span * kv_row_bytes("bf16", K, hd)
                 + bt.numel() * 4 + 8)
        e, rel = check_close(
            f"paged_prefill_attention {name} vs plain",
            pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql,
                                       **opts)[:, :qlen],
            paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                      **opts)[:, :qlen])
        family_row(
            rows, "paged_prefill_attention", p, max_abs_err=e,
            max_row_rel_err=rel,
            shape=f"{arch}: B=1 C={C} q_len={qlen} ctx={c_end} H={H} K={K} "
                  f"hd={hd} {opts}",
            **timed(timer, lambda: pa.paged_prefill_attention(
                        q, kp, vp, bt, ctxt, ql, **opts),
                    lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                                      **opts)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_chk, 4.0 * pairs * H * hd))))

    if "p" in parts:
        # packed: T = 512 rows of 4 sequences, with the fused KV write
        T, q_lens = 512, [200, 96, 150, 40]
        pctx = MEMBER_PACKED.get(name, GLM4_PACKED)
        inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, pctx)
        r = [ragged_checks(torch, inp, "bf16", f"ragged {name} {o}", o)
             for o in variants][0]
        qr, seqs, seq = inp["q"], inp["seqs"], inp["seq"]
        k1, v1, k2, v2, kn, vn = (r[k] for k in ("k1", "v1", "k2", "v2",
                                                  "kn", "vn"))

        def plain_fused():
            from repro_torch.models.attention import update_paged_cache_ragged
            update_paged_cache_ragged(k2, kn[None], *seqs, seq)
            update_paged_cache_ragged(v2, vn[None], *seqs, seq)
            return ragged_chunk_attention_xla(qr, k2, v2, *seqs, seq, **opts)

        pairs = sum(visible_keys(x - n + i, window)
                    for n, x in zip(q_lens, pctx) for i in range(n))
        span = sum(x - (0 if window is None else max(0, x - n - window + 1))
                   for n, x in zip(q_lens, pctx))
        qb, rb, meta = 2 * qr.numel() * 2, kv_row_bytes("bf16", K, hd), \
            seqs[0].numel() * 4 + 3 * len(q_lens) * 4
        b_write = qb + 2 * span * rb + 2 * sum(q_lens) * rb + meta
        family_row(
            rows, "ragged_paged_prefill_attention", p, max_abs_err=r["e"],
            max_row_rel_err=r["rel"],
            shape=f"{arch}: T={T} S={len(q_lens)} q_lens={q_lens} "
                  f"ctx={pctx} H={H} K={K} hd={hd} {opts}; fused KV write",
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        qr, k1, v1, *seqs, k_new=kn, v_new=vn, **opts),
                    plain_fused),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_write, 4.0 * pairs * H * hd))))
        del inp, r, k1, v1, k2, v2
    if parts & set("dcp"):
        bits = (["decode == chunk(C=1)"] if "d" in parts else []) + (
            ["packed S=1 == chunk, packed == unpacked, fused write == "
             "scatter"] if "p" in parts else [])
        print(f"[kernels] {name} (H={H} K={K} G={H // K} hd={hd}, "
              f"{opts or 'causal'}): {', '.join(bits)} (bit for bit); "
              f"within {TOL} of plain", flush=True)

    # the flash forward at the member's shapes
    for case, (Bf, S) in enumerate(FAMILY_FLASH.get(name, []) if "f" in parts
                                   else []):
        d = check_family_flash(torch, timer, gen, arch, H, K, hd,
                               variants, Bf, S, F, fa, ref,
                               dense_attention)
        if case == 0:
            family_row(rows, "flash_attention", p, **d)
        else:
            rows["flash_attention"].setdefault(
                p + "serving_shapes", []).append(d)
        print(f"[kernels] flash {name} at B={Bf} S={S}: {d['ms']:.4f} ms "
              f"({d['tflops']:.0f} TFLOP/s), device "
              f"{fmt(d['device_ms'], '.4f')}, SDPA "
              f"{d.get('library_ms') or d.get('sdpa_causal_no_cap_ms')}"
              f" ms{' (causal, no cap: a yardstick)' if opts else ''}; o "
              f"max row rel err {d['max_row_rel_err']:.3g}, lse "
              f"{d['lse_max_abs_err']:.3g}; two launches bit-equal",
              flush=True)

    if "g" in parts:
        # the gather at the member's embedding table
        V, d = c.padded_vocab_size, c.d_model
        table = torch.randn((V, d), generator=gen, device=DEV).bfloat16()
        for n in (8, 256):
            i = torch.randint(0, V, (n,), generator=gen, device=DEV,
                              dtype=torch.int32)
            check(torch.equal(emb.gather(table, i), emb.gather_plain(table,
                                                                     i)),
                  f"gather != table[ids] at {arch} ({V}x{d}), {n} ids")
        family_row(
            rows, "gather", p, max_abs_err=0.0, max_row_rel_err=0.0,
            shape=f"{arch}: table {V}x{d} bf16 (rows of {2 * d} bytes), "
                  "256 ids",
            ms=timer(lambda: emb.gather(table, i)),
            device_ms=timer.device(lambda: emb.gather(table, i)),
            plain_ms=timer(lambda: emb.gather_plain(table, i)),
            library_ms=timer(lambda: torch.index_select(table, 0, i)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(2 * 256 * d * 2 + 256 * 4, 0.0))))
        print(f"[kernels] gather {name} ({V}x{d}): == table[ids]; 256 ids "
              f"{rows['gather'][p + 'ms']:.4f} ms, index_select "
              f"{rows['gather'][p + 'library_ms']:.4f}", flush=True)
        del table
    torch.cuda.empty_cache()


def check_family(torch, timer, gen, rows):
    """Phase 2f: every kernel of the dense family's serving path at each
    member's heads and table (``check_member``), under the prefixes
    "gemma2_", "qwen3_", "starcoder2_"."""
    for name, (arch, H, K, opts) in FAMILY.items():
        check_member(torch, timer, gen, rows, name, arch, H, K, opts,
                     set("dcpfg"))


# phase 2g: this slice's members: name -> (arch, H, K, layer options, the
# kernels of its path: d(ecode), c(hunk), p(acked), f(lash), g(ather)).
# qwen3_moe and grok1 (G 8 and 6; grok's attention softcap 30) serve
# through the paged kernels, packed included; whisper's decoder self
# attention (hd 64, G 1) through decode and chunk only (no packed
# prefill), its flash shapes in HD64_FLASH; qwen2_vl's static path
# through flash (G 6) and the gather
SLICE = {"qwen3_moe": ("qwen3_moe_30b_a3b", 32, 4, {}, "dcpfg"),
         "grok1": ("grok1_314b", 48, 8, dict(cap=30.0), "dcpg"),
         "whisper": ("whisper_large_v3", 20, 20, {}, "dcg"),
         "qwen2_vl": ("qwen2_vl_2b", 12, 2, {}, "fg")}
# flash shapes of one route: (label, B, Sq, Skv, hd, options, timed). hd
# 64, whisper's heads: the encoder at admission (one request) and in the
# static path (8), a chunk's cross attention, the static prefill's causal
# self attention at S 512, and the options the kernel takes on this route
# (window, cap, q_offset) at a ragged shape. The timed ones (SDPA computes
# the same function there) are timed beside SDPA, both by CUDA events and
# by profiler device time; the first is the row's shape, whose plain
# version is timed too
HD64_FLASH = [
    ("encoder 1500 x 1500", 1, 1500, 1500, 64, dict(causal=False), True),
    ("static encoder B=8", 8, 1500, 1500, 64, dict(causal=False), True),
    ("chunk cross 256 x 1500", 1, 256, 1500, 64, dict(causal=False), True),
    ("causal S 512", 8, 512, 512, 64, dict(causal=True), True),
    ("window 256 cap 30 at q_offset 300", 2, 700, 1000, 64,
     dict(causal=True, window=256, cap=30.0, q_offset=300), False)]


def check_route_flash(torch, timer, gen, rows, name, H, K, shapes):
    """One flash route at ``name``'s heads and ``shapes`` ((label, B, Sq,
    Skv, hd, options, timed), every hd on one route): o held by
    ``check_flash_o``, lse within LSE_TOL of the plain one, two launches
    bit-equal; the timed ones beside SDPA (events and profiler device
    time, with the bound). The first shape is the row's
    ("flash_attention_<route>"), the others its "cases"."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import dense_attention

    route = fa.route(shapes[0][4])
    cases = []
    for label, B, Sq, Skv, hd, fo, timed_case in shapes:
        check(fa.route(hd) == route, f"hd {hd} is not on route {route}")
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        o_k, lse_k = fa.flash_attention(q, k, v, **fo)
        o_2, lse_2 = fa.flash_attention(q, k, v, **fo)
        check(same_bytes(o_k, o_2) and same_bytes(lse_k, lse_2),
              f"flash hd {hd} {label}: two launches differ")
        del o_2, lse_2
        # rows of 8 or 12 values are held against the plain version
        # alone: dense_attention's p, rounded to bf16 after normalizing,
        # puts a row that short up to 1.3e-2 of its norm from the kernel's
        # (hd 8, 2 x 300 rows), past TOL, while the plain one stays within
        e, rel = check_flash_o(f"flash hd {hd} {label}", o_k, q, k, v, fo,
                               ref, dense_attention, dense=hd >= 16)
        e_lse = err(lse_k, ref.flash_attention_fwd_plain(q, k, v, **fo)[1])
        check(e_lse <= LSE_TOL, f"flash hd {hd} {label}: lse max abs err "
              f"{e_lse} (limit {LSE_TOL})")
        pairs = causal_pairs(Sq, Skv, fo["causal"], fo.get("window"),
                             fo.get("q_offset", 0))
        flops = 4.0 * B * H * hd * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * lse_k.numel()
        d = dict(
            kernel="flash_attention", source=FLASH_SRC, kernel_route=route,
            max_abs_err=e, max_row_rel_err=rel, lse_max_abs_err=e_lse,
            library_ms=None,
            shape=f"{name} {label}: B={B} Sq={Sq} Skv={Skv} H={H} K={K} "
                  f"hd={hd} {fo} ({pairs} row-key pairs per batch row)",
            **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, flops))))

        def kernel():
            return fa.flash_attention(q, k, v, **fo)

        d.update(ms=timer(kernel), device_ms=timer.device(kernel))
        d["tflops"] = per_ms(flops, d["device_ms"])
        line = (f"device {fmt(d['device_ms'])} ms (events {d['ms']:.5f}; "
                f"{fmt(d['tflops'], '.0f')} TFLOP/s; bound "
                f"{d['bound_ms']:.5f})")
        if timed_case:
            check(set(fo) == {"causal"}, f"flash {label}: SDPA computes "
                  "no window, cap or q_offset")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=fo["causal"], enable_gqa=H != K)

            d.update(library_ms=timer(sdpa),
                     library_device_ms=timer.device(sdpa))
            line += (f", SDPA device {fmt(d['library_device_ms'])} (events "
                     f"{d['library_ms']:.5f})")
            del qt, kt, vt
        if not cases:
            d["plain_ms"] = timer(lambda: ref.flash_attention_fwd_plain(
                q, k, v, **fo), iters=5)
            line += f", plain {d['plain_ms']:.4f}"
        print(f"[kernels] flash hd {hd} (route {route}) {label}: {line}; o "
              f"max row rel err {rel:.3g}, lse {e_lse:.3g}; two launches "
              "bit-equal", flush=True)
        cases.append(d)
        del q, k, v, o_k, lse_k
    rows[f"flash_attention_{route}"] = dict(cases[0], cases=cases[1:])
    torch.cuda.empty_cache()


# hd-80 flash shapes (zamba2's shared block, H = K = 32), as HD64_FLASH:
# hybrid training (B 2, causal S 2048), phase 14's static prefill (B 8, S
# 512), a ragged causal 1500 and the options at a ragged shape; the first
# is the row's shape
HD80_FLASH = [
    ("training causal S 2048", 2, 2048, 2048, 80, dict(causal=True), True),
    ("static prefill B=8 S=512", 8, 512, 512, 80, dict(causal=True), True),
    ("causal S 1500", 1, 1500, 1500, 80, dict(causal=True), True),
    ("window 256 cap 30 at q_offset 300", 2, 700, 1000, 80,
     dict(causal=True, window=256, cap=30.0, q_offset=300), False)]
# the mma route's head dims (the smoke configs: hd 8 qwen3 and starcoder2,
# 12 qwen2_vl, 16 the rest) at 4 q heads over 2 kv heads, as HD64_FLASH
MMA_FLASH = [
    ("hd 16 causal S 300", 2, 300, 300, 16, dict(causal=True), True),
    ("hd 8 causal S 300", 2, 300, 300, 8, dict(causal=True), True),
    ("hd 12 causal S 300", 2, 300, 300, 12, dict(causal=True), True),
    ("hd 12 window 64 cap 30 at q_offset 100", 2, 200, 300, 12,
     dict(causal=True, window=64, cap=30.0, q_offset=100), False),
    ("hd 8 non-causal 130 x 200", 2, 130, 200, 8, dict(causal=False),
     True)]
# the SSD autograd function at both models' widths (nh, hp, G, N): b 2, S
# 2048, 256-row chunks
SSD_FN_WIDTHS = {"mamba2_370m": (32, 64, 1, 128),
                 "zamba2_2p7b": (80, 64, 1, 64)}


def check_ssd_function(torch, timer, gen, rows):
    """The SSD autograd function (the kernel forward, the plain recompute
    backward) at SSD_FN_WIDTHS: its gradients for x, dt, A, B and C
    against autograd through the plain ``ssd_chunked`` on the same inputs
    and output gradients, every gradient row (last dim) within TOL of its
    norm; its forward and backward device times. Under "function_" keys
    of the ssd row, the widths as "<arch>_" prefixes."""
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.models.ssm import ssd_chunked

    b, S, Q = 2, 2048, 256
    for arch, (nh, hp, G, N) in SSD_FN_WIDTHS.items():
        ins = ssd_inputs(torch, gen, b, S, nh, hp, G, N)[:5]
        gy = torch.randn((b, S, nh, hp), generator=gen, device=DEV)
        gh = torch.randn((b, nh, hp, N), generator=gen, device=DEV)
        grads = {}
        for fn in ("kernel", "plain"):
            leaves = [t.clone().requires_grad_() for t in ins]
            if fn == "kernel":
                y, h = ssd_k.SSD.apply(*leaves, None, Q)
            else:
                y, h = ssd_chunked(*leaves, Q)
            ((y.float() * gy).sum() + (h * gh).sum()).backward()
            grads[fn] = [t.grad.float() for t in leaves]
            del y, h, leaves
        errs = []
        for name, a, r in zip("x dt A B C".split(), grads["kernel"],
                              grads["plain"]):
            e = row_err(a.reshape(-1, a.shape[-1]), r.reshape(-1, r.shape[-1]))
            check(e <= TOL, f"SSD function {arch}: d{name} max row relative "
                  f"err {e} (limit {TOL})")
            errs.append(e)
        del grads
        leaves = [t.clone().requires_grad_() for t in ins]

        def fwd():
            return ssd_k.SSD.apply(*leaves, None, Q)

        y, h = fwd()
        loss = (y.float() * gy).sum() + (h * gh).sum()

        def bwd():
            return torch.autograd.grad(loss, leaves, retain_graph=True)

        d = {"function_fwd_ms": timer(fwd, iters=5),
             "function_fwd_device_ms": timer.device(fwd, iters=3),
             "function_bwd_ms": timer(bwd, iters=3, warmup=1),
             "function_bwd_device_ms": timer.device(bwd, iters=2),
             "function_grad_max_row_rel_err": max(errs)}
        print(f"[kernels] SSD function {arch} (b {b}, S {S}, nh {nh}, hp "
              f"{hp}, N {N}, chunk {Q}): gradients vs autograd through "
              f"ssd_chunked, max row relative err by input (x, dt, A, B, C) "
              f"{[f'{e:.3g}' for e in errs]}; forward {d['function_fwd_ms']:.3f}"
              f" ms (device {fmt(d['function_fwd_device_ms'], '.3f')}), "
              f"plain recompute backward {d['function_bwd_ms']:.3f} ms "
              f"(device {fmt(d['function_bwd_device_ms'], '.3f')})",
              flush=True)
        family_row(rows, "ssd", f"{arch.split('_')[0]}_", **d)
        del y, h, loss, leaves, ins
        torch.cuda.empty_cache()


# seeded draws of each MMA_FLASH shape that phase 2h holds the mma route
# to, and the worst row error it prints
MMA_DRAWS = 64


def mma_draws(torch, gen, rows, n=MMA_DRAWS) -> None:
    """The mma route over ``n`` seeded draws of each MMA_FLASH shape (4 q
    heads over 2 kv heads): o against its plain fp32 version, both as
    ``check_close`` holds it (the plain o rounded to bf16: every row
    within TOL of its norm, every value within the cap) and against the
    plain o before that rounding (every row within TOL; two bf16 outputs
    can sit one ulp apart where the exact value lies near a rounding
    edge, which in a row of 8 values is up to 2^-7 of a value twice the
    row's rms, 5.5e-3 of the row's norm). The worst row errors by shape,
    under "draws_" keys of the "flash_attention_mma" row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    H, K = 4, 2
    worst, worst32 = {}, {}
    for label, B, Sq, Skv, hd, fo, _ in MMA_FLASH:
        w = w32 = 0.0
        for _ in range(n):
            q = torch.randn((B, Sq, H, hd), generator=gen,
                            device=DEV).bfloat16()
            k = torch.randn((B, Skv, K, hd), generator=gen,
                            device=DEV).bfloat16()
            v = torch.randn((B, Skv, K, hd), generator=gen,
                            device=DEV).bfloat16()
            o_k, _ = fa.flash_attention(q, k, v, **fo)
            _, rel = check_close(f"flash mma {label} (draws)", o_k,
                                 ref.flash_attention_fwd_plain(
                                     q, k, v, **fo)[0])
            # fp32 operands hold the bf16 values exactly: the same plain
            # function, its output not rounded
            rel32 = row_err(o_k, ref.flash_attention_fwd_plain(
                q.float(), k.float(), v.float(), **fo)[0])
            check(rel32 <= TOL, f"flash mma {label} (draws): max row "
                  f"relative err {rel32} against the unrounded plain o "
                  f"(limit {TOL})")
            w, w32 = max(w, rel), max(w32, rel32)
        worst[label], worst32[label] = w, w32
    row = rows["flash_attention_mma"]
    row.update(draws=n, draws_worst_row_rel_err=max(worst.values()),
               draws_worst_by_shape=worst,
               draws_worst_row_rel_err_fp32=max(worst32.values()),
               draws_worst_by_shape_fp32=worst32)
    print(f"[kernels] flash mma route over {n} seeded draws of each shape: "
          f"worst o row relative err vs the plain fp32 version "
          f"{max(worst32.values()):.4g} (its o unrounded), "
          f"{max(worst.values()):.4g} (its o in bf16; limit {TOL}); by "
          "shape " + json.dumps({k: [float(f"{worst32[k]:.4g}"),
                                     float(f"{v:.4g}")]
                                 for k, v in worst.items()}), flush=True)


def check_hd80(torch, timer, gen, rows):
    """Phase 2h: the flash forward's hd-80 route (row
    "flash_attention_wgmma80"), the mma route at hd 8, 12 and 16 (row
    "flash_attention_mma", also over MMA_DRAWS draws of its shapes) and
    the SSD autograd function."""
    check_route_flash(torch, timer, gen, rows, "zamba2", 32, 32, HD80_FLASH)
    check_route_flash(torch, timer, gen, rows, "smoke", 4, 2, MMA_FLASH)
    mma_draws(torch, gen, rows)
    check_ssd_function(torch, timer, gen, rows)


def check_slice(torch, timer, gen, rows):
    """Phase 2g: the kernels at this slice's shapes (SLICE, HD64_FLASH),
    under the member prefixes and the "flash_attention_wgmma64" row."""
    check_route_flash(torch, timer, gen, rows, "whisper", 20, 20,
                      HD64_FLASH)               # whisper: H = K = 20
    for name, (arch, H, K, opts, parts) in SLICE.items():
        check_member(torch, timer, gen, rows, name, arch, H, K, opts,
                     set(parts))


def check_kernels(torch, timer):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rows = {}
    check_paged(torch, timer, gen, rows)
    check_paged_edges(torch, gen)
    mma_zero_rows_probe(torch, gen)
    check_ragged(torch, timer, gen, rows)
    check_gather(torch, timer, gen, rows)
    check_ssd(torch, timer, gen, rows)
    check_flash(torch, timer, gen, rows)
    check_sampled_softmax(torch, timer, gen, rows)
    check_family(torch, timer, gen, rows)
    check_slice(torch, timer, gen, rows)
    check_hd80(torch, timer, gen, rows)
    # phase 16b here, early, where fewer of the profiler's traces fail
    # their check (Timer.kernels); a generator of its own leaves the other
    # checks' inputs as they were
    core_gen = torch.Generator(device=DEV)
    core_gen.manual_seed(16)
    core_gather(torch, timer, core_gen, rows)
    for name, r in rows.items():
        extra = ""
        if "no_write_ms" in r:
            extra = (f" no_write: kernel_ms={r['no_write_ms']:.4f} "
                     f"plain_ms={r['no_write_plain_ms']:.4f} "
                     f"bound_ms={r['no_write_bound_ms']:.4f} "
                     f"max_row_rel_err={r['no_write_max_row_rel_err']:.3g}")
        print(f"[kernels] {name}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"max_row_rel_err={r['max_row_rel_err']:.3g}{extra}",
              flush=True)
        print(f"[kernels] {name}: {json.dumps(r)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


def reset_launches(counters) -> None:
    for fn in counters:
        if isinstance(fn.launches, dict):
            fn.launches.clear()
        else:
            fn.launches = 0


def summary_name(kernel: str, key: str) -> str:
    """Summary name of a (wrapper, variant) launch key; variant "" for a
    wrapper that keeps one count."""
    return variant(kernel, key) if key else kernel


def read_launches(counters) -> dict:
    """{summary name: launches since the last reset}."""
    out = {}
    for fn in counters:
        if isinstance(fn.launches, dict):
            for pool, n in fn.launches.items():
                out[variant(fn.__name__, pool)] = n
        else:
            out[fn.__name__] = fn.launches
    return out


def run_launches(counters, eng) -> tuple[dict, dict]:
    """A serving run's launches, replay-aware: the counters' own since the
    last reset (eager steps, or a graph's warm-up and capture) plus, per
    graph, replays x the launches its capture recorded. Returns (total,
    the replays' part) by summary name."""
    total = read_launches(counters)
    replayed = {}
    if eng.graphs is not None:
        for (kernel, key), n in eng.graphs.run_launches().items():
            name = summary_name(kernel, key)
            replayed[name] = n
            total[name] = total.get(name, 0) + n
    return total, replayed


# ---------------------------------------------------------------------------
# phases 3-5: serve glm4_9b, mamba2_370m and zamba2_2p7b at full size
# ---------------------------------------------------------------------------


def weight_bytes(eng) -> int:
    """Bytes one decode step must read at least: every parameter once and
    the runner's fp32 copy of the logits table (all of a MoE layer's
    experts: the dispatch multiplies every expert's capacity rows). An
    encoder-decoder's decode reads its decoder and every slot's cross K/V,
    not its encoder."""
    p = eng.params
    if "encoder" in p:
        p = {k: v for k, v in p.items()
             if k not in ("encoder", "enc_final_norm")}
        p["cross"] = eng.cache["cross"]
    n = sum(t.numel() * t.element_size() for t in leaves(p))
    return n + eng.runner.head.numel() * eng.runner.head.element_size()


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def request_mode(sp) -> str:
    """The sampling mode a step with this request alone runs in."""
    if sp.needs_pipeline:
        return "full"
    return "plain" if sp.temperature > 0 else "greedy"


def serve(torch, counters, eng, reqs, max_new, expect, modes=("greedy",),
          exact_len=True):
    """One instrumented ``eng.run``: launch counts zeroed before and read
    after, replay-aware (the kernels named in ``expect`` must have
    launched, and on a graph engine launched in replays); per step its
    shape and sampling mode, its wall time and the device span of its
    body (CUDA events around the replay, or around the eager body); finite
    logits (read from the body's outputs after the run); tokens in range
    (every request ``max_new`` of them unless ``exact_len`` is off: stop
    sequences and EOS retire early); the most chunks any step carried.
    The graphs of ``modes`` are captured before the run, as at a server's
    start-up, each timed. Returns (the run's measurements, its tokens)."""
    cfg = eng.cfg
    steps, finite, widest, last = [], [], [0], [None]
    run_step, forward = eng.step, eng._forward
    schedule = eng.sched.schedule

    def timed_forward(has_chunk, mode="greedy"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(has_chunk, mode)
        end.record()
        logits = out["logits"]
        finite.append(torch.isfinite(logits[:, :cfg.vocab_size]).all())
        last[0] = (has_chunk, mode, start, end)
        return out

    def timed_step():
        last[0] = None
        t = time.monotonic()
        out = run_step()
        if last[0] is not None:
            steps.append((*last[0], time.monotonic() - t))
        return out

    chunks = []

    def counted_schedule():
        plan = schedule()
        widest[0] = max(widest[0], len(plan.chunks))
        chunks.extend((r.num_computed, n, r.context_len)
                      for _, r, n in plan.chunks)
        return plan

    eng.step, eng._forward = timed_step, timed_forward
    eng.sched.schedule = counted_schedule
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    capture_by_mode, pool_by_mode = {}, {}
    for mode in modes:             # a server's start-up, outside the run
        t = time.monotonic()
        eng.capture_graphs(mode=mode)
        torch.cuda.synchronize()
        capture_by_mode[mode] = time.monotonic() - t
        if eng.graphs is not None:
            pool_by_mode[mode] = eng.graphs.pool_bytes() / 2 ** 20
    capture_s = sum(capture_by_mode.values())
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    launches, replayed = run_launches(counters, eng)
    s = eng.stats
    for r in reqs:
        o = outs[r.rid]
        check(len(o) == max_new or (not exact_len and 1 <= len(o) <= max_new),
              f"request {r.rid}: {len(o)} tokens, not {max_new}")
        check(bool(((o >= 0) & (o < cfg.vocab_size)).all()),
              f"request {r.rid}: token out of range")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    q = eng.sched.chunk_quantum
    check(all(lo % q == 0 and (n % q == 0 or lo + n == total)
              for lo, n, total in chunks),
          f"a non-final chunk is not a multiple of the quantum {q}")
    graphs = eng.graphs is not None
    for name in expect:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched on the main path")
        check(not graphs or replayed.get(name, 0) > 0,
              f"kernel {name} is in no replayed graph")
    if graphs:
        # one graph per (shape, mode) captured; steps replay only the
        # modes that the requests need (greedy runs: the greedy pair)
        used = {m for _, m in eng.graphs.graphs}
        need = {request_mode(r.sampling) for r in reqs}
        replayed_modes = {m for (_, m), n in eng.graphs.replays.items() if n}
        check(s["graph_captures"] == len(eng.graphs.graphs)
              <= 2 * len(used) and used <= set(modes) | need
              and replayed_modes <= need
              and sum(s["graph_replays"].values()) == s["steps"],
              f"graphs: {s['graph_captures']} captures of modes "
              f"{sorted(used)} (requests need {sorted(need)}), replays "
              f"{s['graph_replays']} over {s['steps']} steps")
    # the means leave each (shape, mode)'s first step out (eager: lazy
    # set-up; graphs: a capture at that step for a mode not captured up
    # front)
    by_key = {}
    for has_chunk, mode, start, end, wall in steps:
        by_key.setdefault((has_chunk, mode), []).append(
            (wall, start.elapsed_time(end)))
    by_shape = {h: [x for (hc, _), v in by_key.items() if hc == h
                    for x in v[1:]] for h in (True, False)}
    first = [w[0] for w in by_key.values() if w]

    def mean(xs):
        return sum(xs) / max(len(xs), 1)

    def name(key):
        return ("chunk" if key[0] else "decode") + "/" + key[1]

    by_mode = {name(k): {"steps": len(v), "step_ms_mean": 1e3 * mean(
        [w for w, _ in v[1:]]), "device_ms_mean": mean([d for _, d in v[1:]])}
        for k, v in sorted(by_key.items())}
    device_ms = sum(start.elapsed_time(end) for _, _, start, end, _ in steps)
    lat = [s["latency"][r.rid] for r in reqs]
    ttft = [x["first_token_wall"] - x["arrival_wall"] for x in lat]
    gap = [(x["done_wall"] - x["first_token_wall"]) / max(max_new - 1, 1)
           for x in lat]
    res = {"cuda_graphs": graphs, "kv_dtype": s["kv_dtype"],
           "prefill_pack": eng.prefill_pack,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
           "token_gap_s_median": statistics.median(gap),
           "token_gap_s_max": max(gap),
           "tok_s": s["tok_s"], "wall_s": s["wall_s"], "steps": s["steps"],
           "tokens": s["tokens"],
           "capture_s": capture_s,
           "first_step_s": [w for w, _ in first],
           "chunk_step_ms_mean": 1e3 * mean([w for w, _ in by_shape[True]]),
           "decode_step_ms_mean": 1e3 * mean([w for w, _ in
                                              by_shape[False]]),
           "chunk_body_device_ms_mean": mean([d for _, d in by_shape[True]]),
           "decode_body_device_ms_mean": mean([d for _, d in
                                               by_shape[False]]),
           "body_device_ms": device_ms,
           "busy_share_events": device_ms / max(1e3 * s["wall_s"], 1e-9),
           "chunk_steps": sum(len(v) for k, v in by_key.items() if k[0]),
           "decode_steps": sum(len(v) for k, v in by_key.items()
                               if not k[0]),
           "by_mode": by_mode, "capture_s_by_mode": capture_by_mode,
           "graph_pool_mib_after_capture": pool_by_mode,
           "most_chunks_in_a_step": widest[0],
           "cache_hit_tokens": s["cache_hit_tokens"],
           "prefill_chunks": s["prefill_chunks"],
           "kv_cache_mib": s["kv_cache_mib"],
           "slot_state_mib": s["slot_state_mib"],
           "quantum_dropped_tokens": s["quantum_dropped_tokens"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "graph_captures": s["graph_captures"],
           "graph_replays": dict(s["graph_replays"]),
           "graph_pool_mib": (eng.graphs.pool_bytes() / 2 ** 20 if graphs
                              else 0.0),
           "decode_floor_ms": 1e3 * weight_bytes(eng) / HBM_BYTES_PER_S,
           "launches": launches, "replayed_launches": replayed}
    return res, {r.rid: outs[r.rid].tolist() for r in reqs}


def decode_profile(torch, eng, top: int = 8) -> dict:
    """One eager decode body of ``eng`` (its last step's inputs) under
    torch.profiler, the L2 flushed: device ms by kernel, the ``top``
    largest and the total."""
    timer = Timer(torch)
    with torch.no_grad():
        by_kernel = timer.kernels(lambda: eng.runner_body(
            has_chunk=False, sampling="greedy"), iters=3)
    del timer
    if by_kernel is None:
        return {"total_ms": None, "top": []}
    order = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {"total_ms": sum(by_kernel.values()),
            "top": [(k[:80], v) for k, v in order[:top]]}


def serve_ab(torch, counters, card, label, make_engine, make_reqs, max_new,
             expect, profile=False):
    """Phases 3-5's A/B: the same requests through a graph engine (the
    card's default) and an eager one (``cuda_graphs=False``), same
    weights; greedy tokens byte-identical. With ``profile`` the eager
    engine's decode body is profiled after its run (``decode_profile``,
    into the eager run's "decode_profile"). Returns (graph run, eager
    run, the greedy tokens in request order)."""
    runs = {}
    toks = {}
    for graphs in (True, False):
        eng = make_engine(graphs)
        check((eng.graphs is not None) == graphs,
              f"{label}: cuda_graphs={graphs} not honoured")
        runs[graphs], toks[graphs] = serve(torch, counters, eng,
                                           make_reqs(), max_new, expect)
        if profile and not graphs:
            runs[graphs]["decode_profile"] = prof = decode_profile(torch,
                                                                   eng)
            print(f"[serve-ab] {label}: one eager decode body, device ms "
                  f"{fmt(prof['total_ms'], '.3f')}, by kernel: "
                  f"{prof['top']}",
                  flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs[True], runs[False]
    check(list(toks[True].values()) == list(toks[False].values()),
          f"{label}: graph and eager greedy tokens differ")
    # the same kernels run in both: the graphs' device time over the eager
    # run's wall is the eager run's busy share (its events span the host's
    # launch gaps too)
    e["busy_share_from_graph_device_ms"] = g["body_device_ms"] / max(
        1e3 * e["wall_s"], 1e-9)
    print(f"[serve-ab] {card}: {label}: tokens byte-identical; graphs "
          f"{g['tok_s']} tok/s vs eager {e['tok_s']}; decode step "
          f"{g['decode_step_ms_mean']:.2f} vs {e['decode_step_ms_mean']:.2f}"
          f" ms (body on the device {g['decode_body_device_ms_mean']:.2f} vs "
          f"{e['decode_body_device_ms_mean']:.2f}; bytes floor "
          f"{g['decode_floor_ms']:.2f}); chunk step "
          f"{g['chunk_step_ms_mean']:.2f} vs {e['chunk_step_ms_mean']:.2f} "
          f"ms; busy share by events {g['busy_share_events']:.3f} vs "
          f"{e['busy_share_from_graph_device_ms']:.3f} (the graphs' "
          f"device ms over the eager wall); TTFT median "
          f"{g['ttft_s_median']:.3f} vs {e['ttft_s_median']:.3f} s; token "
          f"gap median {1e3 * g['token_gap_s_median']:.2f} vs "
          f"{1e3 * e['token_gap_s_median']:.2f} ms; peak "
          f"{g['peak_mem_gib']:.2f} vs {e['peak_mem_gib']:.2f} GiB; graph "
          f"pool {g['graph_pool_mib']:.1f} MiB, both captures "
          f"{g['capture_s']:.2f} s", flush=True)
    return g, e, list(toks[True].values())


def serve_full(torch, counters, card):
    """Phase 3: bf16 pools, one chunk per step, on graphs, then the same
    run eager (A/B). Returns (the graph run's measurements with the eager
    run's under "eager", the parameters, kept for phase 4)."""
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    cfg = get_config("glm4_9b")
    t0 = time.monotonic()
    params = init_model(cfg, 0, DEV)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = phase3_prompts(cfg)

    def make_engine(graphs):
        eng = InferenceEngine(cfg, device=DEV, params=params, max_batch=8,
                              block_size=16, max_len=1024,
                              max_num_batched_tokens=8 + 256, seed=0,
                              cuda_graphs=graphs)
        check(eng.chunk_width == 256, f"chunk width {eng.chunk_width}")
        return eng

    res, eager, _ = serve_ab(
        torch, counters, card, "glm4_9b bf16 pack 1", make_engine,
        lambda: [Request(p.copy(), max_new=32) for p in prompts], 32,
        ("paged_attention", "paged_prefill_attention", "gather"))
    for r in (res, eager):
        check(r["cache_hit_tokens"] > 0, "no prefix-cache hits")
        check(r["prefill_chunks"] > len(prompts), "no prompt took two chunks")
    res.update(params=cfg.param_count(), init_s=init_s, eager=eager)
    print(f"[serve] {card}: glm4_9b full width, 40 layers "
          f"({res['params'] / 1e9:.2f} B params), bf16 pools, CUDA graphs: "
          f"{res['tok_s']} tok/s, decode step "
          f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
          f"{res['chunk_step_ms_mean']:.2f} ms: {json.dumps(res)}",
          flush=True)
    return res, params


def packed_requests(cfg, n, max_new):
    """Phase 4's requests: prompt lengths drawn from [96, 480] (seed 0),
    the first 8 starting with one shared 128-token prefix."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(96, 481, 16)
    prefix = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    reqs = []
    for i, n_tok in enumerate(lens[:n]):
        p = rng.integers(0, cfg.vocab_size, int(n_tok)).astype(np.int32)
        if i < 8:
            k = min(128, len(p))
            p[:k] = prefix[:k]
        reqs.append(Request(p, max_new=max_new))
    return reqs


def serve_packed(torch, counters, card, params):
    """Phase 4: int8 pools with prefill_pack 4 (16 requests; on graphs,
    then eager, A/B), then the other pool/pack pairs at full width (8
    requests, 4 new tokens), on graphs."""
    from repro_torch.config import get_config
    from repro_torch.models.quant import KV_DTYPES
    from repro_torch.serving import InferenceEngine

    cfg = get_config("glm4_9b")
    runs = [(4, "int8", 16, 16), (4, "bf16", 8, 4), (4, "fp8", 8, 4),
            (1, "int8", 8, 4), (1, "fp8", 8, 4)]
    results = []
    for i, (pack, kv, n, max_new) in enumerate(runs):
        def make_engine(graphs, pack=pack, kv=kv):
            eng = InferenceEngine(cfg, device=DEV, params=params,
                                  max_batch=8, block_size=16, max_len=1024,
                                  max_num_batched_tokens=8 + 512, seed=0,
                                  prefill_pack=pack, kv_dtype=kv,
                                  cuda_graphs=graphs)
            check(eng.chunk_width == 512 and eng.prefill_pack == pack,
                  f"chunk width {eng.chunk_width}, pack {eng.prefill_pack}")
            check(eng.cache["k"].dtype == KV_DTYPES[kv],
                  f"pools are {eng.cache['k'].dtype}, not {kv}")
            return eng

        def make_reqs(n=n, max_new=max_new):
            return packed_requests(cfg, n, max_new)

        prefill = ("ragged_paged_prefill_attention" if pack > 1
                   else "paged_prefill_attention")
        expect = (variant(prefill, kv), variant("paged_attention", kv),
                  "gather")
        if i == 0:
            res, eager, _ = serve_ab(
                torch, counters, card, f"glm4_9b {kv} pack {pack}",
                make_engine, make_reqs, max_new, expect)
            res["eager"] = eager
        else:
            eng = make_engine(True)
            res, _ = serve(torch, counters, eng, make_reqs(), max_new,
                           expect)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        check(res["cache_hit_tokens"] > 0, f"({pack}, {kv}): no prefix hits")
        if pack > 1:
            check(res["most_chunks_in_a_step"] >= 2,
                  f"({pack}, {kv}): no step carried two chunks")
        res["requests"] = n
        print(f"[serve-packed] {card}: glm4_9b full width, prefill_pack "
              f"{pack}, {kv} pools, {n} requests, CUDA graphs: "
              f"{res['tok_s']} tok/s, decode step "
              f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, TTFT median "
              f"{res['ttft_s_median']:.3f} s max {res['ttft_s_max']:.3f} s, "
              f"token gap median {1e3 * res['token_gap_s_median']:.2f} ms "
              f"max {1e3 * res['token_gap_s_max']:.2f} ms, peak "
              f"{res['peak_mem_gib']:.2f} GiB: {json.dumps(res)}",
              flush=True)
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# phase 9: the sampling surface and speculative decoding at glm4's size
# ---------------------------------------------------------------------------


def check_streams(torch, V):
    """Phase 9a: jax's threefry bits for 64 (seed, rid, counter, tag) keys
    over V words, card against CPU, bit for bit; the Gumbel noise within
    2 ulp of max(1, |g|). The first words are printed for a check against
    ``jax.random.bits`` off the card. Then the draw's own device time:
    ``sample_tokens`` and ``sample_tokens_full`` over (9, V) rows, each
    captured alone in a CUDA graph, against an argmax, by events around
    replays."""
    import numpy as np
    from repro_torch.serving import prng
    from repro_torch.serving.sampling import (SP_KEYS, base_key,
                                              sample_tokens,
                                              sample_tokens_full)

    g = np.random.default_rng(3)
    seeds = torch.tensor(g.integers(-2 ** 31, 2 ** 31, 64), dtype=torch.int32)
    rids = torch.tensor(g.integers(0, 2 ** 20, 64))
    cnts = torch.tensor(g.integers(0, 2 ** 20, 64))
    tags = torch.tensor(g.integers(0, 4, 64))          # 0: the plain stream
    base = base_key(seeds, rids, cnts)
    keys = torch.where((tags > 0)[:, None], prng.fold_in(base, tags), base)
    bits = {d: prng.random_bits(keys.to(d), V).cpu() for d in ("cpu", DEV)}
    check(torch.equal(bits["cpu"], bits[DEV]),
          "threefry bits differ between the card and the CPU")
    gum = {d: prng.gumbel(keys.to(d), V).cpu().numpy() for d in ("cpu", DEV)}
    # ulps of max(1, |g|): near g = 0, -log(-log(u)) cancels, and one ulp
    # of the inner log (near 1) is many ulps of the result
    ulps = np.abs(gum[DEV] - gum["cpu"]) / np.spacing(
        np.maximum(np.abs(gum["cpu"]), np.float32(1)))
    check(float(ulps.max()) <= 2, f"Gumbel noise: card vs CPU "
          f"{float(ulps.max())} ulp of max(1, |g|)")
    for i in range(3):
        print(f"[streams] seed {int(seeds[i])} rid {int(rids[i])} counter "
              f"{int(cnts[i])} tag {int(tags[i])}: bits[:4] "
              f"{[hex(int(x)) for x in bits[DEV][i, :4]]}", flush=True)
    # the draw alone, as the step graph runs it
    N = 9
    gen = torch.Generator(device=DEV).manual_seed(0)
    logits = torch.randn((N, V), generator=gen, device=DEV) * 3
    a = {"temps": torch.full((N,), 0.8, device=DEV),
         "top_ks": torch.full((N,), 50, dtype=torch.int32, device=DEV),
         "seeds": seeds[:N].to(DEV), "rids": rids[:N].to(DEV),
         "counters": cnts[:N].to(DEV),
         "top_ps": torch.full((N,), 0.9, device=DEV),
         "min_ps": torch.full((N,), 0.05, device=DEV),
         "rep_pens": torch.full((N,), 1.2, device=DEV),
         "pres_pens": torch.full((N,), 0.3, device=DEV),
         "freq_pens": torch.full((N,), 0.2, device=DEV),
         "pmask": torch.rand((N, V), generator=gen, device=DEV) < 0.01,
         "ocounts": (torch.rand((N, V), generator=gen, device=DEV)
                     < 0.001).int()}
    plain = ("temps", "top_ks", "seeds", "rids", "counters")
    fns = {"argmax": lambda: torch.argmax(logits, -1),
           "plain": lambda: sample_tokens(logits, *(a[k] for k in plain)),
           "full": lambda: sample_tokens_full(
               logits, {k: a[k] for k in SP_KEYS}, max_logprobs=8)}
    ms = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ms[name] = graph_replay_ms(torch, graph)
        del graph
    print(f"[streams] card and CPU bits equal for 64 keys x {V}; Gumbel "
          f"within {float(ulps.max()):.0f} ulp of max(1, |g|); draw over "
          f"({N}, {V}) rows on a graph: plain {ms['plain']:.4f} ms, full "
          f"{ms['full']:.4f} "
          f"ms, an argmax {ms['argmax']:.4f} ms", flush=True)
    return {"bits_equal": True, "gumbel_max_ulp": float(ulps.max()),
            "draw_ms": ms}


def graph_replay_ms(torch, graph, iters=50):
    """Mean device time of a replay of ``graph`` by CUDA events."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def near_tie_or_same(torch, params, cfg, prompt, ours, ref, limit=TOL,
                     margins=None, before=None) -> bool:
    """Equal greedy streams (True), or a first difference whose top-2
    margin (the card's logits after the common prefix, one monolithic
    chunk) is below ``limit``, the bf16 tolerance by default, with the
    two tokens the top two (False); anything else fails. ``margins``
    collects (step, margin, limit). ``before(n)`` runs before the reading
    of n tokens (a ``RouteLog`` naming its rows)."""
    import numpy as np
    if ours == ref:
        return True
    i = next(j for j, (x, y) in enumerate(zip(ours, ref)) if x != y)
    tokens = np.concatenate([prompt, np.asarray(ours[:i], np.int32)])
    if before is not None:
        before(len(tokens))
    lg = last_logits(torch, params, cfg, tokens, "bf16", device=DEV)
    top = torch.topk(lg, 2)
    margin = float(top.values[0] - top.values[1])
    if margins is not None:
        margins.append((i, margin, limit))
    check(margin < limit and {ours[i], ref[i]} == set(top.indices.tolist()),
          f"greedy streams differ at step {i} with top-2 margin {margin} "
          f"(limit {limit}): tokens {ours[i]} and {ref[i]} at logits "
          f"{float(lg[ours[i]])} and {float(lg[ref[i]])}; top 5 "
          f"{torch.topk(lg, 5)}")
    return False


def seq_rows(reqs, S: int, start: int = 0) -> list:
    """(row, request, position) of S-row sequences laid end to end, one
    for each of ``reqs``, their positions from ``start``."""
    return [(i * S + t, r, start + t) for i, r in enumerate(reqs)
            for t in range(S)]


@contextlib.contextmanager
def patched_route(spy, value=None):
    """``models.moe._route`` as ``spy(route, x, router, k)`` inside the
    block (``route`` the real one); yields ``value``."""
    from repro_torch.models import moe
    route = moe._route
    moe._route = lambda x, router, k: spy(route, x, router, k)
    try:
        yield value
    finally:
        moe._route = route


class RouteTape:
    """The experts each routing call of a run picks, in call order
    (``record()``), and a later run of the same calls made to pick the
    same (``replay()``: its weights renormalised from its own
    probabilities, as ``RouteLog.replay`` does), counting the rows whose
    own choice was another set (``rerouted``) of those replayed."""

    def __init__(self):
        self.calls, self.replayed, self.rerouted = [], 0, 0

    def record(self):
        def spy(route, x, router, k):
            w, idx, probs = route(x, router, k)
            self.calls.append(idx.cpu())
            return w, idx, probs
        return patched_route(spy, self)

    def replay(self):
        tape = iter(self.calls)

        def spy(route, x, router, k):
            _, own, probs = route(x, router, k)
            idx = next(tape).to(own.device)
            check(idx.shape == own.shape, "a routing call the tape does "
                  "not hold")
            self.replayed += idx.shape[0]
            self.rerouted += int((own.sort(dim=-1).values
                                  != idx.sort(dim=-1).values).any(-1).sum())
            w = probs.gather(1, idx)
            return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9), idx, \
                probs
        return patched_route(spy, self)


class RouteLog:
    """The experts a MoE run routes each of its rows to, and their replay.
    ``record()`` logs ``events[(request, position, layer)]``, the row's
    top k in the run's order; ``replay()`` makes the runs inside it route
    the same rows to the same experts, their weights renormalised from
    the run's own probabilities, counting the rows replayed and those
    whose own choice was another set of experts (``replayed``,
    ``rerouted``). ``step(rows)`` names the rows of the calls to come:
    {T: [(row, request, position), ...]} for each call width T, the
    layers of one width in order. A host read per call: eager runs
    only."""

    def __init__(self):
        self.rows, self.layer, self.events = {}, {}, {}
        self.replayed = self.rerouted = 0

    def step(self, rows):
        self.rows, self.layer = rows, {}

    def _layer(self, T: int) -> int:
        check(T in self.rows, f"a MoE call of {T} rows the log was not "
              "told of")
        layer = self.layer.get(T, 0)
        self.layer[T] = layer + 1
        return layer

    def _patched(self, spy):
        return patched_route(spy, self)

    def record(self):
        def spy(route, x, router, k):
            w, idx, probs = route(x, router, k)
            layer, ids = self._layer(idx.shape[0]), idx.tolist()
            for row, req, pos in self.rows[idx.shape[0]]:
                check((req, pos, layer) not in self.events,
                      f"row {(req, pos, layer)} routed twice")
                self.events[(req, pos, layer)] = tuple(ids[row])
            return w, idx, probs
        return self._patched(spy)

    def replay(self):
        import torch

        def spy(route, x, router, k):
            _, idx, probs = route(x, router, k)
            layer, ids = self._layer(idx.shape[0]), idx.tolist()
            for row, req, pos in self.rows[idx.shape[0]]:
                want = self.events.get((req, pos, layer))
                check(want is not None, f"row {(req, pos, layer)} was not "
                      "logged")
                self.replayed += 1
                self.rerouted += set(want) != set(ids[row])
                ids[row] = list(want)
            idx = torch.tensor(ids, dtype=idx.dtype, device=idx.device)
            w = probs.gather(1, idx)
            return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9), idx, \
                probs
        return self._patched(spy)

    def follow_engine(self, eng, reqs):
        """Name the rows of each of ``eng``'s plans (prefill_pack 1: the
        decode rows by slot, the chunk's rows in order), requests numbered
        by their place in ``reqs``."""
        schedule = eng.sched.schedule
        index = {r.rid: n for n, r in enumerate(reqs)}
        B, W = eng.max_batch, eng.chunk_width
        check(eng.prefill_pack == 1 and W != B,
              "RouteLog needs one chunk row wider or narrower than the "
              "decode batch")

        def wrapped():
            plan = schedule()
            rows = {B: [(s, index[r.rid], r.num_computed)
                        for s, r in plan.decodes], W: []}
            for _, r, n in plan.chunks:
                rows[W] += [(i, index[r.rid], r.num_computed + i)
                            for i in range(n)]
            self.step(rows)
            return plan
        eng.sched.schedule = wrapped


def serve_sampling(torch, counters, card, params):
    """Phase 9 at glm4_9b's full width and depth (the phase-3 weights),
    on CUDA graphs: (a) the streams, card against CPU; (b) mixed sampling:
    a greedy / temperature-top-k batch alone and again beside one
    logprobs request (full graphs): byte-identical tokens; then eight
    requests (greedy; t 0.8 top-k 50; top-p 0.9 min-p 0.05; penalties;
    logprobs 5; a stop sequence from the first greedy run's output;
    min_new over an EOS; top-k + top-p + logprobs) on graphs and eager:
    tokens and logprobs byte-identical, the stop fires where the greedy
    stream completes it; (c) speculative decoding, k = 2: a self-draft
    sharing the weights, a fresh draft of 4 layers, the self-draft at
    t = 0.8; greedy runs equal the plain greedy graph run (near-tie
    rule; bitwise or not is reported). Returns the runs' measurements."""
    import dataclasses
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request, SamplingParams

    cfg = get_config("glm4_9b")
    streams = check_streams(torch, cfg.padded_vocab_size)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(160, 321, 8)]
    max_new, modes = 24, ("greedy", "plain", "full")
    expect = ("paged_attention", "paged_prefill_attention", "gather")
    base_kw = dict(device=DEV, params=params, max_batch=8, block_size=16,
                   max_len=1024, seed=0)
    runs = []

    def run(label, specs, graphs=True, spec=None, eos=None, min_new=None):
        kw = dict(base_kw, max_num_batched_tokens=8 + 256)
        if spec is not None:
            kw.update(spec, max_num_batched_tokens=8 * 3 + 256)
        eng = InferenceEngine(cfg, cuda_graphs=graphs, **kw)
        probe = VerifyProbe(eng) if spec is not None else None
        reqs = [Request(prompts[i].copy(), max_new=max_new, sampling=sp,
                        rid=900 + j, eos_id=(eos or {}).get(j),
                        min_new=(min_new or {}).get(j, 0))
                for j, (i, sp) in enumerate(specs)]
        lps = []
        eng.on_token = lambda r, t, lp: lps.append((r.rid, t, lp))
        try:
            res, toks = serve(torch, counters, eng, reqs, max_new, expect,
                              modes=modes if graphs else (),
                              exact_len=eos is None)
        finally:
            if probe is not None:
                probe.close()
        if probe is not None:
            res["verify_launches"], res["verify_replayed_launches"] = \
                probe.launches(cfg.num_layers, res["steps"])
        res.update(label=label, stats={k: eng.stats[k] for k in (
            "full_sampling_steps", "stop_hits", "spec_decodes",
            "spec_emitted", "graph_replays")},
            mean_accept_len=eng.mean_accept_len)
        stop_hit = {r.rid: r.stop_hit for r in reqs}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        modes_line = ", ".join(
            f"{k} {v['step_ms_mean']:.2f} ms (device "
            f"{v['device_ms_mean']:.2f}, {v['steps']} steps)"
            for k, v in res["by_mode"].items())
        cap = {k: round(v, 3) for k, v in res["capture_s_by_mode"].items()}
        pool = {k: round(v, 1)
                for k, v in res["graph_pool_mib_after_capture"].items()}
        print(f"[serve-sampling] {card}: {label}: {res['tok_s']} tok/s; "
              f"steps by (shape/mode): {modes_line}; capture s {cap}"
              f"; graph pool MiB after each capture {pool}"
              f"; mean_accept_len {res['mean_accept_len']:.3f}; peak "
              f"{res['peak_mem_gib']:.2f} GiB; {json.dumps(res['stats'])}",
              flush=True)
        runs.append(res)
        return res, [toks[900 + j] for j in range(len(specs))], lps, \
            stop_hit

    greedy = SamplingParams()
    tk = SamplingParams(temperature=0.8, top_k=50, seed=1)
    base = [(0, greedy), (1, tk), (2, SamplingParams(temperature=1.0,
                                                     seed=2)), (3, greedy)]
    _, alone, _, _ = run("greedy + temperature/top-k", base)
    forced, beside, _, _ = run("the same beside a logprobs request",
                               base + [(4, SamplingParams(logprobs=1))])
    check(forced["stats"]["full_sampling_steps"] > 0, "no full step ran")
    check(beside[:4] == alone, "tokens of plain rows in full steps differ "
          "from the plain graphs'")
    out0 = alone[0]
    stop = tuple(out0[5:7])
    mixed = [(0, greedy), (1, tk),
             (2, SamplingParams(temperature=0.9, top_p=0.9, min_p=0.05,
                                seed=3)),
             (3, SamplingParams(temperature=0.7, repetition_penalty=1.2,
                                presence_penalty=0.3, frequency_penalty=0.2,
                                seed=4)),
             (4, SamplingParams(temperature=0.6, logprobs=5, seed=5)),
             (0, SamplingParams(stop=(stop,))),
             (0, greedy),
             (5, SamplingParams(temperature=1.0, top_k=20, top_p=0.95,
                                logprobs=3, seed=7))]
    eos, min_new = {6: out0[2]}, {6: 8}
    res_g, toks_g, lps_g, hits = run("mixed sampling, graphs", mixed,
                                     eos=eos, min_new=min_new)
    res_e, toks_e, lps_e, _ = run("mixed sampling, eager", mixed,
                                  graphs=False, eos=eos, min_new=min_new)
    check(toks_g == toks_e, "mixed sampling: graph and eager tokens differ")
    check(lps_g == lps_e, "mixed sampling: graph and eager logprobs differ")
    g0 = toks_g[0]
    first = next((i for i in range(1, len(g0))
                  if tuple(g0[i - 1:i + 1]) == stop), None)
    check(first is not None and toks_g[5] == g0[:first + 1] and hits[905],
          f"the stop {stop} did not retire request 905 where the greedy "
          f"stream completes it: {toks_g[5]} vs {g0}")
    m = toks_g[6]
    check(m == g0[:len(m)] and len(m) >= 8
          and (len(m) == max_new or m[-1] == out0[2]),
          f"min_new: request 906 gave {m}")
    res_g["eager"] = res_e
    sampling = {"streams": streams, "stop": list(stop),
                "stop_fired_at": first, "min_new_len": len(m)}

    # (c) speculative decoding, k = 2
    plain_res, plain, _, _ = run("plain greedy (8 requests)",
                                 [(i, greedy) for i in range(8)])
    spec_runs = {}
    draft_cfg = dataclasses.replace(cfg, num_layers=4)
    for label, spec, sp in (
            ("self-draft, shared weights", dict(draft_cfg=cfg,
                                                draft_params=params), greedy),
            ("fresh glm4_9b draft, 4 of 40 layers",
             dict(draft_cfg=draft_cfg,
                  draft_params=init_model(draft_cfg, 1, DEV)), greedy),
            ("self-draft, t = 0.8", dict(draft_cfg=cfg, draft_params=params),
             SamplingParams(temperature=0.8, seed=11))):
        spec["num_speculative_tokens"] = 2
        res, toks, _, _ = run(f"speculative k=2, {label}",
                              [(i, sp) for i in range(8)], spec=spec)
        spec.clear()
        check(res["stats"]["spec_decodes"] > 0, f"{label}: no verify step")
        if sp is greedy:
            bitwise = [near_tie_or_same(torch, params, cfg, prompts[i], o, r)
                       for i, (o, r) in enumerate(zip(toks, plain))]
            res["bitwise_equal_to_plain"] = all(bitwise)
            res["requests_bitwise_equal"] = sum(bitwise)
        spec_runs[label] = res
        print(f"[serve-spec] {card}: {label}: mean_accept_len "
              f"{res['mean_accept_len']:.3f}, {res['tok_s']} tok/s (plain "
              f"greedy {plain_res['tok_s']}), spec decode step "
              f"{res['decode_step_ms_mean']:.2f} ms (device "
              f"{res['decode_body_device_ms_mean']:.2f}; plain greedy "
              f"{plain_res['decode_step_ms_mean']:.2f}), chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, verify launches "
              f"{res['verify_launches']} ({res['verify_replayed_launches']}"
              f" in replays), peak "
              f"{res['peak_mem_gib']:.2f} GiB"
              + (f", greedy tokens equal plain greedy (near-tie rule), "
                 f"bitwise for {res['requests_bitwise_equal']}/8 requests"
                 if sp is greedy else ""), flush=True)
    sampling["speculative"] = {k: {n: v[n] for n in (
        "mean_accept_len", "tok_s", "decode_step_ms_mean",
        "decode_body_device_ms_mean", "chunk_step_ms_mean", "peak_mem_gib")}
        for k, v in spec_runs.items()}
    print(f"[serve-sampling] {card}: {json.dumps(sampling)}", flush=True)
    verify = {k: sum(r[k] for r in spec_runs.values())
              for k in ("verify_launches", "verify_replayed_launches")}
    return runs, verify


class VerifyProbe:
    """Counts the chunk kernel's launches inside a speculative engine's
    verify pass (``prefill_chunk_paged(all_logits=True)``, which only the
    verify calls), replay-aware: the counter's delta over every eager call
    (warm-ups, captures, eager steps) plus, per graph, its replays x the
    delta over the call that its capture recorded."""

    def __init__(self, eng):
        from repro_torch.models import transformer
        from repro_torch.serving.graphs import WARMUP_STEPS, launch_counts

        self.transformer, self.eng = transformer, eng
        self.fn = fn = transformer.prefill_chunk_paged
        self.calls, self.per_capture = [], {}

        def counted():
            return sum(n for (k, _), n in launch_counts().items()
                       if k == "paged_prefill_attention")

        def verify_counted(*args, **kw):
            if not kw.get("all_logits"):
                return fn(*args, **kw)
            n = counted()
            out = fn(*args, **kw)
            self.calls.append(counted() - n)
            return out

        transformer.prefill_chunk_paged = verify_counted
        graphs = eng.graphs
        if graphs is not None:
            capture = graphs.capture

            def capture_counted(key):
                n = len(self.calls)
                capture(key)
                check(len(self.calls) == n + WARMUP_STEPS + 1,
                      f"verify probe: {len(self.calls) - n} verify passes "
                      f"in the capture of {key}")
                self.per_capture[key] = self.calls[-1]

            graphs.capture = capture_counted

    def close(self):
        self.transformer.prefill_chunk_paged = self.fn

    def launches(self, layers: int, steps: int) -> tuple[int, int]:
        """The run's verify launches and the replays' part of them; checks
        one launch per target layer in every verify pass and one replayed
        verify per step."""
        replays = self.eng.graphs.replays if self.eng.graphs else {}
        check(all(n == layers for n in self.calls)
              and all(n == layers for n in self.per_capture.values()),
              f"verify passes launched {sorted(set(self.calls))} chunk "
              f"kernels (captures {self.per_capture}), not {layers}")
        replayed = sum(self.per_capture[k] * n for k, n in replays.items())
        check(replayed == steps * layers,
              f"verify launches in replays {replayed} != {steps} steps x "
              f"{layers} layers")
        return sum(self.calls) + replayed, replayed


def graph_edge_types(graph) -> dict:
    """{dependency type: edges} of a captured CUDA graph, read with
    libcuda's cuGraphGetEdges_v2 (type 0: full dependency, 1:
    programmatic, as a programmatic dependent launch is captured).
    ``graph`` must have been made with keep_graph=True."""
    import ctypes
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    cap = 1 << 16
    frm, to = (ctypes.c_void_p * cap)(), (ctypes.c_void_p * cap)()
    data = (ctypes.c_ubyte * (8 * cap))()       # CUgraphEdgeData: 8 bytes
    n = ctypes.c_size_t(cap)
    rc = fn(graph.raw_cuda_graph(), frm, to, data, ctypes.byref(n))
    check(rc == 0 and n.value < cap, f"cuGraphGetEdges_v2: error {rc}, "
          f"{n.value} edges")
    types = {}
    for i in range(n.value):
        t = data[8 * i + 2]                    # from_port, to_port, type
        types[t] = types.get(t, 0) + 1
    return types


# phase 14's new tokens a request on the static path, and the depth at
# which its tokens are held (at full depth the random weights amplify
# bf16 rounding until the fp32 reading no longer tells the bf16 paths
# apart: mamba2's prompt logits 0.057 from it at 4 layers, 0.19 at 8,
# 0.33 at 16, logit std 0.56). zamba2 is held over one 6-layer period:
# at two (12 layers) the two paths' distances from the reading sum to
# 0.81 (0.43 at 6; logit std 0.89), and a stream parted between two
# tokens 0.11 and 0.23 below the reading's best with five others above
# them, which the two-token rule cannot hold (NVIDIA H100 80GB HBM3,
# 700.00 W). The CPU tests hold two periods.
STATIC_SSM_NEW = 32
STATIC_SSM_HELD_LAYERS = {"mamba2_370m": 4, "zamba2_2p7b": 6}


def static_ssm(torch, counters, card, arch, params, cfg, prompts,
               toks) -> list:
    """Phase 14 on phase 5's weights and 512-token prompts: the static
    path at full width and depth (``static_vs_engine``: its tok/s, prefill
    and decode step time, launches, its prompt logits and the engine
    path's against the fp32 reading, the static one at most twice as far;
    tokens counted against the engine run's ``toks``), then the same at
    STATIC_SSM_HELD_LAYERS (the first layers of the same weights) against
    an eager engine run there, tokens held to the near-tie rule."""
    import dataclasses
    from repro_torch.serving import InferenceEngine, Request
    out = []
    full = static_vs_engine(
        torch, counters, params, cfg, prompts, STATIC_SSM_NEW, toks,
        f"{arch} full width, {cfg.num_layers} layers, 8 x 512 (phase 14)",
        tokens_held=False)
    full.update(arch=arch, phase=14, layers=cfg.num_layers)
    out.append(full)
    n = STATIC_SSM_HELD_LAYERS[arch]
    cut = dataclasses.replace(cfg, num_layers=n)
    cut_params = dict(params, layers=params["layers"][:n])
    eng = InferenceEngine(cut, params=cut_params, cuda_graphs=False,
                          device=DEV, max_batch=8, block_size=16,
                          max_len=1024, max_num_batched_tokens=8 + 256,
                          seed=0)
    reqs = [Request(p.copy(), max_new=STATIC_SSM_NEW) for p in prompts]
    got = eng.run(reqs)
    ref = [got[r.rid].tolist() for r in reqs]
    del eng
    held = static_vs_engine(
        torch, counters, cut_params, cut, prompts, STATIC_SSM_NEW, ref,
        f"{arch} full width, {n} layers, 8 x 512 (phase 14, tokens held)")
    held.update(arch=arch, phase=14, layers=n)
    out.append(held)
    for r in out:
        print(f"[static-ssm] {card}: {arch} {r['layers']} layers: "
              f"{json.dumps(r)}", flush=True)
    return out
SSM_RUNS = (("mamba2_370m", "512", 32), ("mamba2_370m", "300-500", 16),
            ("zamba2_2p7b", "512", 16))


def serve_ssm(torch, counters, card, runs=SSM_RUNS, static=True):
    """Phase 5: mamba2_370m (SSMRunner) and zamba2_2p7b (HybridRunner)
    at full width and depth, random bf16 weights from seed 0, max_batch 8,
    a 264-token budget (256-token chunks, the SSD chunk size). mamba2
    serves 8 requests of 512 tokens (32 new each), then 8 of 300-500
    tokens (16 new each: a 256-token chunk, then a final exempt one);
    zamba2 serves 8 of 512 tokens (16 new each). Each run on graphs, then
    eager (A/B). The ssd kernel launches once per mamba layer and chunk;
    the chunk graph's edges by type say whether its capture kept the
    scan's programmatic dependent launches. Phase 14 (``static``) follows
    each 512-token run on its weights: the static path
    (``static_vs_engine``) on the same prompts, STATIC_SSM_NEW new tokens,
    held against the engine run's tokens (its first ones for zamba2)."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    results = []
    kw = dict(device=DEV, max_batch=8, block_size=16, max_len=1024,
              max_num_batched_tokens=8 + 256, seed=0)
    params = params_cfg = None
    for arch, lens, max_new in runs:
        cfg = get_config(arch)
        if params_cfg != cfg:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            params, params_cfg = init_model(cfg, 0, DEV), cfg
            torch.cuda.synchronize()
            init_s = time.monotonic() - t0
        seen = {}

        def make_engine(graphs, cfg=cfg, seen=seen):
            eng = InferenceEngine(cfg, params=params, cuda_graphs=graphs,
                                  **kw)
            check(eng.chunk_width == 256 == eng.sched.chunk_quantum,
                  f"chunk width {eng.chunk_width}, quantum "
                  f"{eng.sched.chunk_quantum}")
            seen["runner"] = type(eng.runner).__name__
            if graphs:
                capture = eng.graphs.capture

                def inspected(key):
                    capture(key)
                    if key[0]:
                        seen["edges"] = graph_edge_types(
                            eng.graphs.graphs[key])
                eng.graphs.capture = inspected
            return eng

        rng = np.random.default_rng(0)
        n_tok = ([512] * 8 if lens == "512"
                 else rng.integers(300, 501, 8).tolist())
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in n_tok]
        expect = ["ssd", "gather"]
        if cfg.shared_attn_period:
            expect += ["paged_attention", "paged_prefill_attention"]
        res, eager, toks = serve_ab(
            torch, counters, card, f"{arch} prompts of {lens} tokens",
            make_engine,
            lambda: [Request(p.copy(), max_new=max_new) for p in prompts],
            max_new, expect)
        n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
        for r in (res, eager):
            check(r["prefill_chunks"] == 2 * len(prompts),
                  f"{arch}: {r['prefill_chunks']} chunks, not 2 per prompt")
        check(eager["launches"]["ssd"] == n_mamba * eager["prefill_chunks"],
              f"{arch} eager: ssd launched {eager['launches']['ssd']} "
              f"times, not {n_mamba} layers x {eager['prefill_chunks']} "
              "chunks")
        check(res["replayed_launches"]["ssd"]
              == n_mamba * res["prefill_chunks"],
              f"{arch}: ssd replayed {res['replayed_launches']['ssd']} "
              f"times, not {n_mamba} layers x {res['prefill_chunks']} chunks")
        res.update(arch=arch, prompt_tokens=lens, requests=len(prompts),
                   params=cfg.param_count(), init_s=init_s,
                   runner=seen["runner"], eager=eager,
                   chunk_graph_edges_by_type=seen["edges"])
        print(f"[serve-ssm] {card}: {arch} full width, {cfg.num_layers} "
              f"layers ({res['params'] / 1e9:.2f} B params), "
              f"{res['runner']}, prompts of {lens} tokens, CUDA graphs: "
              f"{res['tok_s']} tok/s, decode step "
              f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, TTFT median "
              f"{res['ttft_s_median']:.3f} s, token gap median "
              f"{1e3 * res['token_gap_s_median']:.2f} ms, slot state "
              f"{res['slot_state_mib']} MiB, KV "
              f"{res['kv_cache_mib'] - res['slot_state_mib']:.3f} MiB, peak "
              f"{res['peak_mem_gib']:.2f} GiB, ssd launches "
              f"{res['launches']['ssd']} ({res['replayed_launches']['ssd']} "
              f"in replays); chunk graph edges by type (0 full, 1 "
              f"programmatic) {seen['edges']}: {json.dumps(res)}",
              flush=True)
        results.append(res)
        if lens == "512" and static:
            results += static_ssm(torch, counters, card, arch, params,
                                  cfg, prompts, toks)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 10: the rest of the dense family at full width
# ---------------------------------------------------------------------------

# phase 3's traffic (8 prompts of 512 tokens sharing a 256-token prefix,
# 32 new each) through each member; gemma2 also serves two 6000-token
# prompts, past its 4096-key window
LONG_PROMPT, LONG_REQUESTS = 6000, 2
def check_fits(torch, arch, cfg) -> None:
    """Fail, with the card's memory reading, if ``cfg``'s bf16 weights
    and the serving runner's fp32 head do not fit the free memory."""
    free, total = torch.cuda.mem_get_info()
    need = 2 * cfg.param_count() + 4 * cfg.padded_vocab_size * cfg.d_model
    check(need < free, f"{arch}: {cfg.num_layers} layers need "
          f"{need / 2 ** 30:.1f} GiB of bf16 weights and fp32 head; the "
          f"card has {free / 2 ** 30:.1f} GiB free of {total / 2 ** 30:.1f}")


# query rows per block of the fp32 reading's attention
FP32_ROWS = 512


def fp32_logits(torch, params, cfg, tokens, head, positions=None,
                groups=1, before=None):
    """The last position's logits (B, V_pad) of the same bf16 weights
    computed in fp32: the bf16 embedding's output cast up, each layer's
    weights cast up in turn (one layer's fp32 copy alive at a time),
    activations in fp32, attention by the plain ``dense_attention`` in fp32
    (FP32_ROWS query rows at a time), the fp32 head. Neither the flash nor
    a paged kernel takes part: an independent reading of the function both
    serving paths compute in bf16. ``positions``: (3, B, S) M-RoPE planes
    (default: 0 .. S - 1). Mamba layers scan with the plain
    ``ssd_chunked`` in fp32. ``groups`` > 1 reads the sequences in that many
    groups (a MoE model without drops: each token's output does not
    depend on the others', and the dispatch shrinks with T). ``before(i0,
    i1)`` runs before the reading of sequences i0 .. i1 - 1."""
    if groups > 1 or before is not None:
        n = -(-tokens.shape[0] // groups)
        out = []
        for i in range(0, tokens.shape[0], n):
            j = min(i + n, tokens.shape[0])
            if before is not None:
                before(i, j)
            out.append(fp32_logits(
                torch, params, cfg, tokens[i:j], head,
                None if positions is None else positions[:, i:j]))
        return torch.cat(out)
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.attention import (attention_scale,
                                              dense_attention, project_kv,
                                              project_q)
    from repro_torch.models.embedding import decode_logits, embed
    from repro_torch.models.transformer import _layers, _rope

    def up(t):
        return ({n: up(v) for n, v in t.items()} if isinstance(t, dict)
                else t.float())

    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg).float()
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    cos_sin = _rope(cfg, positions)

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        return torch.cat([dense_attention(
            q[:, r:r + FP32_ROWS], k[:, :r + FP32_ROWS],
            v[:, :r + FP32_ROWS], causal=True, window=window,
            cap=cfg.attn_logit_softcap, scale=attention_scale(cfg),
            q_offset=r) for r in range(0, S, FP32_ROWS)], dim=1)

    def mamba(mp, h, m):
        with plain_ssd():
            return ssm_mod.mamba_block(mp, h, cfg)[0]

    fp = {"layers": (up(lp) for lp in params["layers"]),
          "final_norm": up(params["final_norm"])}
    if "shared" in params:
        fp["shared"] = up(params["shared"])
    x = _layers(fp, {}, cfg, x, attend, mamba)
    return decode_logits(x[:, -1:], head, cfg)


@contextlib.contextmanager
def plain_ssd():
    """``kernels.ops.ssd`` as the plain ``ssd_chunked`` on any device,
    inside the block: the fp32 reading's scan (the kernel takes bf16
    x only, and the reading is to be independent of it)."""
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import ssd_chunked
    kernel = ops.ssd
    ops.ssd = lambda x, dt, A, B, C, *, chunk, h0=None: ssd_chunked(
        x, dt, A, B, C, chunk=chunk, h0=h0)
    try:
        yield
    finally:
        ops.ssd = kernel


def static_vs_engine(torch, counters, params, cfg, prompts, max_new, ref,
                     label, groups=1, routes=None, tokens_held=True) -> dict:
    """The static path (``api.generate_static``: the flash kernel for the
    prefill's attention and the ssd kernel for its mamba layers, plain
    decode attention and recurrence over dense caches) on the same
    prompts; ``ref`` may hold fewer tokens a request than ``max_new``
    (the first ones are compared). Both paths' logits after each prompt (the static prefill's;
    the engine path's, one paged chunk) are held against the fp32 reading
    (``fp32_logits``): the static path may be at most twice as far from it
    as the engine path (a wrong flash prefill would be far from it; the
    two bf16 paths' rounding, amplified over the layers, is what both
    show). Its greedy tokens then equal the engine's ``ref`` tokens, or
    part at a near-tie: a top-2 margin below the sum of the two paths'
    measured distances from the fp32 reading (the largest gap those
    readings allow between them), or TOL if that is larger. ``routes``
    (a MoE model: the engine run's recorded ``RouteLog``) is replayed in
    every run here (the static path, each reading), so that all route
    each row as the engine did: bf16 rounding, which the paths do at
    other places, sends some rows to other experts, and a row's output
    then moves by far more than a rounding. The readings are also taken
    without the replay (not held to anything). Counts its flash launches.
    ``groups``: see ``fp32_logits``. With ``tokens_held`` off the tokens
    are compared and counted, not held (a depth where the fp32 reading no
    longer tells the bf16 paths apart). Returns the readings."""
    import numpy as np
    from repro_torch.models import api
    from repro_torch.models.embedding import head_table
    from repro_torch.models.transformer import layer_counts, prefill_logits

    V = cfg.vocab_size
    head = head_table(params["embed"], cfg).float()
    tokens = torch.from_numpy(np.stack(prompts)).to(DEV)
    B, S = tokens.shape
    log = routes if routes is not None else RouteLog()
    prefill, decode, step, walls = api.prefill_fn, api.decode_fn, [0], []

    def walled(fn, *a, **kw):
        t0 = time.monotonic()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        return out

    def logged_prefill(*a, **kw):
        log.step({B * S: seq_rows(range(B), S)})
        return walled(prefill, *a, **kw)

    def logged_decode(*a, **kw):
        step[0] += 1
        log.step({B: [(b, b, S + step[0] - 1) for b in range(B)]})
        return walled(decode, *a, **kw)

    def readings():
        """(static prefill, engine path, fp32) logits after the prompts."""
        log.step({B * S: seq_rows(range(B), S)})
        static = prefill_logits(params, {"tokens": tokens}, cfg,
                                head)[1][:, :V]
        engine = []
        for n, p in enumerate(prompts):
            log.step({len(p): seq_rows([n], len(p))})
            engine.append(last_logits(torch, params, cfg, p, "bf16",
                                      device=DEV))
        t0 = time.monotonic()
        exact = fp32_logits(torch, params, cfg, tokens, head, groups=groups,
                            before=lambda i, j: log.step(
                                {(j - i) * S: seq_rows(range(i, j), S)}))
        torch.cuda.synchronize()
        return static, torch.stack(engine), exact[:, :V], \
            time.monotonic() - t0

    own = {}
    if routes is not None:
        with torch.no_grad():
            static, engine, exact, _ = readings()
        own = {"fp32_err_static_own_routing": err(static, exact),
               "fp32_err_engine_own_routing": err(engine, exact)}
        del static, engine, exact
    replay = routes.replay() if routes is not None \
        else contextlib.nullcontext()
    counts = []

    def count():
        if routes is not None:
            counts.append((routes.replayed, routes.rerouted))

    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad(), replay:
        api.prefill_fn, api.decode_fn = logged_prefill, logged_decode
        try:
            count()
            out = api.generate_static(params, tokens, cfg, max_new,
                                      head=head)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            count()
        finally:
            api.prefill_fn, api.decode_fn = prefill, decode
        launches = read_launches(counters)
        static, engine, exact, fp32_s = readings()
        count()
        e_static, e_engine = err(static, exact), err(engine, exact)
        delta = err(static, engine)
        std = float(exact.std())
        n_attn, n_mamba = layer_counts(cfg)
        flash = sum(n for k, n in launches.items()
                    if k.startswith("flash_attention"))
        check(flash == n_attn and launches.get("ssd", 0) == n_mamba,
              f"{label}: static prefill made {flash} flash launches and "
              f"{launches.get('ssd', 0)} ssd launches, not {n_attn} and "
              f"{n_mamba} (one per attention application and mamba layer)")
        check(e_static <= 2 * e_engine,
              f"{label}: the static prefill's logits are {e_static:.4g} "
              f"from the fp32 reading, more than twice the engine path's "
              f"{e_engine:.4g}")
        limit = max(TOL, e_static + e_engine)
        margins = []
        if tokens_held:
            same = [near_tie_or_same(
                torch, params, cfg, p, o.tolist()[:len(r)], r, limit,
                margins, lambda m, n=n: log.step({m: seq_rows([n], m)}))
                for n, (p, o, r) in enumerate(zip(prompts, out.cpu(), ref))]
        else:
            same = [o.tolist()[:len(r)] == r for o, r in zip(out.cpu(), ref)]
        count()
    del head
    res = {"wall_s": wall, "tok_s": B * max_new / wall,
           "prefill_s": walls[0],
           "decode_step_ms_mean": 1e3 * statistics.mean(walls[1:]),
           "identical": sum(same), "requests": len(same),
           "margins": margins, "logit_delta": delta,
           "fp32_err_static": e_static, "fp32_err_engine": e_engine,
           "fp32_logit_std": std, "fp32_s": fp32_s, "launches": launches,
           **own}
    extra = ""
    if routes is not None:
        (a0, b0), (a1, b1), (a2, b2), (a3, b3) = counts
        res["rerouted_rows"] = {"static_path": [b1 - b0, a1 - a0],
                                "readings": [b2 - b1, a2 - a1],
                                "near_tie_readings": [b3 - b2, a3 - a2]}
        extra = (f"; every run routing each row as the engine run did "
                 f"(rows whose own choice differed, of those replayed: "
                 f"{res['rerouted_rows']}; without the replay, static "
                 f"{own['fp32_err_static_own_routing']:.4g} and engine "
                 f"{own['fp32_err_engine_own_routing']:.4g} from the fp32 "
                 "reading)")
    print(f"[static] {label}: generate_static (prefill through the flash "
          f"and ssd kernels, {max_new - 1} decode steps) in {wall:.2f} s "
          f"({res['tok_s']:.1f} tok/s; prefill {res['prefill_s']:.3f} s, "
          f"decode step {res['decode_step_ms_mean']:.2f} ms); logits "
          f"after the prompts: max abs distance from the fp32 reading "
          f"(std {std:.4g}, {fp32_s:.1f} s) static {e_static:.4g}, engine "
          f"{e_engine:.4g}; static vs engine {delta:.4g}; "
          f"{sum(same)}/{len(same)} requests token-identical to the engine, "
          f"the rest part at a near-tie: (step, top-2 margin, limit) "
          f"{margins}{extra}", flush=True)
    return res


# the numbers of a serving run that phase 10's summary line carries
BRIEF = ("tok_s", "wall_s", "steps", "tokens", "decode_step_ms_mean",
         "decode_body_device_ms_mean", "chunk_step_ms_mean",
         "chunk_body_device_ms_mean", "busy_share_events",
         "busy_share_from_graph_device_ms", "ttft_s_median", "ttft_s_max",
         "token_gap_s_median", "token_gap_s_max", "peak_mem_gib",
         "graph_pool_mib", "capture_s", "decode_floor_ms", "kv_cache_mib",
         "cache_hit_tokens", "prefill_chunks", "most_chunks_in_a_step",
         "launches", "replayed_launches", "identical", "requests",
         "margins", "logit_delta", "fp32_err_static", "fp32_err_engine",
         "fp32_logit_std")


def brief(runs: dict) -> dict:
    return {k: {n: v for n, v in r.items() if n in BRIEF}
            for k, r in runs.items()}


def serve_family(torch, counters, card, rows) -> list:
    """Phase 10: qwen3_32b, gemma2_27b and starcoder2_3b at full width
    and depth (failing if one does not fit the card), random weights from
    seed 0, one at a time, each freed before the next: phase 3's traffic
    on CUDA graphs and eager (byte-identical tokens), the static path on
    the same prompts (logits held against an fp32 reading, tokens == the
    engine's up to a near-tie; ``static_vs_engine``), a prefill_pack 4 run
    of the same prompts (4 new tokens, the packed kernel; == the first 4
    of the pack-1 run up to a near-tie below twice the engine path's
    distance from the fp32 reading); gemma2 also serves two 6000-token prompts the same
    three ways. Each member's launches per kernel go into the kernels'
    rows (``<member>_launches``). Returns the runs."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    runs = []
    for name in ("qwen3", "gemma2", "starcoder2"):
        arch = FAMILY[name][0]
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        check_fits(torch, arch, cfg)
        t0 = time.monotonic()
        params = init_model(cfg, 0, DEV)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        rng = np.random.default_rng(0)
        prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
        prompts = [np.concatenate(
            [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)])
            for _ in range(8)]
        traffic = [("8x512", prompts, 8, 1024, 32)]
        if name == "gemma2":
            traffic.append(("2x6000", [
                rng.integers(0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
                for _ in range(LONG_REQUESTS)], LONG_REQUESTS,
                LONG_PROMPT + 48, 32))
        member = {"arch": arch, "layers": cfg.num_layers,
                  "params": cfg.param_count(), "init_s": init_s}
        launches, replayed = {}, {}
        for label, ps, batch, max_len, max_new in traffic:
            def make_engine(graphs, batch=batch, max_len=max_len, pack=1):
                # phase 3's 256-row chunk row, phase 4's 512 when packed
                return InferenceEngine(
                    cfg, device=DEV, params=params, max_batch=batch,
                    block_size=16, max_len=max_len,
                    max_num_batched_tokens=batch + (256 if pack == 1
                                                    else 512), seed=0,
                    prefill_pack=pack, cuda_graphs=graphs)

            def make_reqs(ps=ps, max_new=max_new):
                return [Request(p.copy(), max_new=max_new) for p in ps]

            tag = f"{arch} {label}"
            g, e, toks = serve_ab(torch, counters, card, tag, make_engine,
                                  make_reqs, max_new,
                                  ("paged_attention",
                                   "paged_prefill_attention", "gather"))
            static = static_vs_engine(torch, counters, params, cfg, ps,
                                      max_new, toks, tag)
            eng = make_engine(True, pack=4)
            packed, ptoks = serve(torch, counters, eng, make_reqs(max_new=4),
                                  4, ("ragged_paged_prefill_attention",
                                      "paged_attention", "gather"))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            check(packed["most_chunks_in_a_step"] >= 2,
                  f"{tag}: no step carried two packed chunks")
            # two engine paths, each the engine's distance from the fp32
            # reading: they part only at a margin below twice that
            limit = max(TOL, 2 * static["fp32_err_engine"])
            margins = []
            packed["identical"] = sum(
                near_tie_or_same(torch, params, cfg, p, o, r[:4], limit,
                                 margins)
                for p, o, r in zip(ps, ptoks.values(), toks))
            packed["requests"], packed["margins"] = len(ps), margins
            print(f"[serve-family] {tag}: pack 4's 4 tokens == pack 1's "
                  f"first 4 on {packed['identical']}/{len(ps)} requests, the "
                  f"rest part at a near-tie: (step, top-2 margin, limit) "
                  f"{margins}", flush=True)
            for r in (g, e, static, packed):
                for k, n in r["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            runs += [g, e, static, packed]
            for k, n in g["replayed_launches"].items():
                replayed[k] = replayed.get(k, 0) + n
            for k, n in packed["replayed_launches"].items():
                replayed[k] = replayed.get(k, 0) + n
            member[label] = {"graphs": g, "eager": e, "static": static,
                             "packed": packed}
            print(f"[serve-family] {card}: {tag}: {cfg.num_layers} layers "
                  f"({cfg.param_count() / 1e9:.2f} B params), CUDA graphs "
                  f"{g['tok_s']} tok/s (eager {e['tok_s']}), decode step "
                  f"{g['decode_step_ms_mean']:.2f} ms (device "
                  f"{g['decode_body_device_ms_mean']:.2f}; bytes floor "
                  f"{g['decode_floor_ms']:.2f}), chunk step "
                  f"{g['chunk_step_ms_mean']:.2f} ms, busy share "
                  f"{g['busy_share_events']:.3f}, TTFT median "
                  f"{g['ttft_s_median']:.3f} s, peak {g['peak_mem_gib']:.2f} "
                  f"GiB; pack 4: {packed['tok_s']} tok/s: "
                  f"{json.dumps(brief(member[label]))}", flush=True)
        for kernel in FAMILY_KERNELS:
            rows[kernel][name + "_launches"] = launches.get(kernel, 0)
            rows[kernel][name + "_replayed_launches"] = replayed.get(kernel,
                                                                     0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 12: mixture of experts, the encoder-decoder and M-RoPE at full width
# ---------------------------------------------------------------------------

# the kernels of each member's serving path, whose rows carry its launches
SLICE_KERNELS = ("paged_attention", "paged_prefill_attention",
                 "ragged_paged_prefill_attention", "flash_attention",
                 "flash_attention_wgmma64", "gather")
# grok-1's depth on one card: 4 of its 64 layers (9.8 GB of bf16 each)
GROK_LAYERS = 4
# phase 12a's qwen3_moe depth: 24 of its 48 layers (cut for the whole
# run's time limit, since phase 18)
MOE_LAYERS = 24
# qwen3_moe's static path against the engine (12a). At all 48 layers the
# two bf16 paths lie as far from the fp32 reading as from each other,
# even with the routing replayed: the random expert weights (fan-in E, as
# the reference draws them) amplify rounding from layer to layer
MOE_STATIC_LAYERS = 4


def phase3_traffic(cfg, seed=0):
    """Phase 3's prompts: 8 of 512 tokens sharing a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)])
        for _ in range(8)]


def member_launches(rows, name, runs) -> None:
    """A member's launches per kernel, replay-aware, into the rows."""
    for kernel in SLICE_KERNELS:
        if kernel in rows:
            rows[kernel][name + "_launches"] = sum(
                r["launches"].get(kernel, 0) for r in runs)
            rows[kernel][name + "_replayed_launches"] = sum(
                r.get("replayed_launches", {}).get(kernel, 0) for r in runs)


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def report(card, tag, cfg, g, e=None, extra="") -> None:
    print(f"[serve-slice] {card}: {tag}: {cfg.num_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B params), CUDA graphs "
          f"{g['tok_s']} tok/s"
          + (f" (eager {e['tok_s']})" if e is not None else "")
          + f", decode step {g['decode_step_ms_mean']:.2f} ms (device "
          f"{g['decode_body_device_ms_mean']:.2f}; bytes floor "
          f"{g['decode_floor_ms']:.2f}), chunk step "
          f"{g['chunk_step_ms_mean']:.2f} ms (device "
          f"{g['chunk_body_device_ms_mean']:.2f}), busy share "
          f"{g['busy_share_events']:.3f}, TTFT median "
          f"{g['ttft_s_median']:.3f} s, peak {g['peak_mem_gib']:.2f} GiB"
          f"{extra}: {json.dumps({k: v for k, v in g.items() if k in BRIEF})}",
          flush=True)


def moe_card_vs_cpu(torch, params, cfg, T: int = 256) -> dict:
    """Layer 0's MoE block at full width on T random tokens: on the card
    and on the CPU in fp32 (the card's sort, dispatch and gathers against
    the CPU's; fp32 products, no TF32), within 1e-4 of the output's
    largest value; and how often bf16 activations route otherwise than
    fp32 ones (the share of (token, expert) choices that differ, and the
    top-k boundary gaps below 1e-3), which is what parts two bf16 paths."""
    from repro_torch.models import moe

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    x = torch.randn((T, cfg.d_model), generator=gen, device=DEV)
    p = {k: v.float() for k, v in params["layers"][0]["moe"].items()}
    with torch.no_grad():
        y_card = moe.moe_local(x, p, cfg)
        y_cpu = moe.moe_local(x.cpu(), {k: v.cpu() for k, v in p.items()},
                              cfg)
        rel = err(y_card.cpu(), y_cpu) / float(y_cpu.abs().max())
        k = cfg.moe.experts_per_token
        _, i32, probs = moe._route(x, p["router"], k)
        _, i16, _ = moe._route(x.bfloat16(), p["router"].bfloat16(), k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps = srt[:, k - 1] - srt[:, k]
        same = (torch.sort(i32, dim=-1).values
                == torch.sort(i16, dim=-1).values).all(-1)
    check(rel <= 1e-4, f"{cfg.name}: the MoE block on the card is {rel:.3g} "
          "(of its largest value) from the CPU's in fp32")
    res = {"fp32_rel_err": rel, "tokens_routed_alike": float(
        same.float().mean()), "gaps_below_1e-3": float(
        (gaps < 1e-3).float().mean()), "median_gap": float(gaps.median())}
    print(f"[serve-slice] {cfg.name}: layer 0's MoE block, card vs CPU in "
          f"fp32 over {T} tokens: {rel:.3g} of the largest value; bf16 "
          f"activations route {res['tokens_routed_alike']:.3f} of the tokens "
          f"as fp32 ones do (top-k boundary gap median "
          f"{res['median_gap']:.3g}, {res['gaps_below_1e-3']:.3f} below "
          "1e-3)", flush=True)
    return res


def serve_moe(torch, counters, card, rows) -> list:
    """12a qwen3_moe_30b_a3b (MOE_LAYERS of 48) and 12b grok1_314b
    (GROK_LAYERS of 64), random weights from seed 0, one at a time."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    runs = []
    for name, arch, layers, max_new in (("qwen3_moe", "qwen3_moe_30b_a3b",
                                         MOE_LAYERS, 32),
                                        ("grok1", "grok1_314b", GROK_LAYERS,
                                         16)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        free(torch)
        check_fits(torch, arch, cfg)
        t0 = time.monotonic()
        params = init_model(cfg, 0, DEV)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        prompts = phase3_traffic(cfg)
        tag = f"{arch} 8x512 ({cfg.num_layers} layers)"

        def make_engine(graphs, pack=1, kv="bf16", c=cfg):
            # phase 3's 256-row chunk row, phase 4's 512 when packed
            return InferenceEngine(
                c, device=DEV, params=params, max_batch=8, block_size=16,
                max_len=1024, max_num_batched_tokens=8 + (256 if pack == 1
                                                          else 512),
                seed=0, prefill_pack=pack, kv_dtype=kv, cuda_graphs=graphs)

        def make_reqs(n=max_new):
            return [Request(p.copy(), max_new=n) for p in prompts]

        g, e, toks = serve_ab(torch, counters, card, tag, make_engine,
                              make_reqs, max_new,
                              ("paged_attention", "paged_prefill_attention",
                               "gather"), profile=True)
        mine = [g, e]
        report(card, tag, cfg, g, e, f"; init {init_s:.1f} s")
        g["moe_check"] = moe_card_vs_cpu(torch, params, cfg)
        if name == "qwen3_moe":
            # packed prefill over int8 pools: the MoE block at T = 512
            eng = make_engine(True, pack=4, kv="int8")
            packed, _ = serve(torch, counters, eng, make_reqs(4), 4,
                              ("ragged_paged_prefill_attention_int8",
                               "paged_attention_int8", "gather"))
            del eng
            free(torch)
            check(packed["most_chunks_in_a_step"] >= 2,
                  f"{tag}: no step carried two packed chunks")
            report(card, f"{tag} int8 pack 4", cfg, packed)
            # the static path at capacity factor 16 (no drops, so neither
            # path's tokens depend on how the other batches them) and
            # MOE_STATIC_LAYERS layers: an eager engine run recording its
            # routing (no prefix caching, so every request routes its own
            # rows), then the static path on the same prompts, every run
            # replaying that routing
            cfg16 = dataclasses.replace(
                cfg, num_layers=MOE_STATIC_LAYERS, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=16.0))
            p16 = dict(params, layers=params["layers"][:MOE_STATIC_LAYERS])
            eng = InferenceEngine(
                cfg16, device=DEV, params=p16, max_batch=8, block_size=16,
                max_len=1024, max_num_batched_tokens=8 + 256, seed=0,
                cuda_graphs=False, enable_prefix_caching=False)
            routes, reqs = RouteLog(), make_reqs(8)
            routes.follow_engine(eng, reqs)
            with routes.record():
                r16, t16 = serve(torch, counters, eng, reqs, 8,
                                 ("paged_attention",
                                  "paged_prefill_attention"))
            del eng
            free(torch)
            static = static_vs_engine(
                torch, counters, p16, cfg16, prompts, 8,
                [t16[r.rid] for r in reqs],
                f"{arch} 8x512 ({MOE_STATIC_LAYERS} of 48 layers) cf 16",
                groups=2, routes=routes)
            del routes, p16
            mine += [packed, r16, static]
        member_launches(rows, name, mine)
        runs += mine
        del params
        free(torch)
    return runs


def encdec_logits(torch, params, cfg, frames, tokens):
    """fp32 logits (V,) after ``tokens`` of one whisper request on the
    card, by one monolithic paged chunk against its encoded frames."""
    from repro_torch.models import encdec
    from repro_torch.serving.runners import make_runner

    n = len(tokens)
    nb = -(-n // 16)
    runner = make_runner(cfg)
    cache = runner.init_cache(nb + 1, 16, 1, DEV)
    runner.encode(params, cache, 0, frames)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                 device=DEV)
    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = encdec.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def encdec_near_tie(torch, params, cfg, frames, prompt, ours, ref, label,
                    margins) -> bool:
    """Equal streams (True), or a first difference at a top-2 margin
    below TOL on the card's reading (``encdec_logits``) (False)."""
    import numpy as np
    if ours == ref:
        return True
    i = next(j for j, (x, y) in enumerate(zip(ours, ref)) if x != y)
    lg = encdec_logits(torch, params, cfg, frames, np.concatenate(
        [prompt, np.asarray(ours[:i], np.int32)]))
    top = torch.topk(lg, 2)
    margin = float(top.values[0] - top.values[1])
    margins.append((i, margin))
    check(margin < TOL and {ours[i], ref[i]} == set(top.indices.tolist()),
          f"{label}: streams differ at step {i} with top-2 margin {margin}")
    return False


def serve_whisper(torch, counters, card, rows) -> list:
    """12c whisper_large_v3 (32 + 32 layers), random weights from seed 0:
    8 requests with distinct seeded frames (1500 x 1280) and 128-token
    prompts, 32 new tokens, on graphs and eager (byte-identical); the
    static path (``generate_static``) on the same requests (== the
    engine's tokens up to a near-tie); a pool of 41 blocks (each request
    needs 10) that preempts: encodes >= 8 + preemptions, tokens == the
    roomy run's up to a near-tie; the encode's device time."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import generate_static, init_model
    from repro_torch.serving import InferenceEngine, Request

    cfg = get_config("whisper_large_v3")
    free(torch)
    check_fits(torch, "whisper_large_v3", cfg)
    params = init_model(cfg, 0, DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
               for _ in range(8)]
    frames = [rng.normal(0, 1, (cfg.encoder_seq_len, cfg.d_model)).astype(
        np.float32) for _ in range(8)]
    max_new, tag = 32, "whisper_large_v3 8x128 + 1500 frames"

    def make_engine(graphs, num_blocks=None):
        return InferenceEngine(cfg, device=DEV, params=params, max_batch=8,
                               block_size=16, max_len=256,
                               num_blocks=num_blocks,
                               max_num_batched_tokens=8 + 256, seed=0,
                               cuda_graphs=graphs)

    def make_reqs():
        return [Request(p.copy(), max_new=max_new, frames=f)
                for p, f in zip(prompts, frames)]

    g, e, toks = serve_ab(torch, counters, card, tag, make_engine, make_reqs,
                          max_new, ("paged_attention",
                                    "paged_prefill_attention", "gather",
                                    "flash_attention_wgmma64"), profile=True)
    # the encode pass alone: one request's frames, CUDA events
    fr = torch.from_numpy(frames[0]).to(DEV, torch.bfloat16)[None]
    timer = Timer(torch)
    with torch.no_grad():
        encode_ms = timer(lambda: encdec.encode_cross_kv(params, fr, cfg),
                          iters=5)
    del timer
    report(card, tag, cfg, g, e, f"; encode {encode_ms:.2f} ms a request")
    g["encode_ms"] = encode_ms

    # the static path on the same requests
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        out = generate_static(
            params, torch.from_numpy(np.stack(prompts)).to(DEV), cfg,
            max_new, frames=torch.from_numpy(np.stack(frames)).to(
                DEV, torch.bfloat16))
    torch.cuda.synchronize()
    static = {"wall_s": time.monotonic() - t0,
              "launches": read_launches(counters)}
    check(static["launches"].get("flash_attention_wgmma64", 0)
          == cfg.encoder_layers + 2 * cfg.num_layers,
          f"{tag}: static prefill made "
          f"{static['launches'].get('flash_attention_wgmma64')} hd-64 flash "
          f"launches, not {cfg.encoder_layers + 2 * cfg.num_layers}")
    margins = []
    static["identical"] = sum(
        encdec_near_tie(torch, params, cfg, torch.from_numpy(f).to(
            DEV, torch.bfloat16), p, o.tolist(), r, f"{tag} static",
            margins)
        for p, f, o, r in zip(prompts, frames, out.cpu(), toks))
    static["margins"] = margins
    print(f"[static] {tag}: generate_static in {static['wall_s']:.2f} s; "
          f"{static['identical']}/8 requests token-identical to the engine, "
          f"the rest part at a near-tie: (step, top-2 margin) {margins}",
          flush=True)

    # a pool that preempts
    eng = make_engine(True, num_blocks=42)
    tight, ttoks = serve(torch, counters, eng, make_reqs(), max_new,
                         ("paged_attention", "paged_prefill_attention"))
    s = eng.stats
    check(s["preemptions"] >= 1, f"{tag}: the 41-block pool did not preempt")
    check(s["encodes"] >= 8 + s["preemptions"],
          f"{tag}: {s['encodes']} encodes for 8 requests and "
          f"{s['preemptions']} preemptions")
    tight.update(preemptions=s["preemptions"], encodes=s["encodes"])
    del eng
    free(torch)
    margins = []
    tight["identical"] = sum(
        encdec_near_tie(torch, params, cfg, torch.from_numpy(f).to(
            DEV, torch.bfloat16), p, o, r, f"{tag} preempted", margins)
        for p, f, o, r in zip(prompts, frames, ttoks.values(), toks))
    tight["margins"] = margins
    print(f"[serve-slice] {card}: {tag}: 41 blocks: {s['preemptions']} "
          f"preemptions, {s['encodes']} encodes; {tight['identical']}/8 "
          f"requests token-identical to the roomy run, the rest part at a "
          f"near-tie {margins}; {tight['tok_s']} tok/s", flush=True)
    mine = [g, e, static, tight]
    member_launches(rows, "whisper", mine)
    del params
    free(torch)
    return mine


def mrope_positions(np, B: int, S: int, grid=(1, 16, 16)):
    """(3, B, S) int32: an image's t x h x w grid ids first, then text
    continuing past the grid's largest id on all three planes; sequence b
    shifted by b."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()])
    n = img.shape[1]
    pos = np.zeros((3, B, S), np.int32)
    for b in range(B):
        pos[:, b, :n] = img + b
        pos[:, b, n:] = np.arange(img.max() + 1, img.max() + 1 + S - n) + b
    return pos


def serve_vlm(torch, counters, card, rows) -> list:
    """12d qwen2_vl_2b (28 layers), static path, random weights from seed
    0: B 8 x S 512 with distinct M-RoPE planes (a 16 x 16 image grid, then
    text), 32 new tokens. Its prefill logits are held against the fp32
    reading at the same planes: closer to it than to the fp32 reading at
    1-D positions by a factor of 4, and the first token equal to the fp32
    reading's or at a top-2 margin below twice the distance."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import generate_static, init_model
    from repro_torch.models.embedding import head_table
    from repro_torch.models.transformer import prefill_logits

    cfg = get_config("qwen2_vl_2b")
    free(torch)
    check_fits(torch, "qwen2_vl_2b", cfg)
    params = init_model(cfg, 0, DEV)
    B, S, max_new = 8, 512, 32
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(DEV)
    pos = torch.from_numpy(mrope_positions(np, B, S)).to(DEV)
    head = head_table(params["embed"], cfg).float()
    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with torch.no_grad():
        out = generate_static(params, tokens, cfg, max_new, head=head,
                              positions=pos)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches(counters)
    check(launches.get("flash_attention", 0) == cfg.num_layers,
          f"qwen2_vl: static prefill made {launches.get('flash_attention')} "
          f"flash launches, not {cfg.num_layers}")
    V = cfg.vocab_size
    with torch.no_grad():
        static = prefill_logits(params, {"tokens": tokens, "positions": pos},
                                cfg, head)[1][:, :V]
        exact = fp32_logits(torch, params, cfg, tokens, head,
                            positions=pos)[:, :V]
        flat = fp32_logits(torch, params, cfg, tokens, head)[:, :V]
    e_static, e_planes = err(static, exact), err(flat, exact)
    check(4 * e_static < e_planes,
          f"qwen2_vl: the static prefill's logits are {e_static:.4g} from "
          f"the fp32 reading, not a quarter of the 1-D positions' "
          f"{e_planes:.4g}")
    top = torch.topk(exact, 2, dim=-1)
    first = out[:, 0].long()
    same = first == top.indices[:, 0]
    margin = top.values[:, 0] - top.values[:, 1]
    check(bool((same | ((margin < 2 * e_static) & (first == top.indices[
        :, 1]))).all()), f"qwen2_vl: first tokens {first.tolist()} vs the "
          f"fp32 reading's {top.indices[:, 0].tolist()} (margins "
          f"{margin.tolist()})")
    res = {"wall_s": wall, "tok_s": B * max_new / wall,
           "fp32_err_static": e_static, "fp32_err_1d_positions": e_planes,
           "first_tokens_equal": int(same.sum()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    print(f"[static] {card}: qwen2_vl_2b B={B} S={S} ({cfg.num_layers} "
          f"layers, M-RoPE planes distinct): generate_static, {max_new} new "
          f"tokens, in {wall:.2f} s ({res['tok_s']:.1f} tok/s); prefill "
          f"logits {e_static:.4g} from the fp32 reading (1-D positions "
          f"{e_planes:.4g}); {res['first_tokens_equal']}/{B} first tokens "
          f"== the fp32 reading's; peak {res['peak_mem_gib']:.2f} GiB",
          flush=True)
    member_launches(rows, "qwen2_vl", [res])
    del params, head
    free(torch)
    return [res]


def serve_slice(torch, counters, card, rows) -> list:
    """Phase 12: 12a-b (``serve_moe``), 12c (``serve_whisper``), 12d
    (``serve_vlm``), each part's wall time printed."""
    runs, t0 = [], time.monotonic()
    for part, fn in (("12a-b", serve_moe), ("12c", serve_whisper),
                     ("12d", serve_vlm)):
        runs += fn(torch, counters, card, rows)
        print(f"[time] phase {part}: {time.monotonic() - t0:.1f} s",
              flush=True)
        t0 = time.monotonic()
    return runs


# ---------------------------------------------------------------------------
# phase 11: abort, the host swap tier, the front end and the fleet
# ---------------------------------------------------------------------------

# 80 allocatable blocks: phase 3's traffic touches 16 + 8 x 18 = 160, and
# this pool swaps at least twice at pack 1 (at 100 blocks, once)
SWAP_BLOCKS = 81
SWAP_SPACE = 1 << 30
SHARED_SLOTS = 512              # the fleet's shared index: 320 MiB pinned
SWAP_KEYS = ("preemptions", "swap_preemptions", "swap_ins",
             "swapped_out_blocks", "swapped_in_blocks", "swapped_out_bytes",
             "swapped_in_bytes", "swap_d2h_s", "swap_h2d_s",
             "host_hit_blocks", "cache_hit_tokens", "swap_space_mib")


def phase3_prompts(cfg):
    """Phase 3's prompts: 8 of 512 tokens sharing a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)])
        for _ in range(8)]


def glm4_engine(params, graphs=True, pack=1, **kw):
    """glm4_9b at phase 3's settings (8 slots, 16-token blocks, 256-row
    chunks; 512 when packed)."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine
    return InferenceEngine(get_config("glm4_9b"), device=DEV, params=params,
                           max_batch=8, block_size=16, max_len=1024, seed=0,
                           max_num_batched_tokens=8 + 256 * pack,
                           prefill_pack=pack, cuda_graphs=graphs, **kw)


def fleet_launches(counters, engines) -> tuple[dict, dict]:
    """``run_launches`` over engines that share the kernels' counters."""
    total = read_launches(counters)
    replayed = {}
    for eng in engines:
        if eng.graphs is not None:
            for (kernel, key), n in eng.graphs.run_launches().items():
                name = summary_name(kernel, key)
                replayed[name] = replayed.get(name, 0) + n
                total[name] = total.get(name, 0) + n
    return total, replayed


def first_diff(a, b):
    """(request, step) of the first differing token of two lists of
    streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, next((j for j, (p, q) in enumerate(zip(x, y))
                            if p != q), min(len(x), len(y)))
    return None


def same_streams(label, got, want) -> None:
    d = first_diff(got, want)
    check(d is None and len(got) == len(want),
          f"{label}: tokens differ (request, step) {d}")


def brief_swap(runs: dict) -> dict:
    keys = ("tok_s", "steps", "decode_step_ms_mean", "chunk_step_ms_mean",
            "ttft_s_median", "token_gap_s_median", "peak_mem_gib",
            "link_yardstick", "d2h_ms_per_swap", "h2d_ms_per_swap_in",
            "d2h_gb_s", "h2d_gb_s") + SWAP_KEYS
    return {k: {n: r[n] for n in keys if n in r} for k, r in runs.items()}


def link_yardstick(torch, nbytes: int) -> dict:
    """A plain pinned copy_ of ``nbytes`` each way, by CUDA events: the
    device <-> host link's rate beside the swap tier's copies."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        dst.copy_(src, non_blocking=True)              # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        out[name + "_ms"], out[name + "_gb_s"] = ms, nbytes / ms / 1e6
    return out


def serve_swap(torch, counters, card, params) -> tuple[list, list]:
    """Phase 11a: phase 3's traffic over 100 blocks with a 1 GiB host tier,
    swap_policy "always", on graphs and eager; "never" (recompute); a pool
    that never preempts; then the same three over int8 pools at
    prefill_pack 4. Greedy tokens byte-identical in all, the swap runs'
    counters and the freed pools checked, the swap copies' times beside a
    plain pinned copy of the same bytes. Returns (runs, the bf16 no-preempt
    run's tokens in prompt order)."""
    from repro_torch.config import get_config
    from repro_torch.serving import Request
    from repro_torch.serving.kv_cache import block_bytes

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    runs, want = [], None
    for kv, pack in (("bf16", 1), ("int8", 4)):
        prefill = ("paged_prefill_attention" if pack == 1
                   else "ragged_paged_prefill_attention")
        expect = (variant(prefill, kv), variant("paged_attention", kv),
                  "gather")
        bb = block_bytes(cfg, 16, kv_dtype=kv)
        toks, res = {}, {}
        ways = [("swap", True, "always"), ("recompute", True, "never"),
                ("no_preempt", True, None)]
        if kv == "bf16":
            ways.insert(1, ("swap_eager", False, "always"))
        for label, graphs, policy in ways:
            kw = dict(kv_dtype=kv)
            if policy is not None:
                kw.update(num_blocks=SWAP_BLOCKS, swap_space_bytes=SWAP_SPACE,
                          swap_policy=policy)
            eng = glm4_engine(params, graphs, pack, **kw)
            r, t = serve(torch, counters, eng,
                         [Request(p.copy(), max_new=32) for p in prompts],
                         32, expect)
            r.update({k: eng.stats[k] for k in SWAP_KEYS},
                     label=f"11a {kv} pack {pack} {label}")
            check(eng.bm.stats().blocks_in_use == 0
                  and eng.bm.num_host_free == eng.bm.num_host_blocks,
                  f"{r['label']}: blocks or host slots left in use")
            eng.bm.check()
            toks[label], res[label] = list(t.values()), r
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        s, rc, n = res["swap"], res["recompute"], res["no_preempt"]
        check(s["swap_preemptions"] >= 2 and s["swap_ins"] >= 2,
              f"{kv}: {s['swap_preemptions']} swap preemptions, "
              f"{s['swap_ins']} swap-ins")
        check(s["swapped_out_bytes"] == s["swapped_out_blocks"] * bb
              and s["swapped_in_bytes"] == s["swapped_in_blocks"] * bb
              and 0 < s["swapped_in_blocks"] <= s["swapped_out_blocks"]
              + s["host_hit_blocks"],
              f"{kv}: swap counters {dict((k, s[k]) for k in SWAP_KEYS)}")
        check(rc["swap_preemptions"] == 0 and rc["preemptions"] >= 2
              and n["preemptions"] == 0,
              f"{kv}: recompute run {rc['preemptions']} preemptions, "
              f"no-preempt run {n['preemptions']}")
        for label in ("swap", "swap_eager"):
            if label in toks:
                same_streams(f"{kv} pack {pack}: {label} vs no-preempt",
                             toks[label], toks["no_preempt"])
        # recompute replays the generated tokens' KV through the chunk
        # path's GEMMs (256 or 512 rows, where decode wrote them with 8):
        # cuBLAS need not round a row alike at both shapes, so the streams
        # may part, but only at a near-tie (the rule of phases 6 and 10)
        margins = []
        rc["recompute_identical"] = sum(
            near_tie_or_same(torch, params, cfg, p, a, b, TOL, margins)
            for p, a, b in zip(prompts, toks["recompute"],
                               toks["no_preempt"]))
        rc["recompute_margins"] = margins
        per_swap = s["swapped_out_bytes"] // s["swap_preemptions"]
        link = link_yardstick(torch, per_swap)
        s.update(link_yardstick=link,
                 d2h_ms_per_swap=1e3 * s["swap_d2h_s"] / s["swap_preemptions"],
                 h2d_ms_per_swap_in=1e3 * s["swap_h2d_s"] / s["swap_ins"],
                 d2h_gb_s=s["swapped_out_bytes"] / max(s["swap_d2h_s"], 1e-12)
                 / 1e9,
                 h2d_gb_s=s["swapped_in_bytes"] / max(s["swap_h2d_s"], 1e-12)
                 / 1e9)
        print(f"[serve-swap] {card}: glm4_9b {kv} pools, pack {pack}, "
              f"{SWAP_BLOCKS - 1} blocks, 1 GiB host tier: swap == "
              f"no-preempt{' == swap eager' if kv == 'bf16' else ''} byte "
              f"for byte; recompute == no-preempt on "
              f"{rc['recompute_identical']}/{len(prompts)} requests, the "
              f"rest part at a near-tie (step, top-2 margin, limit) "
              f"{rc['recompute_margins']}; {s['swap_preemptions']} swap "
              f"preemptions "
              f"({s['preemptions']} in all), {s['swap_ins']} swap-ins, "
              f"{s['swapped_out_blocks']} blocks out / "
              f"{s['swapped_in_blocks']} in ({s['swapped_out_bytes']} / "
              f"{s['swapped_in_bytes']} bytes); d2h "
              f"{s['d2h_ms_per_swap']:.3f} ms a swap ({s['d2h_gb_s']:.2f} "
              f"GB/s), h2d {s['h2d_ms_per_swap_in']:.3f} ms a swap-in "
              f"({s['h2d_gb_s']:.2f} GB/s); a plain pinned copy of "
              f"{per_swap} bytes: d2h {link['d2h_ms']:.3f} ms "
              f"({link['d2h_gb_s']:.2f} GB/s), h2d {link['h2d_ms']:.3f} ms "
              f"({link['h2d_gb_s']:.2f} GB/s); tok/s swap {s['tok_s']}, "
              f"recompute {rc['tok_s']}, no-preempt {n['tok_s']}: "
              f"{json.dumps(brief_swap(res))}", flush=True)
        runs += list(res.values())
        if kv == "bf16":
            want = toks["no_preempt"]
    return runs, want


async def sse_client(port, prompt, max_new, drop_after=None):
    """POST /generate and read the SSE stream: (tokens, send time, token
    arrival times, the final rid or None). With ``drop_after`` the client
    disconnects after that many tokens."""
    import asyncio
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new": max_new}).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    t0 = time.monotonic()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: t\r\nContent-Type: "
                  f"application/json\r\nContent-Length: {len(body)}\r\n\r\n"
                  ).encode() + body)
    await writer.drain()
    toks, times, rid = [], [], None
    while True:
        line = await reader.readline()
        if not line or line.strip() == b"data: [DONE]":
            break
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[6:])
        if "token" in ev:
            toks.append(ev["token"])
            times.append(time.monotonic())
            if drop_after is not None and len(toks) == drop_after:
                break
        elif ev.get("done"):
            rid = ev["rid"]
    writer.close()
    return toks, t0, times, rid


async def http_get(port, path):
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body.decode()


def prometheus_samples(text: str) -> dict:
    """{sample name with labels: value} of Prometheus text; fails on a
    line that does not parse."""
    out = {}
    for ln in text.strip().split("\n"):
        if ln.startswith("#"):
            check(ln.startswith(("# HELP ", "# TYPE ")), f"metrics: {ln}")
            continue
        name, _, val = ln.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            fail(f"metrics: sample line does not parse: {ln}")
    return out


def serve_abort_http(torch, counters, card, params, want) -> list:
    """Phase 11b: phase 3's 8 requests through an AsyncEngineDriver over
    the 11a swap engine; when request 0 has 4 tokens (in the engine
    thread, between steps) it and one waiting request (a swapped one if
    any) are aborted: the other 6 streams equal a run without the two,
    every block and host slot is free. Phase 11c: FrontendServer on
    127.0.0.1, 8 concurrent SSE clients with phase 3's prompts, one
    disconnecting after 4 tokens: the other 7 equal ``want`` (the no-
    preempt run's), one abort, /health 200, /metrics parses with
    repro_engine_tokens_total == the tokens streamed; TTFT and the token
    gap as the clients saw them. Returns the runs."""
    import asyncio
    from repro_torch.config import get_config
    from repro_torch.serving import Request
    from repro_torch.serving.frontend import AsyncEngineDriver, FrontendServer

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    swap_kw = dict(num_blocks=SWAP_BLOCKS, swap_space_bytes=SWAP_SPACE,
                   swap_policy="always")
    expect = ("paged_attention", "paged_prefill_attention", "gather")
    runs = []

    # -- 11b
    eng = glm4_engine(params, **swap_kw)
    eng.capture_graphs()
    drv = AsyncEngineDriver(eng)
    reqs = [Request(p.copy(), max_new=32, rid=1100 + i)
            for i, p in enumerate(prompts)]
    aborted = {}

    async def run_b():
        streams = [await drv.submit(r) for r in reqs]
        await drv.start()
        inner = eng.on_token

        def hook(req, tok, lp=None):
            inner(req, tok, lp)
            if req is reqs[0] and len(req.out) == 4 and not aborted:
                waiting = list(eng.sched.waiting)
                check(waiting, "11b: no waiting request to abort")
                other = next((r for r in waiting if eng.bm.is_swapped(r.rid)),
                             waiting[-1])
                aborted.update(running=req.rid, other=other.rid,
                               other_swapped=eng.bm.is_swapped(other.rid))
                drv.abort(req.rid)
                drv.abort(other.rid)
        eng.on_token = hook

        async def pull(s):
            return [ev.token async for ev in s]

        outs = await asyncio.gather(*(pull(s) for s in streams))
        await drv.aclose()
        return outs

    torch.cuda.synchronize()
    reset_launches(counters)
    t0 = time.monotonic()
    outs = asyncio.run(run_b())
    wall = time.monotonic() - t0
    launches, replayed = fleet_launches(counters, [eng])
    check(drv.aborted == 2 and eng.stats["aborts"] == 2,
          f"11b: driver aborted {drv.aborted}, engine {eng.stats['aborts']}")
    check(eng.bm.stats().blocks_in_use == 0
          and eng.bm.num_host_free == eng.bm.num_host_blocks,
          "11b: blocks or host slots left after the aborts")
    eng.bm.check()
    gone = {aborted["running"], aborted["other"]}
    check(4 <= len(outs[0]) < 32, f"11b: aborted stream has {len(outs[0])}")
    keep = [i for i, r in enumerate(reqs) if r.rid not in gone]
    res_b = {"label": "11b abort", "launches": launches,
             "replayed_launches": replayed, "wall_s": wall,
             "aborted": aborted, "tokens": eng.stats["tokens"],
             "swap_preemptions": eng.stats["swap_preemptions"]}
    del eng, drv
    gc.collect()
    twin = glm4_engine(params, **swap_kw)
    r, t = serve(torch, counters, twin,
                 [Request(prompts[i].copy(), max_new=32) for i in keep], 32,
                 expect)
    same_streams("11b: survivors vs a run without the aborted two",
                 [outs[i] for i in keep], list(t.values()))
    r["label"] = "11b twin"
    runs += [res_b, r]
    print(f"[serve-abort] {card}: glm4_9b, 8 requests through the driver "
          f"over the swap engine: aborted running rid {aborted['running']} "
          f"after {len(outs[0])} tokens and waiting rid {aborted['other']} "
          f"(swapped: {aborted['other_swapped']}); the 6 others == a run "
          f"without the two, byte for byte; blocks and host slots all free; "
          f"{res_b['swap_preemptions']} swap preemptions in the run",
          flush=True)
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11c
    eng = glm4_engine(params)
    eng.capture_graphs()
    drv = AsyncEngineDriver(eng)
    pushed = {}
    drop = 5

    async def run_c():
        await drv.start()
        inner = eng.on_token

        def count(req, tok, lp=None):
            pushed[req.rid] = pushed.get(req.rid, 0) + 1
            inner(req, tok, lp)
        eng.on_token = count
        srv = FrontendServer(drv, host="127.0.0.1", port=0)
        await srv.start()
        clients = await asyncio.gather(*(
            sse_client(srv.port, p, 32, 4 if i == drop else None)
            for i, p in enumerate(prompts)))
        for _ in range(400):
            if drv.aborted:
                break
            await asyncio.sleep(0.05)
        health = await http_get(srv.port, "/health")
        metrics = await http_get(srv.port, "/metrics")
        await drv.aclose()
        await srv.aclose()
        return clients, health, metrics

    torch.cuda.synchronize()
    reset_launches(counters)
    t0 = time.monotonic()
    clients, health, metrics = asyncio.run(run_c())
    wall = time.monotonic() - t0
    launches, replayed = fleet_launches(counters, [eng])
    check(health[0] == 200 and json.loads(health[1])["status"] == "ok",
          f"11c: /health {health}")
    check(metrics[0] == 200, f"11c: /metrics status {metrics[0]}")
    samples = prometheus_samples(metrics[1])
    done_rids = {c[3] for c in clients if c[3] is not None}
    check(len(done_rids) == 7 and drv.dropped_streams == 1
          and drv.aborted == 1 and eng.stats["aborts"] == 1,
          f"11c: {len(done_rids)} streams completed, dropped "
          f"{drv.dropped_streams}, aborts {eng.stats['aborts']}")
    dropped_rid = next(r for r in pushed if r not in done_rids)
    streamed = sum(len(c[0]) for c in clients if c[3] is not None) \
        + pushed[dropped_rid]
    check(samples.get("repro_engine_tokens_total") == streamed
          == eng.stats["tokens"] and samples.get(
              "repro_engine_aborts_total") == 1,
          f"11c: repro_engine_tokens_total "
          f"{samples.get('repro_engine_tokens_total')} vs streamed "
          f"{streamed} (engine {eng.stats['tokens']})")
    same_streams("11c: HTTP streams vs engine.run()",
                 [c[0] for i, c in enumerate(clients) if i != drop],
                 [w for i, w in enumerate(want) if i != drop])
    ttft = [c[2][0] - c[1] for c in clients]
    gaps = [b - a for c in clients for a, b in zip(c[2], c[2][1:])]
    res_c = {"label": "11c http", "launches": launches,
             "replayed_launches": replayed, "wall_s": wall,
             "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
             "token_gap_s_median": statistics.median(gaps),
             "token_gap_s_max": max(gaps), "tokens": eng.stats["tokens"],
             "dropped_after": len(clients[drop][0])}
    runs.append(res_c)
    print(f"[serve-http] {card}: glm4_9b behind FrontendServer, 8 SSE "
          f"clients, one gone after 4 tokens: 7 streams == engine.run(), "
          f"1 abort, /health 200, /metrics parses "
          f"(repro_engine_tokens_total {streamed:.0f} == streamed); as the "
          f"clients saw it: TTFT median {res_c['ttft_s_median']:.3f} s max "
          f"{res_c['ttft_s_max']:.3f} s, token gap median "
          f"{1e3 * res_c['token_gap_s_median']:.2f} ms max "
          f"{1e3 * res_c['token_gap_s_max']:.2f} ms", flush=True)
    del eng, drv
    gc.collect()
    torch.cuda.empty_cache()
    return runs


class CaptureWatch:
    """Times every capture and replay of a fleet's engines, so the run can
    show one replica capturing in the middle of another's run (and that
    the device lock kept the other's replays out of the capture)."""

    def __init__(self, engines):
        self.captures, self.replays = [], []
        for i, eng in enumerate(engines):
            g = eng.graphs
            capture, replay = g.capture, g.replay

            def timed_capture(key, i=i, capture=capture):
                t = time.monotonic()
                capture(key)
                self.captures.append((i, key, t, time.monotonic()))

            def timed_replay(key, i=i, replay=replay):
                self.replays.append((i, time.monotonic()))
                return replay(key)
            g.capture, g.replay = timed_capture, timed_replay

    def around(self, mode) -> tuple[int, int, int]:
        """Replays of the other replicas before, inside and after the
        captures in ``mode``."""
        out = [0, 0, 0]
        for i, key, t0, t1 in self.captures:
            if key[1] == mode:
                for j, t in self.replays:
                    if j != i:
                        out[(t >= t0) + (t > t1)] += 1
        return tuple(out)


def serve_fleet(torch, counters, card, params, want, dp1_tok_s) -> list:
    """Phase 11d: ReplicaRouter over 2 glm4 engines on the one card sharing
    the weights and one SharedPrefixIndex (512 slots), phase 3's 8
    requests, plus a full-sampling request submitted mid-run (its replica
    captures the full graphs while the other replays; its tokens and
    logprobs equal its eager run alone); then disaggregate with one
    prefill replica. Tokens byte-identical to dp = 1 (``want``), blocks
    published and adopted across replicas. Returns the runs."""
    import asyncio
    from repro_torch.config import get_config
    from repro_torch.serving import (ReplicaRouter, Request, SamplingParams,
                                     SharedPrefixIndex)
    from repro_torch.serving.kv_cache import block_bytes

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    full_sp = SamplingParams(temperature=0.8, top_p=0.9, min_p=0.05,
                             repetition_penalty=1.1, logprobs=3, seed=7)
    bb = block_bytes(cfg, 16)
    runs = []
    full_out = None
    for label, rkw in (("dp2", {}), ("disagg", dict(disaggregate=True,
                                                    n_prefill=1))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shared = SharedPrefixIndex(num_slots=SHARED_SLOTS)
        engines = [glm4_engine(params, shared_index=shared)
                   for _ in range(2)]
        for eng in engines:
            eng.capture_graphs()
        check(all(e.params is params for e in engines),
              f"{label}: replicas do not share the weights")
        watch = CaptureWatch(engines)
        timing = {"publish_s": 0.0, "adopt_s": 0.0}
        for eng in engines:
            for name, key in (("_flush_shared_publish", "publish_s"),
                              ("_shared_in", "adopt_s")):
                fn = getattr(eng, name)

                def timed(*a, fn=fn, key=key):
                    t = time.monotonic()
                    fn(*a)
                    timing[key] += time.monotonic() - t
                setattr(eng, name, timed)
        router = ReplicaRouter(engines, **rkw)
        reqs = [Request(p.copy(), max_new=32, rid=1200 + i)
                for i, p in enumerate(prompts)]
        full_req = Request(prompts[3].copy(), max_new=16, sampling=full_sp,
                           rid=1300)

        async def go():
            streams = [await router.submit(r) for r in reqs]
            await router.start()
            first = await streams[0].__anext__()
            sfull = None
            if label == "dp2":               # mid-run: a new (shape, mode)
                sfull = await router.submit(full_req)

            async def pull(s):
                evs = [ev async for ev in s]
                return [e.token for e in evs], [e.logprobs for e in evs]

            outs = await asyncio.gather(*(pull(s) for s in streams))
            full = await pull(sfull) if sfull is not None else None
            await router.aclose()
            return [[first.token] + outs[0][0]] + [o[0] for o in outs[1:]], \
                full

        torch.cuda.synchronize()
        reset_launches(counters)
        t0 = time.monotonic()
        outs, full = asyncio.run(go())
        wall = time.monotonic() - t0
        launches, replayed = fleet_launches(counters, engines)
        same_streams(f"11d {label} vs dp 1", outs, want)
        published = sum(e.stats["shared_published_blocks"] for e in engines)
        adopted = sum(e.stats["shared_hit_blocks"] for e in engines)
        check(published > 0 and adopted > 0,
              f"11d {label}: published {published}, adopted {adopted}")
        shared.check()
        tokens = sum(e.stats["tokens"] for e in engines)
        res = {"label": f"11d {label}", "launches": launches,
               "replayed_launches": replayed, "wall_s": wall,
               "tok_s": tokens / wall, "routed": list(router.routed),
               "handoffs": router.handoffs,
               "published_blocks": published, "adopted_blocks": adopted,
               "adopted_bytes": adopted * bb, **timing,
               "shared": shared.stats(),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "captures": [(i, list(k)) for i, k, _, _ in watch.captures]}
        if full is not None:
            before, inside, after = watch.around("full")
            res["other_replays_around_full_captures"] = [before, inside,
                                                          after]
            check(before > 0 and after > 0 and inside == 0,
                  "11d: the full graphs' captures were not in the middle "
                  "of the other replica's run, or overlapped its replays "
                  f"(before, inside, after: {before}, {inside}, {after}; "
                  f"captures {res['captures']})")
            full_out = full
        if label == "disagg":
            check(router.handoffs == 8 and engines[1].stats[
                "cache_hit_tokens"] > 0, f"11d disagg: {router.handoffs} "
                "handoffs, the decode replica adopted nothing")
        runs.append(res)
        print(f"[serve-fleet] {card}: glm4_9b {label} (2 replicas on one "
              f"card, shared weights, {SHARED_SLOTS}-slot shared index, "
              f"{shared.num_slots * bb / 2 ** 20:.0f} MiB pinned): tokens == "
              f"dp 1 byte for byte; routed {router.routed}, handoffs "
              f"{router.handoffs}; {published} blocks published, "
              f"{adopted} adopted across replicas ({adopted * bb} bytes; "
              f"publish copies {timing['publish_s']:.3f} s, adoption copies "
              f"{timing['adopt_s']:.3f} s); {res['tok_s']:.1f} tok/s "
              f"(dp 1: {dp1_tok_s}; one card, not a speed claim); peak "
              f"{res['peak_mem_gib']:.2f} GiB"
              + ("; the other replica's replays before, inside and after "
                 "the mid-run full-sampling captures: "
                 f"{res['other_replays_around_full_captures']}"
                 if full is not None else ""), flush=True)
        del router, engines, shared, watch
        gc.collect()
        torch.cuda.empty_cache()
    # the mid-run full-sampling request against its eager run alone
    eager = glm4_engine(params, graphs=False)
    lps = []
    eager.on_token = lambda r, t, lp: lps.append(lp)
    got = eager.run([Request(prompts[3].copy(), max_new=16, sampling=full_sp,
                             rid=1300)])[1300].tolist()
    check(full_out[0] == got and full_out[1] == lps,
          f"11d: the full-sampling request on the fleet {full_out[0]} != "
          f"its eager run {got} (or its logprobs differ)")
    print(f"[serve-fleet] {card}: the mid-run full-sampling request (t 0.8, "
          f"top-p 0.9, min-p 0.05, repetition 1.1, logprobs 3): tokens and "
          f"logprobs == its eager run alone", flush=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def serve_tiers(torch, counters, card, params, parts="abcd") -> list:
    """Phase 11 (a-d) on phase 3's weights; ``parts`` picks some (a
    development run: without "a", one no-preempt run gives the tokens the
    others are held to). Prints the phase's launches by kernel (replay-
    aware, summed over its runs). Returns the runs."""
    from repro_torch.serving import Request
    if "a" in parts:
        runs, want = serve_swap(torch, counters, card, params)
        dp1 = next(r for r in runs
                   if r["label"] == "11a bf16 pack 1 no_preempt")
    else:
        from repro_torch.config import get_config
        dp1, toks = serve(torch, counters, glm4_engine(params),
                          [Request(p.copy(), max_new=32) for p in
                           phase3_prompts(get_config("glm4_9b"))], 32, ())
        runs, want = [dp1], list(toks.values())
    if "b" in parts or "c" in parts:
        runs += serve_abort_http(torch, counters, card, params, want)
    if "d" in parts:
        runs += serve_fleet(torch, counters, card, params, want,
                            dp1["tok_s"])
    launches = {}
    for r in runs:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"[serve-tiers] {card}: phase 11's launches by kernel "
          f"(replay-aware): {json.dumps(launches)}", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 6: card vs CPU at smoke size
# ---------------------------------------------------------------------------


def last_logits(torch, params, cfg, tokens, kv, device="cpu"):
    """fp32 logits after ``tokens`` on ``device`` (the parameters' own),
    by one monolithic chunk from fresh state (block 0 is the trash
    block)."""
    from repro_torch.models import transformer
    from repro_torch.serving.runners import make_runner

    n = len(tokens)
    nb = -(-n // 16)
    cache = make_runner(cfg).init_cache(nb + 1, 16, 1, device, kv)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                 device=device)
    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def compare_card_cpu(torch, cfg, params, prompts, arrivals, label, pack=1,
                     kv="bf16", **kw):
    """One smoke engine run on the card and one on the CPU, same weights
    and requests: greedy tokens equal, or the first difference at a top-2
    margin below the bf16 tolerance. Returns (card outputs, margins)."""
    import numpy as np
    from repro_torch.models.api import params_to
    from repro_torch.serving import InferenceEngine, Request

    outs = {}
    for dev in (DEV, "cpu"):
        eng = InferenceEngine(cfg, device=dev, params=params_to(params, dev),
                              prefill_pack=pack, kv_dtype=kv,
                              debug_invariants=True, **kw)
        reqs = [Request(p.copy(), max_new=20) for p in prompts]
        got = eng.run(reqs, arrival_steps=arrivals)
        outs[dev] = [got[r.rid].tolist() for r in reqs]
        if cfg.ssm is None or cfg.shared_attn_period:
            check(eng.stats["preemptions"] >= 1,
                  f"{dev} {label}: smoke run did not preempt")
        if cfg.ssm is None:
            check(eng.stats["cow_copies"] >= 1,
                  f"{dev} {label}: smoke run did not copy-on-write")
        else:
            check(eng.stats["quantum_dropped_tokens"] > 0,
                  f"{dev} {label}: no chunk was quantized")
    margins = []
    for p, a, b in zip(prompts, outs[DEV], outs["cpu"]):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = last_logits(torch, params, cfg,
                         np.concatenate([p, np.asarray(b[:i], np.int32)]), kv)
        top = torch.topk(lg, 2)
        margin = float(top.values[0] - top.values[1])
        margins.append(margin)
        check(margin < TOL and {a[i], b[i]} == set(top.indices.tolist()),
              f"{label}: card and CPU differ at step {i} with top-2 margin "
              f"{margin}")
    same = sum(a == b for a, b in zip(outs[DEV], outs["cpu"]))
    print(f"[card-vs-cpu] {label}: {same}/{len(prompts)} requests "
          f"token-identical; first-difference top-2 margins: {margins}",
          flush=True)
    return outs[DEV], {"identical": same, "margins": margins}


def card_vs_cpu(torch):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model

    cfg = get_config("glm4_9b", smoke=True)
    params = init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32)]), prefix.copy(),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    kw = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
              max_num_batched_tokens=2 + 12)
    outs, summary = {}, {}
    for pack, kv in ((1, "bf16"), (4, "bf16"), (4, "int8"), (1, "fp8")):
        outs[pack, kv], summary[f"pack{pack}_{kv}"] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 5, 9, 9],
            f"glm4 smoke, prefill_pack {pack}, {kv} pools", pack, kv, **kw)
    check(outs[4, "bf16"] == outs[1, "bf16"],
          "on the card, prefill_pack 4 and 1 gave different bf16 tokens")
    print("[card-vs-cpu] on the card, prefill_pack 4 == prefill_pack 1 "
          "(bf16), token for token", flush=True)
    # gemma2: its 16-token window (prompts of 20-45 tokens), both softcaps,
    # scale 1/4 and post-block norms through the hd-16 kernels
    cfg = get_config("gemma2_27b", smoke=True)
    params = init_model(cfg, seed=0, device="cpu")
    for pack in (1, 4):
        _, summary[f"gemma2_pack{pack}"] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 5, 9, 9],
            f"gemma2 smoke, prefill_pack {pack}, bf16 pools", pack, **kw)
    # SSM and hybrid: quantized chunks (a 13-token budget over 8-token SSD
    # chunks), staggered arrivals; zamba2 also preempts (7 blocks of 16)
    for arch in ("mamba2_370m", "zamba2_2p7b"):
        cfg = get_config(arch, smoke=True)
        params = init_model(cfg, seed=0, device="cpu")
        prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
                   for _ in range(4)]
        kw = dict(max_batch=2, block_size=16, max_len=96,
                  max_num_batched_tokens=2 + 13)
        if cfg.shared_attn_period:
            kw["num_blocks"] = 8
        _, summary[arch] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 0, 3, 5], f"{arch} smoke", **kw)
    return summary


# ---------------------------------------------------------------------------
# phases 7-8: training
# ---------------------------------------------------------------------------

# Phase 7's optimizer: AdamW with fp32 slots, the JAX driver's learning
# rate (1e-3) with a 2-step warmup and cosine decay over the 6 steps
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LAYERS = 6, 2, 2048, 8


def train_full(torch, counters, card):
    """Phase 7: glm4_9b at full width, 8 of its 40 layers (the fp32
    masters and AdamW slots of 40 do not fit one card), seeded random
    init, remat full, B=2 x S=2048 from ShardedSource(seed=0), through
    ``launch.train.train``. Every loss finite and the last below the
    first; on step 1 every parameter leaf has a finite, non-zero gradient;
    the flash kernel launched 2 x layers x steps times (forward and remat
    recompute) and the gather once per step (the embedding)."""
    import dataclasses
    from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import tree_leaves

    cfg = dataclasses.replace(get_config("glm4_9b"), num_layers=TRAIN_LAYERS)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    pcfg = ParallelConfig(remat="full", microbatches=1)
    steps, grads_seen = [], []

    def grad_hook(grads):
        if grads_seen:
            return
        leaves = tree_leaves(grads)
        grads_seen.append(len(leaves))
        for i, g in enumerate(leaves):
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                  f"train: parameter leaf {i} {tuple(g.shape)} has a "
                  "non-finite or all-zero gradient on step 1")

    # unreachable tensors of the serving phases (reference cycles) wait for
    # Python's collector: free them, so the peak is the training run's
    gc.collect()
    print(f"[mem] before training: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.monotonic()
    params, state, losses = train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, pcfg=pcfg,
        ocfg=ocfg, device=DEV, seed=0, log_every=1,
        on_step=lambda s, m, sec: steps.append(
            dict(step=s, loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                 ms=1e3 * sec, tok_s=TRAIN_B * TRAIN_S / sec)),
        grad_hook=grad_hook)
    wall = time.monotonic() - t0
    launches = read_launches(counters)
    check(all(map(math.isfinite, losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: last loss {losses[-1]} is not "
          f"below the first {losses[0]}")
    check(grads_seen == [3 + 9 * TRAIN_LAYERS],
          f"train: gradient leaves {grads_seen}")
    want = {"flash_attention": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "gather": TRAIN_STEPS}
    for name, n in want.items():
        check(launches.get(name) == n, f"train: {name} launched "
              f"{launches.get(name)} times, not {n}")
    check(not launches.get("flash_attention_mma"), "train: the hd-16 flash "
          f"route launched {launches.get('flash_attention_mma')} times at "
          "full width")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = profile_train_step(torch, cfg, pcfg, ocfg, params, state)
    del params, state
    later = steps[1:]
    res = dict(arch="glm4_9b", layers=TRAIN_LAYERS, params=cfg.param_count(),
               batch=TRAIN_B, seq=TRAIN_S, remat="full", optimizer="adamw",
               losses=losses, steps=steps, wall_s=wall,
               step_ms_mean=sum(x["ms"] for x in later) / len(later),
               tok_s_mean=sum(x["tok_s"] for x in later) / len(later),
               peak_mem_gib=peak, launches=launches, profile=profile)
    print(f"[train] {card}: glm4_9b full width, {TRAIN_LAYERS} layers "
          f"({res['params'] / 1e9:.2f} B params), B={TRAIN_B} S={TRAIN_S}, "
          f"remat full, AdamW: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"step {res['step_ms_mean']:.1f} ms ({res['tok_s_mean']:.0f} "
          f"tok/s) over steps 2-{TRAIN_STEPS}, peak "
          f"{res['peak_mem_gib']:.2f} GiB, launches {launches}: "
          f"{json.dumps(res)}", flush=True)
    torch.cuda.empty_cache()
    return res


def profile_train_step(torch, cfg, pcfg, ocfg, params, state, top=15):
    """One more training step (batch index TRAIN_STEPS) under
    torch.profiler, after the timed run: device time by kernel and the
    device's busy share of the step's wall time (kernel times summed).
    Returns {"wall_ms", "device_ms", "top": [[name, ms, calls], ...]}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import ShardedSource
    from repro_torch.spmd.steps import make_train_step

    step = make_train_step(cfg, pcfg, ocfg)
    batch = {k: torch.from_numpy(np.array(v)).to(DEV) for k, v in
             ShardedSource(cfg, TRAIN_S, seed=0).batch(
                 TRAIN_STEPS, TRAIN_B).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, m = step(params, state, TRAIN_STEPS, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events) / 1e3
    out = {"wall_ms": 1e3 * wall, "device_ms": total,
           "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                   for e in events[:top]]}
    print(f"[train-profile] one step: device {total:.1f} ms over "
          f"{1e3 * wall:.1f} ms wall (profiled), busy share "
          f"{total / (1e3 * wall):.3f}", flush=True)
    for name, ms, n in out["top"]:
        print(f"[train-profile] {ms:9.2f} ms {100 * ms / total:5.1f}% "
              f"{n:6d}x {name}", flush=True)
    return out


# phase 8's models besides glm4: (arch, config changes); qwen2_vl at its
# smoke config's own head dim 12 (the flash kernel's mma route)
CARD_VS_CPU_TRAIN = (("mamba2_370m", {}), ("zamba2_2p7b", {}),
                     ("qwen3_moe_30b_a3b", {}), ("grok1_314b", {}),
                     ("whisper_large_v3", {}), ("qwen2_vl_2b", {}))


def train_card_vs_cpu(torch):
    """Phase 8: smoke models on the card and on the CPU (``
    train_card_vs_cpu_one``): glm4 on ShardedSource's first three
    batches, then CARD_VS_CPU_TRAIN's models, the decoders on the same
    source (qwen2_vl with its 1-D positions on all three planes, as
    ``make_batch`` gives them), whisper on ``make_batch``'s seeded frames
    (seeds 0-2)."""
    import dataclasses
    import numpy as np
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data.pipeline import ShardedSource
    from repro_torch.models import api

    def source_batches(cfg, positions=False):
        out = []
        for i in range(3):
            b = {k: torch.from_numpy(np.array(v)) for k, v in
                 ShardedSource(cfg, 32, seed=0).batch(i, 4).items()}
            if positions:
                b["positions"] = torch.arange(32, dtype=torch.int32)[
                    None, None].expand(3, 4, 32).contiguous()
            out.append(b)
        return out

    cfg = get_config("glm4_9b", smoke=True)
    out = {"glm4_9b": train_card_vs_cpu_one(torch, "glm4 smoke", cfg,
                                            source_batches(cfg),
                                            floor=False)}
    for arch, change in CARD_VS_CPU_TRAIN:
        cfg = dataclasses.replace(get_config(arch, smoke=True), **change)
        if cfg.frontend == "audio":
            batches = [api.make_batch(cfg, ShapeConfig("t", 32, 4, "train"),
                                      i, "cpu") for i in range(3)]
        else:
            batches = source_batches(cfg, cfg.frontend == "vision")
        label = f"{arch} smoke" + (f" {change}" if change else "")
        out[arch] = train_card_vs_cpu_one(torch, label, cfg, batches)
    return out


# phase 8's noise floor for the families this PR trains: CPU runs whose
# bf16 residual-stream inputs (the embedding outputs, and whisper's frames)
# carry one-bf16-ulp flips in FLIP_SHARE of their values, one run per seed.
# The floor is how far such a run lands from the plain CPU run: bf16
# rounding differences of any kind, amplified over three SGD steps of a
# random smoke model.
FLIP_SHARE = 0.005
FLIP_SEEDS = (0, 1, 2)


@contextlib.contextmanager
def flipped_embedding(torch, seed: int):
    """The decoders' and whisper's ``embed``, and whisper's ``encode`` on
    its frames, with a seeded FLIP_SHARE of their bf16 inputs to the
    residual stream moved by one ulp, up or down (the gradient passes as
    the plain one), inside the block."""
    from repro_torch.models import encdec, transformer
    gen = torch.Generator()
    gen.manual_seed(seed)
    plain_embed, plain_encode = transformer.embed, encdec.encode

    def flip(y):
        bits = y.detach().cpu().view(torch.int16)
        hit = torch.rand(y.shape, generator=gen) < FLIP_SHARE
        step = torch.where(torch.rand(y.shape, generator=gen) < 0.5, 1, -1)
        moved = torch.where(hit, bits + step.to(torch.int16), bits)
        return y + (moved.view(torch.bfloat16).to(y.device) - y).detach()

    def embed(table, tokens, cfg):
        return flip(plain_embed(table, tokens, cfg))

    def encode(params, frames, cfg, *args, **kw):
        return plain_encode(params, flip(frames), cfg, *args, **kw)

    transformer.embed = encdec.embed = embed
    encdec.encode = encode
    try:
        yield
    finally:
        transformer.embed = encdec.embed = plain_embed
        encdec.encode = plain_encode


def leaf_paths(tree, prefix=""):
    """Paths of ``tree``'s leaves, in ``optimizers.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def train_card_vs_cpu_one(torch, label, cfg, batches, floor=True) -> dict:
    """One smoke model on the card and on the CPU from the same fp32
    masters, the same batches, two microbatches, remat full, SGD. The
    card attends through the flash kernel and scans through the ssd
    kernel (each under its autograd function, with the plain backward),
    the CPU runs dense_attention and ssd_chunked under autograd. Losses
    within TOL per step, grad norms within TOL relative, each fp32 master
    within TOL of the largest master update; the card's launches as
    ``expected_launches`` counts them (2 forward passes per microbatch).
    The families this PR trains (``floor``) are held to the larger of
    these and twice their noise floor (``flipped_embedding``, the largest
    over FLIP_SEEDS): their bf16 smoke models amplify any rounding
    difference into several percent of an update within three steps (a
    plain CPU run against one with a few flipped input bits lands as far
    from it as the card does), and most in a few elements (the tied
    table's most frequent rows). So their masters are held leaf by leaf:
    each leaf's difference over its own update (L2 norms) against the
    larger of TOL and twice that leaf's floor, so that a small leaf (a
    router, A_log, dt_bias, D, a conv weight) is held on its own and not
    inside the embedding table's norm; the largest element's difference
    over the largest update is printed beside its floor. A MoE model's CPU
    runs replay the card run's routing (``RouteTape``): bf16 rounding
    routes some rows to other experts on each side, which moves them by
    far more than a rounding (phase 12's static check replays for the
    same reason)."""
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.models.api import init_model
    from repro_torch.optim import optimizers as opt
    from repro_torch.serving.graphs import KERNELS
    from repro_torch.spmd.steps import make_train_step

    ocfg = OptimizerConfig(name="sgd", lr=0.1, warmup_steps=0,
                           schedule="constant")
    pcfg = ParallelConfig(remat="full", microbatches=2)
    init = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)

    def run(dev):
        state = opt.init_train_state(ocfg, opt.tree_map(
            lambda t: t.to(dev, copy=True), init))     # updated in place
        params = opt.working_params(state)
        step = make_train_step(cfg, pcfg, ocfg)
        metrics = []
        for s, b in enumerate(batches):
            params, state, m = step(params, state, s,
                                    {k: v.to(dev) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, [t.cpu() for t in opt.tree_leaves(state["master"])]

    tape = RouteTape()
    reset_launches(KERNELS)
    with tape.record() if cfg.moe is not None else contextlib.nullcontext():
        card = run(DEV)
    launches = read_launches(KERNELS)
    want = expected_launches(cfg, 2 * 2 * len(batches))
    check({k: launches.get(k, 0) for k in want} == want
          and sum(launches.values()) == sum(want.values()),
          f"train card-vs-cpu {label}: launches {launches}, not {want}")

    def cpu_run():
        with tape.replay() if cfg.moe is not None \
                else contextlib.nullcontext():
            return run("cpu")

    cpu = cpu_run()
    w0 = opt.tree_leaves(init)
    upd = max(float((b - c).abs().max()) for b, c in zip(cpu[1], w0))
    check(upd > 0, f"train card-vs-cpu {label}: the masters did not move")

    names = leaf_paths(init)

    def gap(other):
        """(loss diffs, grad-norm relative diffs by step, worst master
        diff over the largest update, each leaf's difference over its own
        update) of a run against the plain CPU run."""
        (m_a, w_a), (m_b, w_b) = other, cpu
        return ([abs(a["loss"] - b["loss"]) for a, b in zip(m_a, m_b)],
                [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(m_a, m_b)],
                max(float((a - b).abs().max()) for a, b in zip(w_a, w_b))
                / upd,
                [float((a - b).norm()) / max(float((b - c).norm()), 1e-30)
                 for a, b, c in zip(w_a, w_b, w0)])

    losses, norms, masters, leaves = gap(card)
    res = {"losses_card": [m["loss"] for m in card[0]],
           "losses_cpu": [m["loss"] for m in cpu[0]],
           "grad_norms_card": [m["grad_norm"] for m in card[0]],
           "grad_norms_cpu": [m["grad_norm"] for m in cpu[0]],
           "masters_err_over_update": masters,
           "leaf_rel_err_max": max(leaves), "launches": launches}
    note = ""
    if cfg.moe is not None:
        res.update(rows_replayed=tape.replayed, rows_rerouted=tape.rerouted)
        note = (f"; the CPU runs replayed the card's routing ({tape.rerouted}"
                f" of {tape.replayed} rows would have routed otherwise)")
    loss_lim, norm_lim = [TOL] * len(batches), [TOL] * len(batches)
    if floor:
        floors = []
        for seed in FLIP_SEEDS:
            with flipped_embedding(torch, seed):
                floors.append(gap(cpu_run()))
        fl_loss, fl_norm = ([max(f[i][j] for f in floors)
                             for j in range(len(batches))] for i in (0, 1))
        fl_masters = max(f[2] for f in floors)
        fl_leaves = [max(f[3][j] for f in floors) for j in range(len(names))]
        loss_lim = [max(TOL, 2 * x) for x in fl_loss]
        norm_lim = [max(TOL, 2 * x) for x in fl_norm]
        leaf_lim = [max(TOL, 2 * x) for x in fl_leaves]
        # the leaves nearest their limits, and every SSM and router leaf
        ranked = sorted(range(len(names)),
                        key=lambda j: leaves[j] / leaf_lim[j], reverse=True)
        shown = ranked[:4] + [j for j in ranked[4:] if any(
            w in names[j] for w in ("A_log", "dt_bias", "/D", "conv",
                                    "router"))]
        res.update(floor_loss=fl_loss, floor_grad_norm=fl_norm,
                   floor_masters=fl_masters,
                   leaves={names[j]: [leaves[j], fl_leaves[j]]
                           for j in shown},
                   leaf_ratio_max=leaves[ranked[0]] / leaf_lim[ranked[0]])
        note += (f"; noise floor (CPU runs with {FLIP_SHARE} of the "
                 f"residual-stream inputs one ulp off, the largest of "
                 f"{len(FLIP_SEEDS)} seeds): losses {fl_loss}, grad norms "
                 f"{fl_norm}, masters {fl_masters:.3g}; leaves (card, floor) "
                 + ", ".join(f"{names[j]} {leaves[j]:.3g} {fl_leaves[j]:.3g}"
                             for j in shown))
    else:
        leaf_lim = None
    print(f"[train-card-vs-cpu] {label}, {len(batches)} SGD steps, 2 "
          f"microbatches: losses card {res['losses_card']} cpu "
          f"{res['losses_cpu']}; grad norms card {res['grad_norms_card']} "
          f"cpu {res['grad_norms_cpu']}; masters within {masters:.3g} of "
          f"the largest update; the worst leaf {max(leaves):.3g} of its "
          f"own update{note}; card launches {launches}", flush=True)
    check(all(a <= b for a, b in zip(losses, loss_lim))
          and all(a <= b for a, b in zip(norms, norm_lim)),
          f"train card-vs-cpu {label}: losses differ by {losses}, grad norms "
          f"by {norms} relative (limits {loss_lim}, {norm_lim})")
    if leaf_lim is None:
        check(masters <= TOL, f"train card-vs-cpu {label}: masters differ "
              f"by {masters} of the largest update (limit {TOL})")
    else:
        over = [(names[j], leaves[j], leaf_lim[j]) for j in range(len(names))
                if leaves[j] > leaf_lim[j]]
        check(not over, f"train card-vs-cpu {label}: leaves past their "
              f"limits (leaf, its difference over its own update, limit): "
              f"{over}")
    return res


# ---------------------------------------------------------------------------
# phases 13 and 15: training of every family at full width; checkpoint and
# resume on the card
# ---------------------------------------------------------------------------

# (arch, layers or None for the full depth, batch source): B 2; S 2048 for
# the decoders, 448 decoder tokens over 1500 frames for whisper. Since
# phase 18 the whole run's time limit cuts mamba2 to 24 of its 48 layers,
# zamba2 to 30 of 54 (five 6-layer periods), whisper's decoder to 16 of 32
# (its encoder keeps 32) and qwen2_vl to 14 of 28
FAMILY_TRAIN = (("mamba2_370m", 24, "source"),
                ("zamba2_2p7b", 30, "source"),
                ("qwen3_moe_30b_a3b", 4, "source"),
                ("whisper_large_v3", 16, "make_batch"),
                ("qwen2_vl_2b", 14, "mrope"))
FAMILY_STEPS, FAMILY_B, FAMILY_S, WHISPER_S = 4, 2, 2048, 448
# the archs that also take one step under each remat mode
REMAT_ARCHS = ("mamba2_370m", "qwen3_moe_30b_a3b")
REMAT_TOL = 1e-6


def family_batch(torch, np, cfg, kind):
    """Phase 13's fixed batch on the card: ShardedSource's batch 0 for the
    decoders (with phase 12d's 3-plane positions for qwen2_vl), or
    ``api.make_batch`` (seeded 1500 x 1280 frames) for whisper."""
    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import ShardedSource
    from repro_torch.models import api
    if kind == "make_batch":
        return api.make_batch(cfg, ShapeConfig("train", WHISPER_S, FAMILY_B,
                                               "train"), 0, DEV)
    b = {k: torch.from_numpy(np.array(v)).to(DEV) for k, v in
         ShardedSource(cfg, FAMILY_S, seed=0).batch(0, FAMILY_B).items()}
    if kind == "mrope":
        b["positions"] = torch.from_numpy(mrope_positions(
            np, FAMILY_B, FAMILY_S)).to(DEV)
    return b


def expected_launches(cfg, passes: int) -> dict:
    """Kernel launches of ``passes`` forward passes, half of them remat
    recomputes (remat full): the flash kernel once per attention
    application on its head dim's route (whisper: its encoder, decoder
    self and cross attention), the ssd kernel once per mamba layer (one
    launch scans every chunk), the gather once per forward that is not a
    recompute (the embedding is outside the remat units)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import layer_counts
    if cfg.encoder_layers:
        n_attn, n_mamba = cfg.encoder_layers + 2 * cfg.num_layers, 0
    else:
        n_attn, n_mamba = layer_counts(cfg)
    out = {"gather": passes // 2}
    if n_attn:
        out[variant("flash_attention", fa.route(cfg.head_dim))] = \
            passes * n_attn
    if n_mamba:
        out["ssd"] = passes * n_mamba
    return out


def profile_family_step(torch, step, params, state, batch, label, top=12):
    """One more step under torch.profiler: device ms by kernel, the busy
    share, and the SSD's split: its kernel forward (the ssd_prep and
    ssd_main launches) and its plain recompute backward (the device time
    under the SSDBackward ranges, its backward node's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, m = step(params, state, FAMILY_STEPS, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    avg = prof.key_averages()
    kernels = sorted((e for e in avg if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    ssd_fwd = sum(e.self_device_time_total for e in kernels
                  if "ssd_prep" in e.key or "ssd_main" in e.key) / 1e3
    ssd_bwd = sum(e.device_time_total for e in avg
                  if e.device_type.name != "CUDA"
                  and e.key == "SSDBackward") / 1e3
    out = {"wall_ms": 1e3 * wall, "device_ms": total,
           "busy_share": total / (1e3 * wall),
           "ssd_forward_ms": ssd_fwd, "ssd_plain_backward_ms": ssd_bwd,
           "ssd_forward_share": ssd_fwd / total,
           "ssd_plain_backward_share": ssd_bwd / total,
           "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                   for e in kernels[:top]]}
    print(f"[train-family-profile] {label}: one step, device {total:.1f} ms "
          f"over {1e3 * wall:.1f} ms wall (profiled), busy share "
          f"{out['busy_share']:.3f}; SSD kernel forward {ssd_fwd:.1f} ms "
          f"({100 * out['ssd_forward_share']:.1f}%), its plain recompute "
          f"backward {ssd_bwd:.1f} ms "
          f"({100 * out['ssd_plain_backward_share']:.1f}%)", flush=True)
    for name, ms, n in out["top"]:
        print(f"[train-family-profile] {label} {ms:9.2f} ms "
              f"{100 * ms / total:5.1f}% {n:6d}x {name}", flush=True)
    return out


def remat_modes(torch, cfg, params, batch, label) -> dict:
    """The loss and the gradient (a step before its update) from the same
    working params under remat none, full and dots: losses and grad norms
    within REMAT_TOL relative; whether they and every gradient are bitwise
    equal to none's; each mode's peak memory."""
    from repro_torch.config import ParallelConfig
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt
    leaves = opt.tree_leaves(params)
    out, first = {}, None
    for mode in ("none", "full", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = api.loss_fn(params, batch, cfg, ParallelConfig(remat=mode))
        grads = torch.autograd.grad(loss, leaves)
        gn = opt.global_norm(grads)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if first is None:
            first = (loss.detach(), [g.clone() for g in grads])
            bitwise = True
        else:
            bitwise = bool(torch.equal(loss, first[0])
                           and all(torch.equal(a, b)
                                   for a, b in zip(grads, first[1])))
        out[mode] = dict(loss=float(loss.detach()), grad_norm=float(gn),
                         peak_mem_gib=peak, bitwise_equal_to_none=bitwise)
        del loss, grads
    del first
    for mode in ("full", "dots"):
        for k in ("loss", "grad_norm"):
            a, b = out[mode][k], out["none"][k]
            check(abs(a - b) <= REMAT_TOL * abs(b), f"{label} remat {mode}: "
                  f"{k} {a} vs none's {b}")
    print(f"[train-remat] {label}: one step's loss and grad norm under "
          f"remat none / full / dots: {json.dumps(out)}", flush=True)
    return out


def resume_check(torch, step_fn, mgr, spec, saved, batch, uninterrupted,
                 label):
    """Phase 15: restore the step-2 checkpoint onto the card and run step
    3 on the same batch: loss, grad norm and every master equal the
    uninterrupted run's step 3, bit for bit; the same checkpoint restored
    onto the CPU (``restore_to``) equals the state the card saved (its
    host copy ``saved``), bit for bit, the bf16 leaves through their
    uint16 round trip."""
    from repro_torch.checkpoint.elastic import restore_to
    from repro_torch.optim import optimizers as opt
    loss3, gn3, masters3 = uninterrupted
    t0 = time.monotonic()
    step, tree = restore_to(mgr, spec, DEV, step=2)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    check(step == 2, f"{label}: restored step {step}, not 2")
    params = opt.tree_map(lambda t: t.requires_grad_(), tree["params"])
    _, state, m = step_fn(params, tree["opt"], 2, batch)
    same_masters = all(torch.equal(a.cpu(), b) for a, b in zip(
        opt.tree_leaves(state["master"]), masters3))
    check(torch.equal(m["loss"], loss3) and torch.equal(m["grad_norm"], gn3)
          and same_masters, f"{label}: the resumed step 3 differs from "
          f"the uninterrupted one: loss {float(m['loss'])} vs "
          f"{float(loss3)}, grad norm {float(m['grad_norm'])} vs "
          f"{float(gn3)}, masters equal {same_masters}")
    del params, state, tree
    gc.collect()
    torch.cuda.empty_cache()
    _, cpu_tree = restore_to(mgr, spec, "cpu", step=2)
    leaves = opt.tree_leaves(cpu_tree)
    check(len(leaves) == len(saved) and all(
        a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(leaves, saved)),
        f"{label}: the checkpoint restored on the CPU differs from the "
        "state saved on the card")
    n_bf16 = sum(t.dtype == torch.bfloat16 for t in leaves)
    check(n_bf16 > 0, f"{label}: no bf16 leaf in the checkpoint")
    res = dict(restore_s=restore_s, leaves=len(leaves), bf16_leaves=n_bf16,
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    print(f"[train-resume] {label}: step-2 checkpoint ({len(leaves)} leaves, "
          f"{n_bf16} bf16 through their uint16 view) restored onto the card "
          f"in {restore_s:.2f} s: step 3's loss {res['loss']:.6f}, grad "
          f"norm {res['grad_norm']:.6f} and every master equal the "
          "uninterrupted run's, bit for bit; restored onto the CPU it "
          "equals the state the card saved, bit for bit", flush=True)
    return res


def train_family(torch, counters, card, arch, layers, kind) -> dict:
    """One phase-13 model: seeded fp32 masters, FAMILY_STEPS AdamW steps
    (remat full) on one fixed batch: finite losses, the last below the
    first; on step 1 a finite, non-zero gradient on every parameter leaf;
    the launches ``expected_launches`` counts. The SSM models also take a
    profiled step, REMAT_ARCHS one step's loss and gradient under each
    remat mode, and mamba2 runs phase 15 around its step 3."""
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import save_global
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    get_config)
    from repro_torch.models.api import init_model
    from repro_torch.optim import optimizers as opt
    from repro_torch.spmd.steps import make_train_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=FAMILY_STEPS)
    pcfg = ParallelConfig(remat="full", microbatches=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = opt.init_train_state(ocfg, init_model(cfg, 0, DEV, torch.float32))
    params = opt.working_params(state)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    batch = family_batch(torch, np, cfg, kind)
    tokens = batch["tokens"].numel()
    step = make_train_step(cfg, pcfg, ocfg)
    grads_seen = []

    def grad_hook(grads):
        leaves = opt.tree_leaves(grads)
        grads_seen.append(len(leaves))
        for i, g in enumerate(leaves):
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                  f"{arch}: parameter leaf {i} {tuple(g.shape)} has a "
                  "non-finite or all-zero gradient on step 1")

    # phase 15 (mamba2): an async save of the state after step 2; step 3's
    # loss, grad norm and masters
    ckpt = tempfile.TemporaryDirectory() if arch == "mamba2_370m" else None
    metrics, step3 = [], None
    reset_launches(counters)
    for s in range(FAMILY_STEPS):
        t1 = time.monotonic()
        _, _, m = step(params, state, s, batch,
                       grad_hook=grad_hook if s == 0 else None)
        raw = (m["loss"], m["grad_norm"])
        m = {k: float(v) for k, v in m.items()}
        ms = 1e3 * (time.monotonic() - t1)
        metrics.append(dict(step=s, ms=ms, tok_s=tokens / ms * 1e3, **m))
        if ckpt is not None and s == 1:
            mgr = CheckpointManager(ckpt.name, keep=2, keep_best=1)
            spec = {"params": params, "opt": state}
            t2 = time.monotonic()
            save_global(mgr, 2, spec, metric=m["loss"])
            save_s = time.monotonic() - t2
            saved = [t.detach().to("cpu", copy=True)
                     for t in opt.tree_leaves(spec)]
        if ckpt is not None and s == 2:
            step3 = (*raw, [t.to("cpu", copy=True) for t in
                            opt.tree_leaves(state["master"])])
    launches = read_launches(counters)
    losses = [x["loss"] for x in metrics]
    check(all(map(math.isfinite, losses)), f"{arch}: losses {losses}")
    check(losses[-1] < losses[0], f"{arch}: last loss {losses[-1]} is not "
          f"below the first {losses[0]}")
    check(grads_seen == [len(opt.tree_leaves(params))],
          f"{arch}: gradient leaves {grads_seen}")
    want = expected_launches(cfg, 2 * FAMILY_STEPS)
    check({k: launches.get(k, 0) for k in want} == want
          and sum(launches.values()) == sum(want.values()),
          f"{arch}: launches {launches}, not {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    later = metrics[1:]
    res = dict(arch=arch, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers, params=cfg.param_count(),
               batch=FAMILY_B, tokens=tokens, remat="full",
               optimizer="adamw", init_s=init_s, steps=metrics,
               losses=losses,
               step_ms_mean=sum(x["ms"] for x in later) / len(later),
               tok_s_mean=sum(x["tok_s"] for x in later) / len(later),
               peak_mem_gib=peak, launches=launches)
    if cfg.moe is not None:
        res["ce"] = [x["ce"] for x in metrics]
        res["aux"] = [x["aux"] for x in metrics]
    if cfg.ssm is not None:
        res["profile"] = profile_family_step(torch, step, params, state,
                                             batch, arch)
    if ckpt is not None:
        mgr.wait()
        res["resume"] = resume_check(torch, step, mgr, spec, saved, batch,
                                     step3, arch)
        res["resume"]["save_s"] = save_s
        del spec, saved, step3
        ckpt.cleanup()
    if arch in REMAT_ARCHS:
        res["remat_modes"] = remat_modes(torch, cfg, params, batch, arch)
    depth = f"{cfg.num_layers} layers" + (
        f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
    aux = f" (ce {res['ce']}, aux {res['aux']})" if "aux" in res else ""
    print(f"[train-family] {card}: {arch} full width, {depth} "
          f"({res['params'] / 1e9:.2f} B params), B={FAMILY_B} x "
          f"{batch['tokens'].shape[1]} tokens, remat full, AdamW, one fixed "
          f"batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}{aux}, step "
          f"{res['step_ms_mean']:.1f} ms ({res['tok_s_mean']:.0f} tok/s) "
          f"over steps 2-{FAMILY_STEPS}, peak {peak:.2f} GiB, launches "
          f"{launches}: {json.dumps(res)}", flush=True)
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_families(torch, counters, card, only=None) -> list:
    """Phase 13 (with phase 15 in mamba2's run): each of FAMILY_TRAIN in
    turn, each freed before the next."""
    return [train_family(torch, counters, card, arch, layers, kind)
            for arch, layers, kind in FAMILY_TRAIN
            if only is None or arch in only]


# ---------------------------------------------------------------------------
# phase 16: the paper's dataflow core and the parameter-server trainer
# ---------------------------------------------------------------------------

CORE_TOL = 1e-5            # card vs CPU, relative to the largest |value|
FIG9_TOL = 1e-4            # a gradient's max difference over its max |g|
# Figure 9 at the paper's widths: LSTM-512-512, a 40,000-word vocabulary,
# 512 sampled classes (§6.4's "78x" is 40,000 / 512); batch and unroll as
# in the JAX package's bench
FIG9 = dict(vocab=40000, d=512, unroll=8, batch=64, n_sampled=512,
            workers=2, steps=6)
# the gather kernel at the core's float32 rows: (d, V, what)
CORE_ROWS = ((1, 1 << 20, "a 1-D vector"), (2, 1 << 20, "Figure 3"),
             (16, 1 << 22, "Figure 6's sparse shard"),
             (512, 40000, "the LM's embedding"))
CORE_IDS = (1, 32, 4096)
# Figure 6's variables, one per PS task (4): scalar, dense 100 MB and 1 GB,
# and a 1 GB sparse table of 16-float rows (the paper's 16 GB table is left
# out: its numpy initial alone would take 16 GB of host memory)
FIG6_PS = 4
FIG6_SHAPES = {"scalar": (1,), "dense_100MB": (100 * 2 ** 20 // 16,),
               "dense_1GB": (2 ** 30 // 16,), "sparse_1GB": (2 ** 24 // 4, 16)}
FIG6_STEPS = 6


def core_session(device, **jobs):
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.graph import Graph
    from repro_torch.core.session import Session
    g = Graph()
    return g, Session(g, Cluster(device=device, **(jobs or {
        "ps": 2, "worker": 2})), default_device="worker:0")


def core_graph_cases(np, device) -> dict:
    """The test_core_engine graphs, run on one cluster whose every task is
    on ``device``: {case: (fetched values, bit-exact?)}."""
    import threading
    from repro_torch.core.control_flow import cond
    from repro_torch.core.gradients import gradients
    out = {}

    g, s = core_session(device)
    x = g.placeholder("x")
    w = g.apply("Variable", var_name="w", device="ps:0",
                initial=np.array([[1., 2.], [3., 4.]], np.float32))
    wv = g.apply("Read", w)
    loss = g.apply("ReduceMean", g.apply("Square", g.apply("MatMul", x, wv)))
    out["autodiff"] = (s.run([loss] + gradients(loss, [wv]),
                             {x: np.eye(2, dtype=np.float32)}), False)

    g, s = core_session(device)
    w = g.apply("Variable", var_name="w", initial=np.ones(3, np.float32),
                device="ps:1")
    s.run(g.apply("AssignAdd", w, g.constant(np.float32(2.0))))
    out["assign_add across tasks"] = ([s.run(g.apply("Read", w))], True)

    g, s = core_session(device)
    w = g.apply("Variable", var_name="emb", device="ps:0",
                initial=np.zeros((4, 2), np.float32))
    ids, rows = g.placeholder("ids"), g.placeholder("rows")
    s.run(g.apply("ScatterAdd", w, ids, rows),
          {ids: np.array([1, 1, 3, -1]),
           rows: np.arange(8, dtype=np.float32).reshape(4, 2)})
    out["scatter_add"] = ([s.run(g.apply("Read", w))], True)

    for pred in (True, False):
        g, s = core_session(device)
        p, a = g.placeholder("p"), g.placeholder("a")
        r = cond(p, lambda t: t * g.constant(2.0),
                 lambda f: f + g.constant(100.0), [a])
        out[f"switch/merge {pred}"] = (
            [s.run(r, {p: np.array(pred), a: np.array(3.0)})], True)

    # Figure 3 at its own width (rows of 2 floats) and at Figure 6's (16)
    for d in (2, 16):
        g, s = core_session(device)
        init = np.random.default_rng(d).normal(0, 1, (8, d)).astype(
            np.float32)
        e0 = g.apply("Variable", var_name="e0", initial=init[:4],
                     device="ps:0")
        e1 = g.apply("Variable", var_name="e1", initial=init[4:],
                     device="ps:1")
        ids = g.placeholder("ids")
        shard = g.apply("FloorDiv", ids, g.constant(4))
        l0, l1 = g.apply("DynamicPartition", ids, shard, num_partitions=2)
        i0, i1 = g.apply("DynamicPartitionIndices", shard, num_partitions=2)
        r0, r1 = g.apply("Read", e0), g.apply("Read", e1)
        g0 = g.apply("Gather", r0, l0)
        g1 = g.apply("Gather", r1, g.apply("Sub", l1, g.constant(4)))
        emb = g.apply("DynamicStitch", i0, i1, g0, g1, n=2)
        loss = g.apply("ReduceSum", g.apply("Mul", emb, emb))
        vals = s.run([emb] + gradients(loss, [r0, r1]),
                     {ids: np.array([0, 5, 3, 4, 5, 7, 1])})
        out[f"figure 3 d {d} lookup"] = (vals[:1], True)
        out[f"figure 3 d {d} gradients"] = (vals[1:], False)

    g, s = core_session(device)
    q = g.apply("FIFOQueue", queue_name="q", capacity=2, device="worker:1")
    item = g.placeholder("item")
    enq = g.apply("Enqueue", q, item)
    deq = g.apply("Dequeue", q)
    for v in (1.0, 2.0):
        s.run(enq, {item: np.array(v)})
    done = threading.Event()
    th = threading.Thread(target=lambda: (s.run(enq, {item: np.array(3.0)}),
                                          done.set()), daemon=True)
    th.start()
    check(not done.wait(0.2), f"{device}: enqueue did not block on a full "
          "queue")
    got = [s.run(deq)]
    check(done.wait(5.0), f"{device}: enqueue did not resume")
    out["queue"] = (got + [s.run(deq), s.run(deq)], True)

    g, s = core_session(device)
    a = g.apply("Variable", var_name="a", device="ps:0",
                initial=np.array([2.0], np.float32))
    c = g.apply("Mul", g.apply("Read", a), g.constant(np.float32(3.0)))
    c.op.device = "worker:1"
    out["send/recv"] = ([s.run(c)], True)
    (plan,) = s._plan_cache.values()
    check("Recv" in [op.type for op in plan.per_device["worker:1"].ops],
          f"{device}: no Recv in worker:1's plan")

    g, s = core_session(device)
    w = g.apply("Variable", var_name="ctr", device="ps:0",
                initial=np.zeros(1, np.float32))
    inc = g.apply("AssignAdd", w, g.constant(np.float32(1.0)))
    ths = [threading.Thread(target=lambda: s.run(inc), daemon=True)
           for _ in range(16)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    out["concurrent steps"] = ([s.run(g.apply("Read", w))], True)

    # the reference's faults: a second signature over partitioned ops, a
    # "ps:*" variable first placed by a plan that updates it alone
    g, s = core_session(device)
    v = g.apply("Variable", var_name="v", device="ps:0",
                initial=np.arange(4, dtype=np.float32).reshape(2, 2))
    r = g.apply("Read", v)
    with g.device("worker:0"):
        mm = g.apply("MatMul", r, r)
    out["fault 1: two signatures"] = ([s.run(mm)] + s.run([r, mm]), False)
    g, s = core_session(device)
    hs = [g.apply("Variable", var_name=f"w{i}", device="ps:*",
                  initial=np.zeros(2, np.float32)) for i in range(2)]
    s.run(g.apply("AssignAdd", hs[1], g.constant(np.float32(1.0))))
    out["fault 2: ps:* keeps its task"] = (
        s.run([g.apply("Read", h) for h in hs]), True)
    return out


def core_on_card(torch, np) -> None:
    """Phase 16a: the core's graphs on the card against the same graphs on
    the CPU (gathers, stitches, state and integer results bit for bit, the
    rest within CORE_TOL of the largest value), fetches on the card, and
    the card's clamped out-of-range Gather against the CPU's IndexError."""
    card, cpu = core_graph_cases(np, DEV), core_graph_cases(np, "cpu")
    worst = 0.0
    for name, (vals, exact) in card.items():
        want = cpu[name][0]
        check(len(vals) == len(want), f"core {name}: {len(vals)} fetches")
        for a, b in zip(vals, want):
            check(a.is_cuda, f"core {name}: a fetch left the card")
            a = a.cpu()
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"core {name}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
            if exact:
                check(torch.equal(a, b), f"core {name}: card != CPU")
            else:
                e = err(a, b) / max(float(b.abs().max()), 1e-30)
                worst = max(worst, e)
                check(e <= CORE_TOL, f"core {name}: card vs CPU {e}")
    check(float(card["fault 2: ps:* keeps its task"][0][1][0]) == 1.0,
          "core: the update to w1 was lost")
    table = np.random.default_rng(0).normal(0, 1, (3, 4)).astype(np.float32)
    got = {}
    for device in (DEV, "cpu"):
        g, s = core_session(device, worker=1)
        ids = g.placeholder("ids")
        out = g.apply("Gather", g.constant(table), ids)
        try:
            got[device] = s.run(out, {ids: np.array([0, 3, -4, 7, -1])})
        except IndexError as e:
            got[device] = e
    clamped = torch.from_numpy(table)[[0, 2, 0, 2, 2]]
    check(isinstance(got["cpu"], IndexError),
          f"core: the CPU Gather took an id out of range: {got['cpu']}")
    check(torch.is_tensor(got[DEV]) and torch.equal(got[DEV].cpu(), clamped),
          f"core: the card's Gather did not clamp: {got[DEV]}")
    print(f"[core] phase 16a: {len(card)} graphs card == CPU (exact where "
          f"marked; worst relative difference {worst:.3g}, limit "
          f"{CORE_TOL}); out-of-range Gather: card clamps to rows "
          "[0, 2, 0, 2, 2], CPU raises IndexError", flush=True)


def core_gather(torch, timer, gen, rows) -> None:
    """Phase 16b: the gather kernel at the core's float32 rows (4, 8, 64
    and 2048 bytes), 1, 32 and 4096 ids with negative and out-of-range
    ones: bit-equal to gather_plain (and the core's Gather to torch
    indexing, a 1-D vector included); times by events and profiler beside
    gather_plain, index_select and the bytes bound; the copy the sampled
    LM's Gather makes of a transposed shard."""
    from repro_torch.core import ops as cops
    from repro_torch.kernels import embedding as emb
    row = rows["gather"]
    for d, V, what in CORE_ROWS:
        table = torch.randn((V, d), generator=gen, device=DEV)
        path = emb.path(table)
        check(path == ("words" if d * 4 % 16 else "vector"),
              f"gather path {path} at rows of {d * 4} bytes")
        edge = torch.tensor([0, V - 1, -1, V, -V, -V - 1, 2 ** 31 - 1,
                             -(2 ** 31)], dtype=torch.int32, device=DEV)
        ids = {T: torch.randint(-V, V, (T,), generator=gen, device=DEV,
                                dtype=torch.int32) for T in CORE_IDS}
        for name, i in [(f"{T} ids", x) for T, x in ids.items()] + [
                ("edge ids", edge)]:
            check(torch.equal(emb.gather(table, i),
                              emb.gather_plain(table, i)),
                  f"gather != gather_plain at rows of {d * 4} bytes, {name}")
        core_in = table[:, 0].contiguous() if d == 1 else table
        check(torch.equal(cops.gather(core_in, ids[4096].long()),
                          core_in[ids[4096].long()]),
              f"core Gather at rows of {d * 4} bytes")
        t = {}
        for T, i in ids.items():
            rows_T = torch.where(i < 0, i + V, i).long()   # in [0, V)
            t[f"ms_{T}"] = timer(lambda: emb.gather(table, i))
            t[f"library_ms_{T}"] = timer(
                lambda: torch.index_select(table, 0, rows_T))
            t[f"plain_ms_{T}"] = timer(lambda: emb.gather_plain(table, i))
            t[f"device_ms_{T}"] = timer.device(
                lambda: emb.gather(table, i))
            t[f"library_device_ms_{T}"] = timer.device(
                lambda: torch.index_select(table, 0, rows_T))
            t[f"bound_ms_{T}"] = bound_ms(2 * T * d * 4 + T * 4, 0.0)[0]
        print(f"[core-gather] rows of {d * 4} bytes ({what}, {V} x {d} "
              f"float32, {path} path; device times None where the "
              "profiler's trace failed its check): " + ", ".join(
                  f"{k} {v:.5f}" if v is not None else f"{k} None"
                  for k, v in t.items()), flush=True)
        row.update({f"core_{d * 4}B_{k}": t[k] for k in (
            "ms_4096", "device_ms_4096", "plain_ms_4096",
            "library_device_ms_4096", "bound_ms_4096")})
        del table
    shard = torch.randn((FIG9["d"], FIG9["vocab"] // 2), generator=gen,
                        device=DEV)
    copy_ms = timer(lambda: shard.t().contiguous())
    ids = torch.randint(0, FIG9["vocab"] // 2, (FIG9["n_sampled"] // 2,),
                        generator=gen, device=DEV)
    via_core = timer(lambda: cops.gather(shard.t(), ids))
    row["core_transposed_shard_copy_ms"] = copy_ms
    print(f"[core-gather] the sampled LM's Gather from Transpose(shard) "
          f"({FIG9['d']} x {FIG9['vocab'] // 2}): contiguous copy "
          f"{copy_ms:.5f} ms of the Gather's {via_core:.5f} ms (events)",
          flush=True)


def fig9_trainer(np, softmax, n_ps, mode="async", workers=None,
                 job_devices=None, device=None):
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.graph import Graph
    from repro_torch.ps.lm import lstm_lm_model
    from repro_torch.ps.training import PSTrainer
    f = FIG9
    workers = workers or f["workers"]
    g = Graph()
    cl = Cluster(device=device or DEV, job_devices=job_devices, ps=n_ps,
                 worker=workers)
    model = lstm_lm_model(g, vocab=f["vocab"], d=f["d"], unroll=f["unroll"],
                          n_ps=n_ps, softmax=softmax,
                          n_sampled=f["n_sampled"])
    return cl, PSTrainer(model, cl, mode=mode, n_workers=workers, lr=0.05)


def device_ms(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def fig9_run(torch, np, softmax, n_ps, job_devices=None) -> dict:
    """Async, two workers: one warm-up step that builds every plan, then
    FIG9["steps"] steps timed, then two under torch.profiler (the card's
    busy share: device time over wall)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ps.lm import lm_batch_fn
    f = FIG9
    cl, tr = fig9_trainer(np, softmax, n_ps, job_devices=job_devices)
    batches = lm_batch_fn(f["vocab"], f["batch"], f["unroll"])
    tr.train(1, batches)
    torch.cuda.synchronize()
    cl.rendezvous.reset_moves()
    t0 = time.perf_counter()
    tr.train(f["steps"], batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = f["steps"] * f["workers"]
    rv = cl.rendezvous
    res = dict(words_s=n * f["batch"] / wall, step_ms=wall / n * 1e3,
               moved_mb_per_step=rv.moved_bytes / n / 1e6,
               copy_ms_per_step=rv.moved_s / n * 1e3,
               copies_per_step=rv.moves / n,
               loss_first=tr.stats.losses[0], loss_last=tr.stats.losses[-1])
    x, y, loss, grads = tr.replicas[0]
    plan = tr.session.plan([loss] + grads, [], {x: 0, y: 0})
    res["ops_per_replica_step"] = sum(len(p.ops)
                                      for p in plan.per_device.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(2, batches)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    res["busy_share"] = device_ms(prof) / (pwall * 1e3)
    check(all(math.isfinite(v) for v in tr.stats.losses),
          f"fig9 {softmax} ps {n_ps}: a loss is not finite")
    return res


def fig9_card_vs_cpu(torch, np, softmax) -> float:
    """One sync 1-worker step's loss and gradients (n_ps 2) on the card
    against the same step on the CPU: each value's max difference within
    FIG9_TOL of its max magnitude. Returns the worst ratio."""
    from repro_torch.ps.lm import lm_batch_fn
    f = FIG9
    vals = {}
    for device in (DEV, "cpu"):
        _, tr = fig9_trainer(np, softmax, 2, mode="sync", workers=1,
                             device=device)
        x, y, loss, grads = tr.replicas[0]
        xv, yv = lm_batch_fn(f["vocab"], f["batch"], f["unroll"])(0, 0)
        vals[device] = [v.cpu() for v in tr.session.run([loss] + grads,
                                                        {x: xv, y: yv})]
    worst = 0.0
    for i, (a, b) in enumerate(zip(vals[DEV], vals["cpu"])):
        e = err(a, b) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, e)
        check(e <= FIG9_TOL, f"fig9 {softmax}: fetch {i} card vs CPU {e}")
    return worst


def fig9_host(torch, np) -> dict:
    """Where Figure 9's host time goes (full softmax, 2 PS tasks): one
    replica step alone from one client thread (its plan still runs a
    thread per task, handing values over through the rendezvous), at the
    interpreter's 5 ms switch interval and at 0.2 ms; and the async
    two-worker run again at 0.2 ms."""
    from repro_torch.ps.lm import lm_batch_fn
    f = FIG9
    _, tr = fig9_trainer(np, "full", 2)
    x, y, loss, grads = tr.replicas[0]
    xv, yv = lm_batch_fn(f["vocab"], f["batch"], f["unroll"])(0, 0)
    out = {}
    old = sys.getswitchinterval()
    try:
        for interval in (old, 2e-4):
            sys.setswitchinterval(interval)
            float(tr.session.run([loss] + grads, {x: xv, y: yv})[0])
            t0 = time.perf_counter()
            for _ in range(5):
                float(tr.session.run([loss] + grads, {x: xv, y: yv})[0])
            out[f"replica_alone_ms_switch_{interval * 1e3:g}ms"] = (
                time.perf_counter() - t0) / 5 * 1e3
        out["async2_switch_0.2ms"] = fig9_run(torch, np, "full", 2)
    finally:
        sys.setswitchinterval(old)
    return out


def figure9(torch, np, card) -> dict:
    """Phase 16c."""
    out = {}
    for softmax in ("full", "sampled"):
        for n_ps in (1, 2, 4):
            r = fig9_run(torch, np, softmax, n_ps)
            out[f"{softmax}_ps{n_ps}"] = r
            print(f"[fig9] {softmax} softmax, ps {n_ps}, async 2 workers "
                  f"(V {FIG9['vocab']}, d {FIG9['d']}, batch "
                  f"{FIG9['batch']}, unroll {FIG9['unroll']}): "
                  + json.dumps(r) + f"; {card}", flush=True)
            free(torch)
    out["host"] = fig9_host(torch, np)
    print("[fig9] host time, full softmax, ps 2: " + json.dumps(out["host"]),
          flush=True)
    free(torch)
    for softmax in ("full", "sampled"):
        worst = fig9_card_vs_cpu(torch, np, softmax)
        out[f"{softmax}_card_vs_cpu"] = worst
        print(f"[fig9] {softmax}: one sync step's loss and gradients, card "
              f"vs CPU: worst max|diff| / max|value| {worst:.3g} (limit "
              f"{FIG9_TOL})", flush=True)
        free(torch)
    for softmax in ("full", "sampled"):
        r = fig9_run(torch, np, softmax, 2, job_devices={"ps": "cpu"})
        out[f"{softmax}_ps_on_cpu"] = r
        print(f"[fig9] {softmax} softmax, ps 2 on the CPU, workers on the "
              f"card: " + json.dumps(r), flush=True)
        free(torch)
    return out


def figure6(torch, np) -> dict:
    """Phase 16d: null steps of synchronous replication (the JAX
    package's bench_fig6_null_step): 4 PS tasks; scalar, dense 100 MB and
    1 GB, sparse (a 1 GB table of 16-float rows, 32 rows gathered and
    scatter-added a step) with 1, 2, 4 and 8 client threads on one plan:
    median step ms."""
    import threading
    n_ps = FIG6_PS
    out = {}
    for variant, shp in FIG6_SHAPES.items():
        for n_workers in (1, 2, 4, 8):
            g, sess = core_session(DEV, ps=n_ps, worker=n_workers)
            reads, updates = [], []
            for i in range(n_ps):
                h = g.apply("Variable", var_name=f"w{i}", device=f"ps:{i}",
                            initial=np.zeros(shp, np.float32))
                if variant.startswith("sparse"):
                    ids = g.constant(np.arange(32) % shp[0])
                    rd = g.apply("Gather", g.apply("Read", h), ids)
                    rd.op.colocation = h.op.name
                    upd = g.apply("ScatterAdd", h, ids, g.constant(
                        np.ones((32, 16), np.float32) * 1e-6))
                else:
                    rd = g.apply("Read", h)
                    upd = g.apply("AssignAdd", h,
                                  g.constant(np.float32(1e-6)))
                reads.append(rd)
                updates.append(upd)
            fetch = [g.apply("ReduceSum", r) for r in reads] + updates
            sess.run(fetch)
            torch.cuda.synchronize()
            times = []

            def loop():
                for _ in range(FIG6_STEPS):
                    t0 = time.perf_counter()
                    vals = sess.run(fetch)
                    float(vals[0])
                    times.append(time.perf_counter() - t0)

            ths = [threading.Thread(target=loop, daemon=True)
                   for _ in range(n_workers)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            out[f"{variant}_w{n_workers}"] = statistics.median(times) * 1e3
            del g, sess, reads, updates, fetch
            free(torch)
        print(f"[fig6] {variant} {shp} x {n_ps} PS: median step ms by "
              "workers 1/2/4/8: " + " / ".join(
                  f"{out[f'{variant}_w{n}']:.3f}" for n in (1, 2, 4, 8)),
              flush=True)
    return out


def fig7_batches(np, dim_in, dim_out):
    W = np.random.default_rng(0).normal(0, 1, (dim_in, dim_out)).astype(
        np.float32)

    def batch_fn(w, s):
        x = np.random.default_rng((1, w, s)).normal(0, 1, (dim_in, dim_in)
                                                    ).astype(np.float32)
        return x, (x @ W).argmax(-1)
    return batch_fn


def figures7_8(torch, np) -> dict:
    """Phase 16e: the JAX package's bench_fig7_scaling (linear_model 64 ->
    32 over 2 PS, async and sync, 1-8 workers, 10 steps: examples/s) and
    bench_fig8_backup_workers (32 -> 16, 6 workers, a 30 ms straggler every
    3rd (worker, step), 0-3 backups, 8 steps: median step, normalized
    speedup, discards)."""
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.graph import Graph
    from repro_torch.ps.training import PSTrainer, linear_model
    out = {}
    batch_fn = fig7_batches(np, 64, 32)
    for mode in ("async", "sync"):
        for n in (1, 2, 4, 8):
            g = Graph()
            tr = PSTrainer(linear_model(g, 64, 32, 2),
                           Cluster(device=DEV, ps=2, worker=n),
                           mode=mode, n_workers=n, lr=0.1)
            t0 = time.perf_counter()
            stats = tr.train(10, batch_fn)
            wall = time.perf_counter() - t0
            steps = 10 * (n if mode == "async" else 1)
            out[f"fig7_{mode}_w{n}"] = steps * 64 / wall
            check(all(math.isfinite(v) for v in stats.losses),
                  f"fig7 {mode} {n}: a loss is not finite")
    print("[fig7] examples/s by workers 1/2/4/8 (wall incl. plan builds): "
          + "; ".join(f"{m} " + " / ".join(
              f"{out[f'fig7_{m}_w{n}']:.0f}" for n in (1, 2, 4, 8))
              for m in ("async", "sync")), flush=True)
    batch_fn = fig7_batches(np, 32, 16)
    t_sync = None
    for b in (0, 1, 2, 3):
        g = Graph()
        tr = PSTrainer(linear_model(g, 32, 16, 2),
                       Cluster(device=DEV, ps=2, worker=6),
                       mode="backup" if b else "sync", n_workers=6,
                       backup_workers=b, lr=0.1, straggler_s=0.03,
                       straggler_every=3)
        stats = tr.train(8, batch_fn)
        med = statistics.median(stats.step_times)
        t_sync = t_sync or med
        out[f"fig8_b{b}"] = dict(step_ms=med * 1e3,
                                 normalized_speedup=t_sync / med * (6 - b)
                                 / 6, discarded=stats.discarded)
    print("[fig8] backups 0/1/2/3: " + json.dumps(
        {k: v for k, v in out.items() if k.startswith("fig8")}), flush=True)
    return out


def dispatch_rate(torch, np) -> dict:
    """Phase 16f: 2,000 chained Identity ops on one task of the card, five
    runs of the cached plan: null ops/s against the paper's 2,000,000 (§5);
    then 2,000 chained Neg ops (a kernel launch each) the same way."""
    out = {}
    for op in ("Identity", "Neg"):
        g, sess = core_session(DEV, worker=1)
        x = g.constant(np.float32(1.0))
        for _ in range(2000):
            x = g.apply(op, x)
        sess.run(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            float(sess.run(x))
        out[f"{op}_ops_s"] = 2000 * 5 / (time.perf_counter() - t0)
    print(f"[dispatch] 2,000 chained ops, cached plan, one card task: "
          f"Identity {out['Identity_ops_s']:.0f} ops/s, Neg (one launch "
          f"each) {out['Neg_ops_s']:.0f} ops/s; the paper: 2,000,000 null "
          "ops/s", flush=True)
    return out


def core_phase(torch, counters, card, rows, gather_checked=False) -> dict:
    """Phase 16: the dataflow core and the parameter-server trainer on the
    card (16b too unless phase 2 ran it: ``gather_checked``). Returns the
    run whose launches count: figures 9 and 6 (the gather kernel through
    the core's Gather)."""
    import numpy as np
    t0 = time.monotonic()
    core_on_card(torch, np)
    if not gather_checked:
        timer = Timer(torch)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(16)
        core_gather(torch, timer, gen, rows)
        del timer
        free(torch)
    print(f"[time] phase 16ab {time.monotonic() - t0:.1f} s", flush=True)
    reset_launches(counters)
    fig9 = figure9(torch, np, card)
    fig6 = figure6(torch, np)
    launches = read_launches(counters)
    check(launches.get("gather", 0) > 0,
          "phase 16: the core's Gather never launched the gather kernel")
    print(f"[time] phase 16cd {time.monotonic() - t0:.1f} s; gather "
          f"launches {launches['gather']}", flush=True)
    rest = {**figures7_8(torch, np), **dispatch_rate(torch, np)}
    elapsed = time.monotonic() - t0
    print(f"[time] phase 16 {elapsed:.1f} s", flush=True)
    check(elapsed < 120, f"phase 16 took {elapsed:.1f} s (limit 120)")
    return {"launches": launches, "fig9": fig9, "fig6": fig6, **rest}


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel paged serving and the kernels' partials
# ---------------------------------------------------------------------------

# a partial's lse where it attended nothing: -1e30 (below this counts)
EMPTY_LSE = -1e29


def check_lse(torch, name, lse_k, lse_p) -> float:
    """Kernel vs plain lse: the same rows empty (<= EMPTY_LSE), the others
    within LSE_TOL. Returns the max abs err over the non-empty rows."""
    empty = lse_p <= EMPTY_LSE
    check(torch.equal(lse_k <= EMPTY_LSE, empty),
          f"{name}: the kernel and the plain version attend nothing in "
          "different rows")
    live = ~empty
    e = float((lse_k - lse_p)[live].abs().max()) if bool(live.any()) \
        else 0.0
    check(e <= LSE_TOL, f"{name}: lse max abs err {e} (limit {LSE_TOL})")
    return e


def live_keys(torch, ctx, mask, bs, q_lens=None, C=None) -> int:
    """Keys a partial attends: decode (q_lens None), each sequence's keys
    before ctx on unmasked pages; chunk, its causal (row, key) pairs on
    unmasked pages over the rows before q_len."""
    total = 0
    for b, c in enumerate(ctx):
        ok = mask[b].repeat_interleave(bs)[:max(c, 0)].bool()
        if q_lens is None:
            total += int(ok.sum())
            continue
        cum = torch.cumsum(ok.long(), 0)
        q0 = c - q_lens[b]
        total += sum(int(cum[q0 + i]) for i in range(q_lens[b]))
    return total


def check_partials(torch, timer, gen, rows, counters) -> dict:
    """Phase 17a: the decode and chunk kernels' block_mask / return_lse
    partials at glm4_9b's widths (H 32, K 2, hd 128, 16-token pages) over
    bf16, int8 and fp8 pools, against their plain versions
    (``ref.paged_attention_partial_ref``,
    ``ref.paged_prefill_attention_partial_ref``): o rows within TOL, lse
    within LSE_TOL, the same rows empty; a full mask's o rounded to bf16
    byte-equal to the plain launch; pages_per_compute_block 2 == 1 byte
    for byte; ``paged_shard_attention`` over 1-4 shards against the
    unsharded kernel within TOL. Rows "<kernel>_partial",
    "<kernel>_<pool>_partial" with times and bounds. Then the variants'
    entry points, counted (the counters zeroed before): paged_shard_attention
    over 2 shards and ``ops.paged_prefill_attention_partial`` once per
    pool. Returns that run ({"launches": ...})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import paged_shard_attention

    H, K, hd, bs = 32, 2, 128, 16
    ctx = [2048, 1536, 1024, 777, 2000, 1, 0, 300]
    B, nb = len(ctx), 2048 // bs
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb,
                                         ctx)
    mask = (torch.rand((B, nb), generator=gen, device=DEV) < 0.5).to(
        torch.int32)
    mask[3] = 0                      # a sequence this shard holds nothing of
    full = torch.ones_like(mask)
    # chunks: 256 rows ending at 2048 keys (200 valid), and 256 from 444
    Cc, qls, ctc = 256, [200, 256], [2048, 700]
    qc, kc16, vc16, btc, ctxc = paged_case(torch, gen, 2, H, K, hd, bs, nb,
                                           ctc, C=Cc)
    qlc = torch.tensor(qls, dtype=torch.int32, device=DEV)
    maskc = (torch.rand((2, nb), generator=gen, device=DEV) < 0.5).to(
        torch.int32)
    fullc = torch.ones_like(maskc)
    # the key rows each launch reads (before ctx, on unmasked pages) and
    # the (row, key) pairs it attends
    n_dec = live_keys(torch, ctx, mask.cpu(), bs)
    n_chk = live_keys(torch, ctc, maskc.cpu(), bs)
    pairs_chk = live_keys(torch, ctc, maskc.cpu(), bs, qls)
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        # decode
        o_k, l_k = pa.paged_attention(q, kp, vp, bt, ctxt, block_mask=mask,
                                      return_lse=True, **sc)
        o_p, l_p = ref.paged_attention_partial_ref(q, kp, vp, bt, ctxt, mask,
                                                   **sc)
        e, rel = check_close(f"paged_attention partial[{kv}] vs plain", o_k,
                             o_p)
        e_l = check_lse(torch, f"paged_attention partial[{kv}]", l_k, l_p)
        check(bool((o_k[3] == 0).all() and (o_k[6] == 0).all()),
              f"paged_attention partial[{kv}]: an empty row is not zero")
        o_f, _ = pa.paged_attention(q, kp, vp, bt, ctxt, block_mask=full,
                                    return_lse=True, **sc)
        o_b = pa.paged_attention(q, kp, vp, bt, ctxt, **sc)
        check(same_bytes(o_f.bfloat16(), o_b),
              f"paged_attention partial[{kv}]: a full mask's o in bf16 is "
              "not the plain launch's bytes")
        o_2, l_2 = pa.paged_attention(q, kp, vp, bt, ctxt, block_mask=mask,
                                      return_lse=True,
                                      pages_per_compute_block=2, **sc)
        check(same_bytes(o_2, o_k) and same_bytes(l_2, l_k),
              f"paged_attention partial[{kv}]: P = 2 != P = 1")
        for n in (1, 2, 3, 4):
            check_close(f"paged_shard_attention[{kv}] n={n} vs the "
                        "unsharded kernel",
                        paged_shard_attention(q, kp, vp, bt, ctxt, n, **sc),
                        o_b)
        b_dec = (q.numel() * 2 + 2 * n_dec * kv_row_bytes(kv, K, hd)
                 + o_k.numel() * 4 + l_k.numel() * 4 + 2 * bt.numel() * 4
                 + B * 4)
        rows[variant("paged_attention", pa.launch_key(kv, True))] = dict(
            kernel="paged_attention", source=DECODE_SRC, max_abs_err=e,
            max_row_rel_err=rel, lse_max_abs_err=e_l,
            **timed(timer, lambda: pa.paged_attention(
                        q, kp, vp, bt, ctxt, block_mask=mask,
                        return_lse=True, **sc),
                    lambda: ref.paged_attention_partial_ref(
                        q, kp, vp, bt, ctxt, mask, **sc)),
            library_ms=None,
            shape=f"B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx}, "
                  f"{int(mask.sum())} of {mask.numel()} table entries "
                  f"attended ({n_dec} keys)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_dec, 4.0 * n_dec * H * hd))))
        # chunk
        kp, vp, sc = pools_in(kv, kc16, vc16)
        o_k, l_k = pa.paged_prefill_attention(
            qc, kp, vp, btc, ctxc, qlc, block_mask=maskc, return_lse=True,
            **sc)
        o_p, l_p = ref.paged_prefill_attention_partial_ref(
            qc, kp, vp, btc, ctxc, qlc, maskc, **sc)
        e, rel = check_close(f"paged_prefill_attention partial[{kv}] vs "
                             "plain", o_k, o_p)
        e_l = check_lse(torch, f"paged_prefill_attention partial[{kv}]", l_k,
                        l_p)
        check(bool((o_k[0, 200:] == 0).all()),
              f"paged_prefill_attention partial[{kv}]: padding rows not "
              "zero")
        o_f, _ = pa.paged_prefill_attention(qc, kp, vp, btc, ctxc, qlc,
                                            block_mask=fullc,
                                            return_lse=True, **sc)
        check(same_bytes(o_f.bfloat16(), pa.paged_prefill_attention(
                  qc, kp, vp, btc, ctxc, qlc, **sc)),
              f"paged_prefill_attention partial[{kv}]: a full mask's o in "
              "bf16 is not the plain launch's bytes")
        o_2, l_2 = pa.paged_prefill_attention(
            qc, kp, vp, btc, ctxc, qlc, block_mask=maskc, return_lse=True,
            pages_per_compute_block=2, **sc)
        check(same_bytes(o_2, o_k) and same_bytes(l_2, l_k),
              f"paged_prefill_attention partial[{kv}]: P = 2 != P = 1")
        b_chk = (qc.numel() * 2 + 2 * n_chk * kv_row_bytes(kv, K, hd)
                 + o_k.numel() * 4 + l_k.numel() * 4 + 2 * btc.numel() * 4
                 + 16)
        rows[variant("paged_prefill_attention",
                     pa.launch_key(kv, True))] = dict(
            kernel="paged_prefill_attention", source=DECODE_SRC,
            max_abs_err=e, max_row_rel_err=rel, lse_max_abs_err=e_l,
            **timed(timer, lambda: pa.paged_prefill_attention(
                        qc, kp, vp, btc, ctxc, qlc, block_mask=maskc,
                        return_lse=True, **sc),
                    lambda: ref.paged_prefill_attention_partial_ref(
                        qc, kp, vp, btc, ctxc, qlc, maskc, **sc)),
            library_ms=None,
            shape=f"B=2 C={Cc} q_lens={qls} ctx={ctc} H={H} K={K} hd={hd}, "
                  f"{int(maskc.sum())} of {maskc.numel()} table entries "
                  f"attended ({pairs_chk} row-key pairs)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_chk, 4.0 * pairs_chk * H * hd))))
        for name in ("paged_attention", "paged_prefill_attention"):
            r = rows[variant(name, pa.launch_key(kv, True))]
            print(f"[kernels] {name} partial [{kv}]: {r['shape']}: device "
                  f"{fmt(r['device_ms'])} ms (events {r['ms']:.5f}), plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']}); o max row rel err "
                  f"{r['max_row_rel_err']:.3g}, lse {r['lse_max_abs_err']:.3g}"
                  "; full mask == plain launch, P 2 == P 1 bit for bit",
                  flush=True)
    print(f"[kernels] paged_shard_attention over 1-4 shards within {TOL} of "
          f"the unsharded kernel over {'/'.join(KV_DTYPES)} pools",
          flush=True)
    # the variants' entry points, counted
    reset_launches(counters)
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        paged_shard_attention(q, kp, vp, bt, ctxt, 2, **sc)
        kp, vp, sc = pools_in(kv, kc16, vc16)
        ops.paged_prefill_attention_partial(qc, kp, vp, btc, ctxc, qlc,
                                            maskc, **sc)
    torch.cuda.synchronize()
    run = {"launches": read_launches(counters)}
    for kv in KV_DTYPES:
        for name, want in (("paged_attention", 2),
                           ("paged_prefill_attention", 1)):
            got = run["launches"].get(
                variant(name, pa.launch_key(kv, True)), 0)
            check(got == want, f"{name} partial [{kv}]: {got} launches "
                  f"from its entry point, not {want}")
    return run


# phase 17's tensor-parallel runs: (arch, layers or None for the full
# depth, new tokens a request); glm4_9b serves phase 3's whole traffic (32
# new tokens a request) at 20 of its 40 layers (the depth cut for the
# whole run's time limit since phase 18; the check is bit equality, at
# any depth), zamba2 one 6-layer period of its 54, whisper 4 + 4 of its
# 32 + 32
TP_RUNS = (("glm4_9b", 20, 32), ("zamba2_2p7b", 6, 16),
           ("whisper_large_v3", 4, 32))
TP_WORLD = 2
TP_TIMEOUT_S = 600
# phase 19's sharded-weights runs on the same ranks (shard_params=True,
# model=TP_WORLD): (arch, layers, new tokens a request, expert_ff_2d), at
# full width and phase 3's traffic; qwen3_moe at 12 of its 48 layers and
# grok1 at 2 of its 64 (the depths cut for the whole run's time limit),
# glm4 at phase 17's depth (its tp = 1 run is phase 17's)
SHARD_RUNS = (("qwen3_moe_30b_a3b", 12, 32, False), ("glm4_9b", 20, 32, False),
              ("grok1_314b", 2, 32, True))
MOE_MESH = "moe_block"           # phase 19d's case among the rank's runs
PHASE19_DIR = ROOT / "build" / "phase19"
# a sharded rank holds at most this share of tp = 1's weight bytes
SHARD_WEIGHT_SHARE = 0.55
# phase 19's gates: a sharded run's logits rows (and a MoE model's router
# log-probabilities) at most this many times the floor measured in the
# same run, its base against the base with one-ulp flips in FLIP_SHARE of
# its embedding outputs (a bf16 path's noise, amplified over the layers);
# 19b's control, rank 1's wo of layer CONTROL_LAYER zeroed (that layer's
# attention half left out), must land past it
SHARD_FLOOR_FACTOR = 2
CONTROL_LAYER, CONTROL_NEW = 10, 4
# the engine stats both ranks of a tensor-parallel run must share with the
# tp = 1 run, value for value
SCHED_STATS = ("steps", "prefill_chunks", "preemptions", "tokens",
               "prefill_tokens", "quantum_dropped_tokens", "cache_hit_tokens",
               "cow_copies", "requests", "requests_done", "spec_decodes",
               "spec_emitted", "stop_hits", "full_sampling_steps",
               "peak_block_utilization", "peak_blocks_in_use", "aborts",
               "swap_preemptions", "swap_ins", "encodes")


def tp_case(arch, layers, max_new):
    """(config, requests, engine keywords) of one phase-17 run: ``arch``
    at ``layers`` layers (None: all), ``max_new`` tokens a request."""
    import dataclasses

    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.serving import Request

    cfg = get_config(arch)
    if layers is not None:
        change = {"num_layers": layers}
        if cfg.encoder_layers:
            change["encoder_layers"] = layers
        cfg = dataclasses.replace(cfg, **change)
    kw = dict(max_batch=8, block_size=16, max_len=1024,
              max_num_batched_tokens=8 + 256, seed=0)
    if cfg.encoder_layers:
        rng = np.random.default_rng(0)
        reqs = [Request(rng.integers(0, cfg.vocab_size, 128).astype(np.int32),
                        max_new=max_new, frames=rng.normal(
                            0, 1, (cfg.encoder_seq_len, cfg.d_model)).astype(
                            np.float32)) for _ in range(8)]
        kw["max_len"] = 256
    else:
        reqs = [Request(p, max_new=max_new) for p in phase3_traffic(cfg)]
    return cfg, reqs, kw


def kv_head_bytes(cache) -> int:
    """Bytes of the cache leaves that shard by kv head (pools, their
    scales, the cross K/V)."""
    from repro_torch.spmd.sharding import KV_HEAD_LEAVES
    total = 0
    for name, t in cache.items():
        if isinstance(t, dict):
            total += kv_head_bytes(t)
        elif name in KV_HEAD_LEAVES:
            total += t.numel() * t.element_size()
    return total


def digest(torch, x):
    """An int64 digest of ``x``'s bits along its last axis (a 0-d tensor
    for a vector), on x's device: any changed bit changes it."""
    bits = x.contiguous()
    bits = bits.view({2: torch.int16, 4: torch.int32}[bits.element_size()])
    w = torch.arange(bits.shape[-1], device=bits.device) % 1021 + 1
    return (bits.to(torch.int64) * w).sum(-1)


@contextlib.contextmanager
def block_digests(torch, sink):
    """While active, every decoder block half of ``models.transformer``
    appends digests to ``sink``: the attention's output before
    ``out_proj``, the attention half's output, the MLP half's output, in
    call order (device tensors)."""
    from repro_torch.models import transformer as tr

    attn_part, mlp_part = tr._attn_part, tr._mlp_part

    def attn(lp, x, cfg, attend):
        def attend_digested(h):
            o = attend(h)
            sink.append(digest(torch, o.reshape(-1)))
            return o
        y = attn_part(lp, x, cfg, attend_digested)
        sink.append(digest(torch, y.reshape(-1)))
        return y

    def mlp(lp, x, cfg, *args, **kw):
        y = mlp_part(lp, x, cfg, *args, **kw)
        sink.append(digest(torch, (y if torch.is_tensor(y) else y[0])
                           .reshape(-1)))
        return y

    tr._attn_part, tr._mlp_part = attn, mlp
    try:
        yield sink
    finally:
        tr._attn_part, tr._mlp_part = attn_part, mlp_part


def record_steps(torch, eng, keep_rows=False) -> dict:
    """Make ``eng`` (eager) read every step's fp32 logits and block
    digests. Returns the record it fills: "tokens" {(rid, i): [logits
    row digest, top-2 margin, top-1 id, top-2 id]} for each token i a
    request emitted, "blocks" [per step: block digests]; with
    ``keep_rows``, "emitted" {(rid, i): that fp32 logits row on the
    host}; "route", a ``models.moe_replay.RouteRecord`` told the rows of
    every step (the decode batch's and the chunk row's MoE calls told
    apart by their row counts), which the caller installs."""
    from repro_torch.models.moe_replay import RouteRecord
    rec = {"tokens": {}, "blocks": [], "emitted": {}, "route": RouteRecord()}
    pending, sink = [], []
    run_step, step, forward = eng._run_step, eng._step, eng._forward

    def forward_read(has_chunk, mode="greedy"):
        with block_digests(torch, sink):
            out = forward(has_chunk, mode)
        eng._read_logits = out["logits"].float()
        return out

    def run_step_read(plan):
        rec["route"].begin_step({
            eng.max_batch: {s: (r.rid, r.num_computed)
                            for s, r in plan.decodes},
            eng.chunk_width: {i: (r.rid, r.num_computed + i)
                              for _, r, n in plan.chunks for i in range(n)}})
        out = run_step(plan)
        lg = eng._read_logits
        top = torch.topk(lg, 2, dim=-1)
        fp = digest(torch, lg).tolist()
        vals, ids = top.values.tolist(), top.indices.tolist()
        rows = [(s, r) for s, r in plan.decodes] + [
            (eng.max_batch + i, r) for i, (_, r, _) in enumerate(plan.chunks)]
        for row, req in rows:
            pending.append((req, len(req.out), [
                fp[row], vals[row][0] - vals[row][1], ids[row][0],
                ids[row][1]], lg[row] if keep_rows else None))
        rec["blocks"].append(torch.stack(sink).tolist() if sink else [])
        sink.clear()
        return out

    def step_read():
        ran = step()
        for req, n, row, lg in pending:
            if len(req.out) > n:
                rec["tokens"][(req.rid, n)] = row
                if lg is not None:
                    rec["emitted"][(req.rid, n)] = lg.cpu()
        pending.clear()
        return ran

    eng._run_step, eng._step, eng._forward = (run_step_read, step_read,
                                              forward_read)
    return rec


def tp_serve(torch, counters, cfg, reqs, kw, mesh=None, opts=None) -> dict:
    """One eager engine run of ``reqs`` (rank 0 or a follower of a mesh,
    or tp = 1): tokens, scheduling stats, kv-head bytes, tok/s, launches,
    weight bytes, MoE mode counts, and what ``record_steps`` read ("rows":
    "request:token" -> [logits row digest, top-2 margin, top-1, top-2],
    request in ``reqs`` order; "blocks": per step, the block digests).
    ``opts``: "shard" (``shard_params=True``: the engine draws the seed-0
    weights and cuts each part as it is drawn), "f2d" (``expert_ff_2d``),
    "rows" (a label: rank 0 saves every emitted token's fp32 logits row
    under ``PHASE19_DIR``, "rows_file"; a MoE run saves its routing there
    too, ``models.moe_replay.RouteRecord.state()``, "route_file"), "flip"
    (inside ``flipped_embedding``: a noise floor), "replay" (tp = 1: the
    file of a mesh's merged routing, which the MoE blocks replay with the
    mesh's capacity rule on a "model" axis of TP_WORLD; "missing", the
    calls it did not hold), "control" (phase 19b's control: rank 1's
    ``wo`` of layer CONTROL_LAYER zeroed, its partial of that layer's
    attention left out of the sum), "tag" (the run's key suffix)."""
    import contextlib
    from repro_torch.config import ParallelConfig
    from repro_torch.models import moe, moe_replay
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine

    opts = opts or {}
    if opts.get("flip"):
        with flipped_embedding(torch, 29):
            return tp_serve(torch, counters, cfg, reqs, kw, mesh,
                            dict(opts, flip=False))
    shard = bool(opts.get("shard"))
    params = None if shard else init_model(cfg, 0, DEV)
    eng = InferenceEngine(cfg, device=DEV, params=params, mesh=mesh,
                          pcfg=ParallelConfig(remat="none",
                                              expert_ff_2d=opts.get("f2d",
                                                                    False)),
                          shard_params=shard, cuda_graphs=False, **kw)
    lead = eng.group is None or eng.group.rank == 0
    if opts.get("control") and not lead:
        eng.params["layers"][CONTROL_LAYER]["attn"]["wo"].zero_()
    rec = record_steps(torch, eng, keep_rows=bool(opts.get("rows")) and lead)
    route, replay = rec["route"], None
    if opts.get("replay"):
        replay = moe_replay.Replay(torch.load(opts["replay"]), route,
                                   TP_WORLD, opts.get("f2d", False))
    elif cfg.moe is not None:
        moe.route_tap = route.tap
    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with (moe_replay.replaying(replay) if replay is not None
              else contextlib.nullcontext()):
            if lead:
                out = eng.run(reqs)
                eng.close()
                rids = [r.rid for r in reqs]
            else:
                out = eng.follow()            # rank 0's rids, in its order
                rids = sorted(out)
    finally:
        moe.route_tap = None
    torch.cuda.synchronize()
    order = {rid: i for i, rid in enumerate(rids)}
    route.rename(order)
    s = eng.stats
    res = {"tokens": [out[rid].tolist() for rid in rids],
           "prompts": [len(r.prompt) for r in reqs],
           "rows": {f"{order[rid]}:{i}": row
                    for (rid, i), row in rec["tokens"].items()},
           "blocks": rec["blocks"],
           "sched": {k: s[k] for k in SCHED_STATS},
           "kv_head_bytes": kv_head_bytes(eng.cache),
           "kv_cache_mib": s["kv_cache_mib"], "wall_s": s.get("wall_s"),
           "tok_s": s.get("tok_s"), "launches": read_launches(counters),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "weight_bytes": s["weight_bytes"], "moe_modes": s["moe_modes"],
           "shard_params": s["shard_params"],
           "missing": None if replay is None else replay.missing,
           **{k: s[k] for k in s if k.startswith("tp")}}
    if opts.get("rows"):
        PHASE19_DIR.mkdir(parents=True, exist_ok=True)
        if rec["emitted"]:
            path = PHASE19_DIR / f"{opts['rows']}.pt"
            torch.save({f"{order[rid]}:{i}": row
                        for (rid, i), row in rec["emitted"].items()}, path)
            res["rows_file"] = str(path)
        if cfg.moe is not None:
            rank = 0 if eng.group is None else eng.group.rank
            path = PHASE19_DIR / f"{opts['rows']}_route{rank}.pt"
            torch.save(route.state(), path)
            res["route_file"] = str(path)
    del eng, params, rec, route, replay
    free(torch)
    return res


def parting(a: dict, b: dict) -> dict:
    """Where two ``tp_serve`` runs part: the first token (request, index)
    that differs, the first emitted token whose logits row differs in any
    bit (in emission order: index, then request) and both runs' [digest,
    top-2 margin, top-1, top-2] there, and the first (step, block digest)
    that differs. All None: the runs agree bit for bit."""
    keys = sorted(set(a["rows"]) | set(b["rows"]),
                  key=lambda k: tuple(int(x) for x in k.split(":"))[::-1])
    bits = next((k for k in keys if a["rows"].get(k) is None
                 or b["rows"].get(k) is None
                 or a["rows"][k][0] != b["rows"][k][0]), None)
    block = next(((i, j) for i, (x, y) in enumerate(zip(a["blocks"],
                                                        b["blocks"]))
                  for j in range(max(len(x), len(y)))
                  if j >= len(x) or j >= len(y) or x[j] != y[j]), None)
    if block is None and len(a["blocks"]) != len(b["blocks"]):
        block = (min(len(a["blocks"]), len(b["blocks"])), 0)
    tok = first_difference(a["tokens"], b["tokens"])
    at = None if tok is None else f"{tok[0]}:{tok[1]}"
    return {"token": tok,
            "token_rows": None if at is None
            else [a["rows"].get(at), b["rows"].get(at)],
            "logits_bits": bits,
            "logits_rows": None if bits is None
            else [a["rows"].get(bits), b["rows"].get(bits)],
            "block": block}


def run_key(arch: str, opts: dict) -> str:
    """A run's key among a process's runs: the arch and its "tag" ("/shard"
    a sharded-weights run, "/flip" one with flipped embeddings, "/replay"
    tp = 1 replaying a mesh's MoE routing, "/control" 19b's control)."""
    return arch + opts.get("tag", "")


def tp_rank(rank, world, init_method, queue, cases=TP_RUNS) -> None:
    """One rank of phase 17's and 19's runs (a spawned process): with
    ``world`` > 1 it joins the group (gloo when the ranks share a card)
    and builds the ("data", "model") = (1, world) mesh; with 1 it serves
    alone (tp = 1). It serves every case of ``cases``, (arch, layers,
    max_new[, tp_serve's opts]), or runs phase 19d for the arch
    ``MOE_MESH``, and puts its results on ``queue``; raises on any
    failure."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.serving.graphs import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, backend = None, None
    cards = [(rank, torch.cuda.current_device(),
              torch.cuda.get_device_name())]
    if world > 1:
        backend = init_rank(rank, world, init_method, "cuda", TP_TIMEOUT_S)
        mesh = make_host_mesh(1, world, "cuda")
        cards = [None] * world
        dist.all_gather_object(cards, (rank, torch.cuda.current_device(),
                                       torch.cuda.get_device_name()))
    runs = {}
    for arch, layers, max_new, *opts in cases:
        opts = opts[0] if opts else {}
        if arch == MOE_MESH:
            runs[arch] = moe_mesh_check(torch, mesh)
        else:
            cfg, reqs, kw = tp_case(arch, layers, max_new)
            runs[run_key(arch, opts)] = tp_serve(torch, KERNELS, cfg, reqs,
                                                 kw, mesh, opts)
        if world > 1:
            dist.barrier()
    queue.put((rank, {"backend": backend, "cards": cards, "runs": runs}))
    if world > 1:
        dist.destroy_process_group()


def spawn_ranks(world: int, cases=TP_RUNS) -> dict:
    """Run ``tp_rank`` over ``cases`` on ``world`` spawned processes;
    {rank: result}. Fails unless every rank puts its result and exits 0
    in time."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="tp_")) / "rdzv")
    procs = [ctx.Process(target=tp_rank,
                         args=(r, world, init, results, cases))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
            except queue_mod.Empty:
                pass
            bad = [(i, p.exitcode) for i, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            check(not bad, f"phase 17/19: rank(s) failed: {bad} (rank, "
                  "exit code)")
            check(time.monotonic() - t0 < TP_TIMEOUT_S,
                  f"phase 17/19: the ranks did not finish in {TP_TIMEOUT_S} "
                  "s")
        for p in procs:
            p.join(60)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"phase 17/19: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    got["wall_s"] = time.monotonic() - t0
    return got


def first_difference(a: list, b: list):
    """(request, token index) of the first token where two runs' streams
    (in request order) part, or None."""
    for r, (x, y) in enumerate(zip(a, b)):
        for i in range(max(len(x), len(y))):
            if i >= len(x) or i >= len(y) or x[i] != y[i]:
                return r, i
    return None


def serve_tp(torch, counters, card, phases=("17", "19")) -> list:
    """Phases 17b-c and 19, in the same spawned processes: TP_WORLD
    spawned ranks over a mesh model=TP_WORLD (every rank on its own card
    with NCCL when there are enough, else all on cuda:0 over gloo), then
    the tp = 1 runs on one engine (eager) in a process of its own.
    Phase 17: TP_RUNS; both ranks' tokens, every emitted token's logits
    row (bit for bit) and scheduling stats equal the tp = 1 run's, each
    rank's kv-head cache bytes are 1 / TP_WORLD of tp = 1's; where a rank
    parts, the failure names the first token, logits row (with both top-2
    margins) and block digest that differ. Phase 19: SHARD_RUNS with
    ``shard_params=True`` against tp = 1 runs of the same weights (19b's
    is phase 17's glm4 run; a MoE model's, beside a plain run, tp = 1
    replaying the mesh's routing, and that replay again with flipped
    embeddings), 19b's control, and 19d (``check_shard``). Every rank's
    exit code and result is checked. Returns the runs (their launches are
    the spawned processes')."""
    free(torch)
    one_cases, world_cases = [], []
    if "17" in phases:
        for arch, layers, max_new in TP_RUNS:
            rows = "19" in phases and any(
                (arch, layers, max_new) == r[:3] for r in SHARD_RUNS)
            one_cases.append((arch, layers, max_new,
                              {"rows": f"{arch}_tp1"} if rows else {}))
            world_cases.append((arch, layers, max_new))
    if "19" in phases:
        for arch, layers, max_new, f2d in SHARD_RUNS:
            if not any(c[:3] == (arch, layers, max_new) for c in one_cases):
                one_cases.append((arch, layers, max_new,
                                  {"rows": f"{arch}_tp1", "f2d": f2d}))
            world_cases.append((arch, layers, max_new,
                                {"shard": True, "f2d": f2d, "tag": "/shard",
                                 "rows": f"{arch}_shard"}))
        # 19b's noise floor: tp = 1 with one-ulp flips in its embeddings;
        # its control: a sharded run with one layer's partial left out
        one_cases.append(("glm4_9b", 20, 32, {"rows": "glm4_9b_flip",
                                              "flip": True, "tag": "/flip"}))
        world_cases.append(("glm4_9b", 20, CONTROL_NEW,
                            {"shard": True, "control": True,
                             "tag": "/control", "rows": "glm4_9b_control"}))
        world_cases.append((MOE_MESH, None, None))
    got = spawn_ranks(TP_WORLD, world_cases)
    if "19" in phases:
        # tp = 1 replaying each MoE mesh run's routing, and again with
        # flipped embeddings (the floor)
        for arch, layers, max_new, f2d in SHARD_RUNS:
            if get_config_of(arch).moe is None:
                continue
            ranks = [got[r]["runs"][arch + "/shard"] for r in range(TP_WORLD)]
            PHASE19_DIR.mkdir(parents=True, exist_ok=True)
            path = PHASE19_DIR / f"{arch}_mesh_route.pt"
            torch.save(moe_replay_merge(ranks), path)
            for tag, flip in (("/replay", False), ("/replay_flip", True)):
                one_cases.append((arch, layers, max_new, {
                    "rows": arch + tag.replace("/", "_"), "f2d": f2d,
                    "replay": str(path), "flip": flip, "tag": tag}))
    one = spawn_ranks(1, one_cases)[0]["runs"]
    r0 = got[0]
    print(f"[tp] {card}: backend {r0['backend']}, ranks on cards "
          + ", ".join(f"rank {r} -> cuda:{d} ({n})" for r, d, n in r0["cards"])
          + f"; {TP_WORLD} ranks spawned, served and joined in "
          f"{got['wall_s']:.1f} s (phases {', '.join(phases)})", flush=True)
    runs = []
    for arch, layers, max_new in (TP_RUNS if "17" in phases else ()):
        base = one[arch]
        for rank in range(TP_WORLD):
            mine = got[rank]["runs"][arch]
            part = parting(base, mine)
            check(part["token"] is None and part["logits_bits"] is None,
                  f"phase 17 {arch}: rank {rank} parts from tp = 1: "
                  + json.dumps(part))
            check(mine["sched"] == base["sched"],
                  f"phase 17 {arch}: rank {rank}'s scheduling stats differ "
                  f"from tp = 1: {mine['sched']} vs {base['sched']}")
            check(mine["kv_head_bytes"] * TP_WORLD == base["kv_head_bytes"],
                  f"phase 17 {arch}: rank {rank} holds "
                  f"{mine['kv_head_bytes']} kv-head bytes, tp = 1 "
                  f"{base['kv_head_bytes']}")
        tp = got[0]["runs"][arch]
        depth = "full depth" if layers is None else f"{layers} layers"
        print(f"[tp] {card}: {arch} ({depth}, {max_new} new tokens a "
              f"request), mesh model={TP_WORLD}: tokens, "
              f"logits bits ({len(base['rows'])} emitted rows) and scheduling "
              f"stats of both ranks == tp = 1 ({base['sched']['tokens']} "
              f"tokens, {base['sched']['steps']} steps, "
              f"{base['sched']['cache_hit_tokens']} prefix-hit tokens); tok/s "
              f"{tp['tok_s']} (tp = 1 eager {base['tok_s']}); per-rank "
              f"kv-head cache {tp['kv_head_bytes'] / 2 ** 20:.1f} MiB (tp = 1 "
              f"{base['kv_head_bytes'] / 2 ** 20:.1f}); gathers "
              f"{tp['tp_gathers']} ({tp['tp_gather_bytes']} bytes), staged "
              f"copies {tp['tp_staged_copies']} ({tp['tp_staged_bytes']} "
              f"bytes); peak {tp['peak_mem_gib']:.2f} GiB a rank: "
              + json.dumps({k: v for k, v in tp.items()
                            if k not in ("tokens", "launches", "rows",
                                         "blocks", "routes")}),
              flush=True)
        runs += [base, tp]
    if "19" in phases:
        runs += check_shard(torch, card, one, got)
    # 19b's tp = 1 run is phase 17's: count its launches once
    return list({id(r): r for r in runs}.values())


def moe_mesh_check(torch, mesh) -> dict:
    """Phase 19d on this rank: qwen3_moe's MoE block at full width (layer
    0 of its seed-0 weights, whole on each rank) on the serving mesh,
    "ep_psum" on 8 decode rows and "ep_a2a" on a 512-row chunk (seeded
    bf16 inputs), against the plain one-process emulation of the same
    per-shard capacity on the card (``moe_local`` over the whole rows,
    and over each rank's slice of the sequence for "ep_a2a"): every row
    within TOL of its norm. Also the distance to one device's block
    (``moe_local`` over all rows: under "ep_a2a" other drops) and the
    call's host-clock ms."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import init_model
    from repro_torch.spmd import collectives
    cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b"), num_layers=1)
    p = init_model(cfg, 0, DEV)["layers"][0]["moe"]
    free(torch)
    sm = collectives.ServeMesh(mesh)
    tp = sm.model.size
    gen = torch.Generator(device=DEV)
    gen.manual_seed(19)
    out = {}
    for mode, (B, S) in (("ep_psum", (8, 1)), ("ep_a2a", (1, 512))):
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device=DEV).to(torch.bfloat16)
        with collectives.use(sm):
            moe.moe_block(p, x, cfg)                   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = moe.moe_block(p, x, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        n = tp if mode == "ep_a2a" else 1
        S_l = S // n
        emu = torch.cat([moe.moe_local(
            x[:, i * S_l:(i + 1) * S_l].reshape(B * S_l, -1), p, cfg).view(
                B, S_l, -1) for i in range(n)], dim=1)
        one = moe.moe_local(x.reshape(B * S, -1), p, cfg).view(B, S, -1)
        out[mode] = {"rows": B * S, "row_err": row_err(y, emu),
                     "max_abs_err": err(y, emu),
                     "one_device_row_err": row_err(y, one), "ms": ms}
    out["modes"] = dict(sm.moe_modes)
    del p
    free(torch)
    return out


def first_tokens(mine: dict, base: dict) -> list:
    """Each request's first token index where two runs part (the shorter
    stream's length where they do not)."""
    return [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
            for a, b in zip(mine["tokens"], base["tokens"])]


def explain_parting(base: dict, mine: dict, vocab: int) -> list:
    """Where ``mine`` parts from ``base``: for each request whose tokens
    differ or whose streams end apart, (request, token index, margin,
    gap, near-tie). The margin is how far the base's fp32 logits row put
    ``mine``'s token below its own there, the gap the largest |difference|
    of the two runs' rows there (the same context on both; ``rows_gap``
    holds it to the floor). A near-tie is a margin below TOL or within
    twice the gap: each score moved by at most the gap, and that swaps
    only tokens that close."""
    import torch
    ma = torch.load(mine["rows_file"])
    ba = torch.load(base["rows_file"])
    out = []
    for r, (a, b) in enumerate(zip(mine["tokens"], base["tokens"])):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            if len(a) != len(b):
                out.append((r, min(len(a), len(b)), None, None, False))
            continue
        row = ba[f"{r}:{i}"]
        margin = float(row[b[i]] - row[a[i]])
        gap = err(ma[f"{r}:{i}"][:vocab], row[:vocab])
        out.append((r, i, round(margin, 6), round(gap, 6),
                    margin < max(TOL, 2 * gap)))
    return out


def moe_replay_merge(ranks: list) -> dict:
    """The mesh ranks' routing records (``tp_serve``'s "route_file")
    joined into whole calls (``models.moe_replay.merge``)."""
    import torch
    from repro_torch.models import moe_replay
    return moe_replay.merge([torch.load(r["route_file"])["calls"]
                             for r in ranks])


def rows_gap(base: dict, mine: dict, vocab: int) -> dict:
    """How far the two runs' saved fp32 logits rows (their first
    ``vocab`` columns: the padding columns hold -1e30) of the tokens each
    request emitted up to its first differing one (the same context on
    both) are apart: the largest |difference| ("abs"), the largest
    ``row_err`` (|difference| over the base row's norm, "row"), and the
    number of rows ("rows")."""
    import torch
    a = torch.load(mine["rows_file"])
    b = torch.load(base["rows_file"])
    out = {"row": 0.0, "abs": 0.0, "rows": 0}
    for r, i in enumerate(first_tokens(mine, base)):
        for j in range(min(i + 1, len(mine["tokens"][r]),
                           len(base["tokens"][r]))):
            ra, rb = a[f"{r}:{j}"][:vocab], b[f"{r}:{j}"][:vocab]
            out["row"] = max(out["row"], row_err(ra[None], rb[None]))
            out["abs"] = max(out["abs"], err(ra, rb))
            out["rows"] += 1
    return out


def check_shard(torch, card, one: dict, got: dict) -> list:
    """Phase 19's checks and lines over the tp = 1 runs ``one`` and the
    ranks' results ``got``. 19a-c (SHARD_RUNS): rank 0's tokens equal the
    base's up to a near-tie (``explain_parting``), and its fp32 logits
    rows before each parting are within SHARD_FLOOR_FACTOR x the floor
    measured in the same run (``rows_gap``). The base of a dense model is
    tp = 1, its floor tp = 1 with flipped embeddings; that of a MoE model
    tp = 1 replaying the mesh's routing (``models.moe_replay``), its floor
    that replay with flipped embeddings, and then also: every call
    replayed, every keep mask the mesh's capacity rule's, the router
    log-probabilities of the rows both runs share within
    SHARD_FLOOR_FACTOR x the floor's, and each row that the replay's own
    router routes elsewhere within twice its gap of a tie. Every rank: the
    tokens rank 0's, the scheduling stats tp = 1's, weight bytes at most
    SHARD_WEIGHT_SHARE of tp = 1's, the paged kernels and the gather
    launched, the MoE modes expected. 19b's control lands past its gate.
    19d's rows within TOL. Returns the runs (tp = 1 and rank 0) for the
    launch sums."""
    from repro_torch.models import moe_replay
    runs = []
    expect = {"qwen3_moe_30b_a3b": {"ep_psum", "ep_a2a"},
              "grok1_314b": {"f2d"}, "glm4_9b": set()}
    gates = {}
    for tag, (arch, layers, max_new, f2d) in zip("abc", SHARD_RUNS):
        what = f"phase 19{tag} {arch}"
        cfg = get_config_of(arch)
        fails = []                # checked once the run's line is out

        def need(cond, msg):
            if not cond:
                fails.append(msg)

        plain = one[arch]
        ranks = [got[r]["runs"][arch + "/shard"] for r in range(TP_WORLD)]
        mine = ranks[0]
        if cfg.moe is not None:
            base, flip = one[arch + "/replay"], one[arch + "/replay_flip"]
            need(base["missing"] == 0 and flip["missing"] == 0,
                 f"the replays missed {base['missing']} and "
                 f"{flip['missing']} of the mesh's MoE calls")
            need(base["sched"] == plain["sched"],
                 "the replay's scheduling stats differ from tp = 1")
        else:
            base, flip = plain, one[arch + "/flip"]
        parted = explain_parting(base, mine, cfg.vocab_size)
        need(all(p[4] for p in parted),
             "partings that are no near-tie (request, token, margin, gap, "
             f"near-tie): {[p for p in parted if not p[4]]}")
        gap = rows_gap(base, mine, cfg.vocab_size)
        floor = rows_gap(base, flip, cfg.vocab_size)
        gates[arch] = (floor, SHARD_FLOOR_FACTOR * floor["abs"])
        need(gap["abs"] <= SHARD_FLOOR_FACTOR * floor["abs"],
              f"the sharded logits rows are {gap['abs']} from the "
              f"base's, past {SHARD_FLOOR_FACTOR} x the floor "
              f"{floor['abs']}")
        routing = ""
        if cfg.moe is not None:
            rep, rep_flip = (torch.load(r["route_file"]) for r in (base, flip))
            first, first_f = first_tokens(mine, base), first_tokens(flip, base)
            cmp = moe_replay.compare(
                torch.load(PHASE19_DIR / f"{arch}_mesh_route.pt"), rep,
                lambda q, p: p < base["prompts"][q] + first[q])
            rfloor = moe_replay.compare(
                moe_replay.merge([rep_flip["calls"]]), rep,
                lambda q, p: p < base["prompts"][q] + first_f[q])
            need(cmp["keep_diffs"] == 0,
                 f"{cmp['keep_diffs']} rows of the mesh's MoE calls keep "
                 "other assignments than its capacity rule")
            need(cmp["rows"] > 0 and cmp["logp_gap"]
                 <= SHARD_FLOOR_FACTOR * rfloor["logp_gap"],
                 f"the router log-probabilities of {cmp['rows']} rows are "
                 f"{cmp['logp_gap']} from the replay's, past "
                 f"{SHARD_FLOOR_FACTOR} x the floor {rfloor['logp_gap']}")
            bad = [t for t in cmp["rerouted"] if t["tie"] > 2 * t["gap"]]
            need(not bad, f"rows the mesh routed past a tie: {bad}")
            ties = sorted(cmp["rerouted"], key=lambda t: -t["tie"])
            routing = (
                f"; routing against the replay ({cmp['calls']} calls, "
                f"{cmp['rows']} shared rows x layers): rows whose keep mask "
                f"is not the capacity rule's {cmp['keep_diffs']}, router "
                f"log-probability gap {cmp['logp_gap']:.6f} (floor {rfloor['logp_gap']:.6f} over "
                f"{rfloor['rows']}), {len(ties)} rows routed elsewhere than "
                "the replay's own top k (tie over twice the gap: "
                f"{len(bad)}), the widest ties (request, position, layer, "
                "tie, gap): "
                + json.dumps([(t["request"], t["position"], t["layer"],
                               round(t["tie"], 6), round(t["gap"], 6))
                              for t in ties[:12]]))
        for r, res in enumerate(ranks):
            need(res["tokens"] == mine["tokens"],
                 f"rank {r}'s tokens differ from rank 0's")
            need(res["sched"] == plain["sched"],
                 f"rank {r}'s scheduling stats differ from tp = 1: "
                 f"{res['sched']} vs {plain['sched']}")
            share = res["weight_bytes"] / plain["weight_bytes"]
            need(res["shard_params"] and share <= SHARD_WEIGHT_SHARE,
                 f"rank {r} holds {share:.3f} of tp = 1's weight bytes "
                 f"(limit {SHARD_WEIGHT_SHARE})")
            for k in ("paged_attention", "paged_prefill_attention",
                      "gather"):
                need(res["launches"].get(k, 0) > 0,
                     f"rank {r} launched no {k}")
            need(set(res["moe_modes"]) == expect[arch]
                 and all(v > 0 for v in res["moe_modes"].values()),
                 f"rank {r}'s MoE modes {res['moe_modes']}, expected "
                 f"{expect[arch]}")
        brief_launch = [{k: res["launches"].get(k, 0) for k in
                         ("paged_attention", "paged_prefill_attention",
                          "gather")} for res in [plain] + ranks]
        label = "tp = 1" if cfg.moe is None else "the replay"
        apart = sum(x != y for x, y in zip(mine["tokens"], plain["tokens"]))
        print(f"[tp-shard] {card}: 19{tag} {arch} ({layers} of "
              f"{cfg.num_layers} layers, {max_new} new "
              f"tokens a request{', expert_ff_2d' if f2d else ''}), mesh "
              f"model={TP_WORLD}, shard_params=True: tok/s {mine['tok_s']} "
              f"(tp = 1 eager {plain['tok_s']}); weight bytes a rank "
              + " / ".join(str(res["weight_bytes"]) for res in ranks)
              + f" (tp = 1 {plain['weight_bytes']}, share "
              f"{mine['weight_bytes'] / plain['weight_bytes']:.4f}); peak "
              + " / ".join(f"{res['peak_mem_gib']:.2f}" for res in ranks)
              + f" GiB a rank (tp = 1 {plain['peak_mem_gib']:.2f}); MoE "
              f"modes {mine['moe_modes']}; collectives rank 0: gathers "
              f"{mine['tp_gathers']} ({mine['tp_gather_bytes']} bytes), "
              f"reduces {mine['tp_reduces']} ({mine['tp_reduce_bytes']} "
              f"bytes), all-to-alls {mine['tp_all_to_alls']}, staged copies "
              f"{mine['tp_staged_copies']} ({mine['tp_staged_bytes']} "
              f"bytes); launches, tp = 1 then by rank {brief_launch}; "
              f"{sum(len(t) for t in mine['tokens'])} tokens, "
              f"{len(parted)} of {len(mine['tokens'])} requests part from "
              f"{label} (request, token, how far {label}'s scores put the "
              "sharded token below its own, the rows' largest |difference| "
              f"there, a near-tie: below {TOL} or twice that): {parted}"
              + ("" if cfg.moe is None else
                 f" ({apart} part from the plain tp = 1 run, whose "
                 "routing is its own)")
              + f"; logits rows before each parting ({gap['rows']}): "
              f"largest |difference| {gap['abs']:.6f} ("
              f"{'within' if gap['abs'] <= TOL else 'not within'} {TOL}), "
              f"{gap['row']:.6f} of the row's norm; the floor, {label} "
              f"again with one-ulp flips in {FLIP_SHARE} of its embedding "
              f"outputs ({floor['rows']} rows): {floor['abs']:.6f}, "
              f"{floor['row']:.6f} of the norm; the gate "
              f"{SHARD_FLOOR_FACTOR} x the floor" + routing,
              flush=True)
        check(not fails, f"{what}: " + "; ".join(fails))
        runs += [plain, mine]
    ctrl = got[0]["runs"]["glm4_9b/control"]
    floor, gate = gates["glm4_9b"]
    cgap = rows_gap(one["glm4_9b"], ctrl, get_config_of("glm4_9b").vocab_size)
    check(cgap["abs"] > gate,
          f"phase 19b's control (rank 1's wo of layer {CONTROL_LAYER} "
          f"zeroed) is {cgap['abs']} from tp = 1, inside the gate {gate}")
    print(f"[tp-shard] {card}: 19b control, glm4_9b sharded with rank 1's "
          f"wo of layer {CONTROL_LAYER} zeroed ({CONTROL_NEW} new tokens a "
          f"request): logits rows before each parting ({cgap['rows']}) "
          f"{cgap['abs']:.6f} from tp = 1's, {cgap['row']:.6f} of the norm: "
          f"past the gate {gate:.6f} ({SHARD_FLOOR_FACTOR} x the floor "
          f"{floor['abs']:.6f})", flush=True)
    for r in range(TP_WORLD):
        res = got[r]["runs"][MOE_MESH]
        for mode in ("ep_psum", "ep_a2a"):
            check(res[mode]["row_err"] <= TOL,
                  f"phase 19d: rank {r}'s {mode} block is "
                  f"{res[mode]['row_err']} from the emulation (rows, limit "
                  f"{TOL})")
        check(res["modes"] == {"ep_psum": 2, "ep_a2a": 2},
              f"phase 19d: rank {r}'s modes {res['modes']}")
        print(f"[moe-mesh] {card}: 19d rank {r}: qwen3_moe's MoE block at "
              f"full width, model={TP_WORLD}, against the one-process "
              f"emulation of the same per-shard capacity: "
              + json.dumps({m: res[m] for m in ("ep_psum", "ep_a2a")}),
              flush=True)
    return runs


def get_config_of(arch: str):
    from repro_torch.config import get_config
    return get_config(arch)


# ---------------------------------------------------------------------------
# phase 18: multi-rank training on torch.distributed
# ---------------------------------------------------------------------------

# glm4_9b at full width and 4 of its 40 layers (two ranks' bf16 params,
# fp32 masters, AdamW slots and gradients share one card), a global batch
# of 4 x 2048 tokens from ShardedSource(seed=0), remat full, AdamW; 18a
# runs one step more (the reference of 18d's step after the restore)
MESH_LAYERS, MESH_STEPS, MESH_B, MESH_S = 4, 3, 4, 2048
MESH_TIMEOUT_S = 420      # each world's join limit and its groups' timeout
# the tolerance of a loss (absolute) or grad norm (relative) gap to 18a:
# this many times the larger floor measured in the same run at the same
# configuration, each the largest gap over the four steps 18b-d hold: 18a
# again (it must give the same bits), and 18a with one-bf16-ulp flips in
# FLIP_SHARE of its embedding outputs (phase 8's noise floor: bf16
# rounding of any kind, amplified over the steps; the fourth step's loss
# rises and amplifies it most). The card against the CPU at phase 8's
# smoke setup is printed beside them and gates nothing (another
# configuration). A control must fail the gate: 18a on rows [0, 1, 0, 1]
# of each batch, which is what data=2 computes when both data ranks train
# on the same half of the batch.
MESH_TOL_FACTOR = 4
MESH_CKPT = ROOT / "build" / "phase18_ckpt"
MESH_BACKEND = "gloo, staged through pinned host memory"


def mesh_setup(smoke=False):
    """(cfg, pcfg, ocfg, host batches) of phase 18; ``smoke``: glm4's
    smoke widths at the same depth."""
    import dataclasses
    from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
    from repro_torch.data.pipeline import ShardedSource
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=smoke),
                              num_layers=MESH_LAYERS)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    src = ShardedSource(cfg, MESH_S, seed=0)
    batches = [src.batch(i, MESH_B) for i in range(MESH_STEPS + 1)]
    return cfg, ParallelConfig(remat="full"), ocfg, batches


def leaf_digest(torch, x) -> int:
    """``digest`` of a whole tensor's bits, taken 2^24 values at a time
    (an int64 copy of a 620M-value table would not fit beside the run)."""
    flat = x.detach().reshape(-1)
    n = 1 << 24
    return sum(int(digest(torch, flat[i:i + n])) * (i // n + 1)
               for i in range(0, flat.numel(), n))


def mesh_train(torch, cfg, pcfg, ocfg, batches, mesh=None, device=None,
               digests="all"):
    """Train from the seeded init on ``batches`` (global, host) on one
    device or this rank of ``mesh``: per step the loss, grad norm, wall
    ms and staged collective bytes, and the working params' digests
    ("all", "replicated": those no rank shards, or None). Returns (result,
    params, state)."""
    from repro_torch.launch.train import build_state
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.serving.graphs import KERNELS
    from repro_torch.spmd import collectives
    from repro_torch.spmd import steps as tsteps

    dev = device or DEV
    params, state = build_state(cfg, ocfg, dev, 0, mesh, pcfg)
    step = tsteps.make_train_step(cfg, pcfg, ocfg, mesh)
    tm = collectives.train_mesh(mesh) if mesh is not None else None
    keep = None
    if digests == "replicated":
        keep = [all(e is None for e in lay.spec) for lay in tree_leaves(
            tsteps.param_layouts(cfg, pcfg, mesh))]
    out = {"loss": [], "grad_norm": [], "ms": [], "staged_bytes": [],
           "digests": []}
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    for i, b in enumerate(batches):
        staged = tm.stats["staged_bytes"] if tm else 0
        t0 = time.monotonic()
        params, state, m = step(params, state, i, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        if dev == "cuda":
            torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.monotonic() - t0))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["staged_bytes"].append((tm.stats["staged_bytes"] - staged)
                                   if tm else 0)
        if digests:
            out["digests"].append([
                leaf_digest(torch, p) if keep is None or keep[j] else None
                for j, p in enumerate(tree_leaves(params))])
        if i + 1 == MESH_STEPS:
            out["launches"] = read_launches(KERNELS)
    if dev == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out, params, state


def gaps(run, ref, steps=None) -> dict:
    """Largest per-step |loss gap| and relative grad-norm gap to ``ref``
    over the first ``steps`` steps (default all of ``run``'s)."""
    n = steps or len(run["loss"])
    return {"loss": max(abs(a - b) for a, b in
                        zip(run["loss"][:n], ref["loss"][:n])),
            "grad_norm": max(abs(a - b) / b for a, b in
                             zip(run["grad_norm"][:n],
                                 ref["grad_norm"][:n]))}


def mesh_reference(torch) -> dict:
    """Phase 18a, in a process of its own: tp = dp = 1 (each step's loss,
    grad norm and every working param's digest); again (it must give the
    same bits) and with flipped embedding bits, every step 18b-d hold
    (the floors); the control on half of each batch; and the card against
    the CPU at phase 8's smoke setup (printed only). Returns the first
    run, the floors, the control's gaps and the smoke reading."""
    import dataclasses

    import numpy as np
    from repro_torch.config import OptimizerConfig
    from repro_torch.data.pipeline import ShardedSource
    cfg, pcfg, ocfg, batches = mesh_setup()

    def run(bs, **kw):
        out = mesh_train(torch, cfg, pcfg, ocfg, bs, **kw)[0]
        free(torch)
        return out

    ref = run(batches)
    again = run(batches)
    floors = {"repeat": gaps(again, ref),
              "repeat_same_bits": again["digests"] == ref["digests"]
              and again["loss"] == ref["loss"]}
    with flipped_embedding(torch, 0):
        floors["flip"] = gaps(run(batches, digests=None), ref)
    n = MESH_STEPS
    half = [{k: np.concatenate([v[:MESH_B // 2]] * 2) for k, v in b.items()}
            for b in batches[:n]]
    control = gaps(run(half, digests=None), ref, n)
    scfg, spcfg, _, _ = mesh_setup(smoke=True)
    spcfg = dataclasses.replace(spcfg, microbatches=2)
    sgd = OptimizerConfig(name="sgd", lr=0.1, warmup_steps=0,
                          schedule="constant")
    sb = [ShardedSource(scfg, 32, seed=0).batch(i, 4) for i in range(3)]
    card = mesh_train(torch, scfg, spcfg, sgd, sb, digests=None)[0]
    cpu = mesh_train(torch, scfg, spcfg, sgd, sb, device="cpu",
                     digests=None)[0]
    return {"ref": ref, "floors": floors, "control": control,
            "card_vs_cpu_smoke": gaps(card, cpu)}


def mesh_data2(torch, mesh) -> dict:
    """Phase 18b on this rank: data=2 with ZeRO-1; then ``save_global``
    of the state after the last step (rank 0 writes it)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import save_global
    from repro_torch.spmd import steps as tsteps
    cfg, pcfg, ocfg, batches = mesh_setup()
    run, params, state = mesh_train(torch, cfg, pcfg, ocfg,
                                    batches[:MESH_STEPS], mesh)
    lead = dist.get_rank() == 0
    mgr = CheckpointManager(MESH_CKPT, keep=1) if lead else None
    t0 = time.monotonic()
    save_global(mgr, MESH_STEPS, {"params": params, "opt": state},
                mesh=mesh, layouts=tsteps.train_layouts(cfg, pcfg, ocfg,
                                                        mesh))
    run["gather_s"] = time.monotonic() - t0
    if lead:
        mgr.wait()
    dist.barrier()
    run["save_s"] = time.monotonic() - t0
    if lead:
        run["ckpt_bytes"] = sum(f.stat().st_size
                                for f in MESH_CKPT.rglob("*.npy"))
    return run


def mesh_model2(torch, mesh) -> dict:
    """Phases 18c-d on this rank: model=2 from the seeded init; then the
    18b checkpoint through ``restore_for_mesh`` (every shard on the card
    against its slice of the leaf in the file, bit for bit) and one more
    step."""
    import numpy as np
    from repro_torch.checkpoint.checkpoint import CheckpointManager, _tensor
    from repro_torch.checkpoint.elastic import restore_for_mesh
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.serving.graphs import KERNELS
    from repro_torch.spmd import collectives
    from repro_torch.spmd import steps as tsteps
    cfg, pcfg, ocfg, batches = mesh_setup()
    run, params, state = mesh_train(torch, cfg, pcfg, ocfg,
                                    batches[:MESH_STEPS], mesh,
                                    digests="replicated")
    # the state's structure (``restore`` reads no leaf of it)
    spec = tree_map(lambda _: 0, {"params": params, "opt": state})
    lay = tsteps.train_layouts(cfg, pcfg, ocfg, mesh)
    mgr = CheckpointManager(MESH_CKPT, keep=1)
    del params, state
    free(torch)
    t0 = time.monotonic()
    step_no, got = restore_for_mesh(mgr, spec, mesh, lay, DEV)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    del spec
    tm = collectives.train_mesh(mesh)
    manifest = json.loads((MESH_CKPT / f"step_{step_no:08d}" /
                           "manifest.json").read_text())["leaves"]
    names = leaf_paths(got)
    bad = []
    for name, shard, la in zip(names, tree_leaves(got), tree_leaves(lay)):
        meta = manifest[name.lstrip("/")]
        whole = _tensor(np.load(MESH_CKPT / f"step_{step_no:08d}" /
                                meta["file"], mmap_mode="c"), meta["dtype"])
        want = la.cut(whole, tm.coords, tm.shape).contiguous()
        if not torch.equal(shard.cpu().view(torch.uint8).reshape(-1),
                           want.view(torch.uint8).reshape(-1)):
            bad.append(name)
        del whole, want
    params = tree_map(lambda p: p.requires_grad_(), got["params"])
    state = got["opt"]
    step = tsteps.make_train_step(cfg, pcfg, ocfg, mesh)
    reset_launches(KERNELS)
    b = batches[MESH_STEPS]
    _, _, m = step(params, state, step_no, {
        k: torch.from_numpy(v).to(DEV) for k, v in b.items()})
    run["restore"] = {"step": step_no, "leaves": len(names),
                      "unequal_shards": bad, "restore_s": restore_s,
                      "loss": float(m["loss"]),
                      "launches": read_launches(KERNELS)}
    return run


MESH_JOBS = {"18a": ((1, 1), mesh_reference), "18b": ((2, 1), mesh_data2),
             "18c": ((1, 2), mesh_model2)}


def mesh_rank(rank, job, init_method, queue) -> None:
    """One process of a phase-18 world (spawned): joins the group (gloo:
    the ranks share the card) and builds the mesh, unless the world is
    one process; runs ``job`` and puts (rank, result) on ``queue``, or
    (rank, {"error": where and the traceback}) on any failure (a
    collective past its timeout included)."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape, fn = MESH_JOBS[job]
    world = shape[0] * shape[1]
    try:
        if world == 1:
            res = fn(torch)
        else:
            from repro_torch.launch.mesh import init_rank, make_host_mesh
            from repro_torch.spmd import collectives
            backend = init_rank(rank, world, init_method, DEV,
                                MESH_TIMEOUT_S)
            mesh = make_host_mesh(*shape, DEV)
            res = fn(torch, mesh)
            res["backend"] = backend
            res["collectives"] = collectives.train_mesh(mesh).stats
        queue.put((rank, res))
        if world > 1:
            torch.distributed.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": f"phase {job}, rank {rank} of {world}: "
                                   + traceback.format_exc()}))
        raise


def spawn_mesh(job) -> list:
    """Run phase-18 ``job`` in its own spawned world; every rank's result
    in rank order. Fails naming the rank and phase if one fails, exits
    non-zero or is still running after MESH_TIMEOUT_S."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    shape, _ = MESH_JOBS[job]
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="mesh_")) / "rdzv")
    procs = [ctx.Process(target=mesh_rank, args=(r, job, init, results))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, res = results.get(timeout=5)
                check("error" not in res, res.get("error", ""))
                got[rank] = res
            except queue_mod.Empty:
                pass
            bad = [(i, p.exitcode) for i, p in enumerate(procs)
                   if p.exitcode not in (None, 0) and i not in got]
            check(not bad, f"phase {job}: rank(s) failed without a "
                  f"result: {bad} (rank, exit code)")
            late = [i for i in range(world) if i not in got]
            check(time.monotonic() - t0 < MESH_TIMEOUT_S,
                  f"phase {job}: rank(s) {late} still running after "
                  f"{MESH_TIMEOUT_S} s")
        for p in procs:
            p.join(60)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"phase {job}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for r in got:
        got[r]["wall_s"] = time.monotonic() - t0
    return [got[r] for r in range(world)]


def mesh_line(card, tag, run, rank_runs) -> str:
    later = run["ms"][1:] or run["ms"]
    ms = sum(later) / len(later)
    staged = run["staged_bytes"][1:] or run["staged_bytes"]
    return (f"[train-mesh] {card}: {tag}: {ms:.1f} ms a step over steps "
            f"2-{len(run['ms'])} ({MESH_BACKEND}), "
            f"{MESH_B * MESH_S / ms * 1e3:.0f} tok/s, staged collective "
            f"bytes a step {sum(staged) / len(staged):.0f}, peak memory a "
            "rank " + ", ".join(f"{r.get('peak_mem_gib', float('nan')):.2f}"
                          for r in rank_runs)
            + " GiB")


def train_mesh(torch, card) -> list:
    """Phase 18: glm4_9b at full width and MESH_LAYERS layers, each mesh
    in spawned processes on the one card (two ranks share it over gloo:
    NCCL refuses two ranks on one GPU).

    18a, tp = dp = 1 (``mesh_reference``): the reference, the floors, and
    a control that must land outside the tolerance.
    18b, data=2 with ZeRO-1: each step's loss and grad norm within the
    tolerance of 18a's; both ranks' working params the same bits after
    every step. 18c, model=2: each step's loss and grad norm within the
    tolerance; the leaves no rank shards (the norms) the same bits on
    both ranks; per rank the flash kernel launched 2 x layers x steps
    times (forward and remat recompute) and the gather ``steps`` times.
    18d: 18b's ``save_global`` restored at model=2 by
    ``restore_for_mesh``, every shard its leaf's slice bit for bit, then
    one more step, its loss within the tolerance of 18a's fourth. The
    tolerance is MESH_TOL_FACTOR times the larger of 18a's floors.
    Returns the runs (their launches)."""
    import shutil
    free(torch)
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    a = spawn_mesh("18a")[0]
    ref, floors, control = a["ref"], a["floors"], a["control"]
    check(floors["repeat_same_bits"], "phase 18a: a second tp = dp = 1 run "
          f"gave other bits: {floors['repeat']}")
    floor = {k: max(floors[f][k] for f in ("repeat", "flip"))
             for k in ("loss", "grad_norm")}
    tol = {k: MESH_TOL_FACTOR * v for k, v in floor.items()}
    check(any(control[k] > tol[k] for k in tol), "phase 18a: the control "
          f"(both data ranks on the same half of the batch) lands within "
          f"the tolerance {json.dumps(tol)}: gaps {json.dumps(control)}")
    print(f"[time] phase 18a done in {a['wall_s']:.1f} s", flush=True)
    print(f"[train-mesh] {card}: 18a glm4_9b full width, {MESH_LAYERS} "
          f"layers, global batch {MESH_B} x {MESH_S}, remat full, AdamW: "
          f"losses {ref['loss']}, grad norms {ref['grad_norm']}; a second "
          f"run the same bits; floors {json.dumps(floors)}; tolerance "
          f"{MESH_TOL_FACTOR} x the largest: {json.dumps(tol)}; the "
          f"control (rows [0, 1, 0, 1]) fails it: {json.dumps(control)}; "
          "card vs CPU at phase 8's smoke setup (gates nothing): "
          f"{json.dumps(a['card_vs_cpu_smoke'])}; "
          + mesh_line(card, "tp = dp = 1", ref, [ref]), flush=True)
    runs = [dict(launches=ref["launches"])]
    n = 2 * MESH_LAYERS * MESH_STEPS
    for job, what in (("18b", "data=2, ZeRO-1"), ("18c", "model=2")):
        ranks = spawn_mesh(job)
        for r, run in enumerate(ranks):
            g = gaps(run, ref, MESH_STEPS)
            for k in ("loss", "grad_norm"):
                check(g[k] <= tol[k], f"phase {job} ({what}) rank {r}: "
                      f"{k} gap {g[k]} to 18a above {tol[k]} (floor "
                      f"{floor[k]} x {MESH_TOL_FACTOR}): {run[k]} vs "
                      f"{ref[k][:MESH_STEPS]}")
            check(run["loss"] == ranks[0]["loss"], f"phase {job}: rank {r}'s"
                  f" losses {run['loss']} differ from rank 0's")
            check(run["digests"] == ranks[0]["digests"], f"phase {job} "
                  f"({what}): rank {r}'s "
                  + ("working params" if job == "18b" else "replicated "
                     "leaves") + " differ in bits from rank 0's")
            got = run["launches"]
            fl, ga = got.get("flash_attention"), got.get("gather")
            check(fl == n and ga == MESH_STEPS, f"phase {job} rank {r}: "
                  f"flash {fl} (want {n}), gather {ga} (want {MESH_STEPS}) "
                  "launches")
            runs.append(dict(launches=got))
        print(mesh_line(card, f"{job} {what}, {ranks[0]['backend']}",
                        ranks[0], ranks) +
              f"; loss gaps to 18a {gaps(ranks[0], ref, MESH_STEPS)} within "
              f"{json.dumps(tol)}; both ranks the same "
              + ("working params' bits after every step" if job == "18b"
                 else "replicated leaves' bits (norms)")
              + f"; launches a rank {ranks[0]['launches']}; losses "
              f"{ranks[0]['loss']}; collectives {ranks[0]['collectives']}; "
              f"world {ranks[0]['wall_s']:.1f} s", flush=True)
        print(f"[time] phase {job} done in {ranks[0]['wall_s']:.1f} s",
              flush=True)
        if job == "18b":
            print(f"[train-mesh] {card}: 18b save_global: "
                  f"{ranks[0]['ckpt_bytes']} bytes in "
                  f"{ranks[0]['save_s']:.1f} s (gathered to rank 0's host "
                  f"in {ranks[0]['gather_s']:.1f} s, then written)",
                  flush=True)
        else:
            for r, run in enumerate(ranks):
                rs = run["restore"]
                check(rs["step"] == MESH_STEPS and not rs["unequal_shards"],
                      f"phase 18d rank {r}: restored step {rs['step']}, "
                      f"shards unequal to their slices: "
                      f"{rs['unequal_shards']}")
                gap = abs(rs["loss"] - ref["loss"][MESH_STEPS])
                check(gap <= tol["loss"], f"phase 18d rank {r}: the step "
                      f"after the restore, loss {rs['loss']} vs 18a's "
                      f"{ref['loss'][MESH_STEPS]} (gap {gap} above "
                      f"{tol['loss']})")
                runs.append(dict(launches=rs["launches"]))
            rs = ranks[0]["restore"]
            print(f"[train-mesh] {card}: 18d restore_for_mesh of 18b's "
                  f"checkpoint at model=2: {rs['leaves']} leaves a rank, "
                  f"every shard its slice bit for bit, in "
                  f"{rs['restore_s']:.1f} s; one more step: loss "
                  f"{rs['loss']} (18a {ref['loss'][MESH_STEPS]})",
                  flush=True)
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    return runs


def build_report(log: str) -> None:
    """ptxas' registers and spills per kernel, and every warning or C75xx
    note, as [build] lines. Fails if ptxas serialized sampled_softmax.cu's
    wgmma pipeline (WGMMA_SERIALIZED)."""
    src = fn = ""            # the source and entry function ptxas reports on
    for line in log.splitlines():
        if line.startswith("=="):
            src = line.strip("= ")
            print(f"[build] {line.strip()}")
        elif "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            print(f"[build] {fn}: {line.strip()}")
        elif "warning" in line or re.search(r"C75\d\d", line):
            print(f"[build] {src}: {line.strip()}")
            check(src != "sampled_softmax.cu" or not any(
                c in line for c in WGMMA_SERIALIZED),
                f"ptxas serialized {src}'s wgmma pipeline: {line.strip()}")


def lap(t0, phase):
    print(f"[time] phase {phase} done at {time.monotonic() - t0:.1f} s "
          "(since the build started)", flush=True)


def earlier_phases(torch, card, t0) -> tuple[dict, list]:
    """Phases 2-16 of the whole run, in order, in this process: the
    kernel rows and every run (their launches). ``tools/tp_repeat.py
    --history`` runs them too, before its repeats."""
    from repro_torch.serving.graphs import KERNELS
    timer = Timer(torch)
    rows = check_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()
    lap(t0, 2)
    counters = KERNELS            # every kernel wrapper and its counter
    res, params = serve_full(torch, counters, card)
    runs = [res] + serve_packed(torch, counters, card, params)
    lap(t0, "3-4")
    sampling_runs, verify_launches = serve_sampling(torch, counters, card,
                                                    params)
    runs += sampling_runs
    rows["paged_prefill_attention"].update(verify_launches)
    lap(t0, 9)
    runs += serve_tiers(torch, counters, card, params)
    lap(t0, 11)
    del params
    torch.cuda.empty_cache()
    runs += serve_ssm(torch, counters, card)
    card_vs_cpu(torch)
    lap(t0, "5-6, 14")
    runs.append(train_full(torch, counters, card))
    # phase 8's smoke models launch the flash kernel's mma route (hd 8, 12,
    # 16), which no full-width path runs
    runs += list(train_card_vs_cpu(torch).values())
    lap(t0, "7-8")
    runs += serve_family(torch, counters, card, rows)
    lap(t0, 10)
    runs += serve_slice(torch, counters, card, rows)
    lap(t0, 12)
    runs += train_families(torch, counters, card)
    lap(t0, "13, 15")
    runs.append(core_phase(torch, counters, card, rows,
                           gather_checked=True))
    lap(t0, 16)
    timer = Timer(torch)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(17)
    runs.append(check_partials(torch, timer, gen, rows, counters))
    del timer
    free(torch)
    return rows, runs


def main() -> int:
    # a hang anywhere (a driver thread, a capture) prints every thread's
    # stack and ends the run before its time limit
    dev_run = sys.argv[1:2] == ["--phase"]
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch (run it from "
              "the repo)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.serving.graphs import KERNELS

    # decode_logits must be a true fp32 product on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.monotonic() - t0:.1f}s "
          f"({build.build_dir()})", flush=True)
    log = build.build_dir() / "build.log"
    if log.exists():
        build_report(log.read_text())

    phases = sys.argv[2].split(",") if dev_run else []
    if phases and set(phases) <= {"12", "2g", "2h", "8", "13", "14", "16",
                                  "17", "17a", "18", "19"}:
        # a development run: some phases alone, in the order given (14:
        # phase 5's 512-token runs, each followed by phase 14; "13 ARCH
        # ..." some of its models); no summary and no result line
        for phase in phases:
            rows = {}
            if phase in ("2g", "2h"):
                timer = Timer(torch)
                gen = torch.Generator(device=DEV)
                gen.manual_seed(0)
                rows = {k: {} for k in ("paged_attention",
                                        "paged_prefill_attention",
                                        "ragged_paged_prefill_attention",
                                        "flash_attention", "gather", "ssd")}
                (check_slice if phase == "2g" else check_hd80)(
                    torch, timer, gen, rows)
                del timer
                print(f"[kernels] phase {phase}: {json.dumps(rows)}")
            elif phase == "12":
                serve_slice(torch, KERNELS, card, rows)
            elif phase == "8":
                train_card_vs_cpu(torch)
            elif phase == "16":
                rows = {"gather": {}}
                core_phase(torch, KERNELS, card, rows)
                print(f"[kernels] phase 16: {json.dumps(rows)}")
            elif phase in ("17", "17a"):
                timer = Timer(torch)
                gen = torch.Generator(device=DEV)
                gen.manual_seed(17)
                check_partials(torch, timer, gen, rows, KERNELS)
                del timer
                free(torch)
                if phase == "17":
                    serve_tp(torch, KERNELS, card, phases=("17",))
                print(f"[kernels] phase {phase}: {json.dumps(rows)}")
            elif phase == "19":
                serve_tp(torch, KERNELS, card, phases=("19",))
            elif phase == "13":
                train_families(torch, KERNELS, card, sys.argv[3:] or None)
            elif phase == "18":
                train_mesh(torch, card)
            else:
                serve_ssm(torch, KERNELS, card, runs=tuple(
                    r for r in SSM_RUNS if r[1] == "512"))
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[phase {phase}] passed at {time.monotonic() - t0:.1f} s "
                  "(a partial run: no result line)", flush=True)
        return 0
    if dev_run and sys.argv[2].startswith("11"):
        # a development run: phase 11 (or its parts "11bd", ...) alone, on
        # fresh phase-3 weights; no summary and no result line
        from repro_torch.config import get_config
        from repro_torch.models.api import init_model
        serve_tiers(torch, KERNELS, card,
                    init_model(get_config("glm4_9b"), 0, DEV),
                    sys.argv[2][2:] or "abcd")
        print("[phase 11] passed (a partial run: no result line)")
        return 0
    rows, runs = earlier_phases(torch, card, t0)
    runs += serve_tp(torch, KERNELS, card)
    lap(t0, "17, 19")
    runs += train_mesh(torch, card)
    lap(t0, 18)

    launches = {name: sum(r["launches"].get(name, 0) for r in runs)
                for name in rows}
    for name, n in launches.items():
        # sampled_softmax_loss is on no model path, in this package or in
        # the JAX package (the models' sampled softmax is plain tensor
        # code): phase 2e launches it and holds it against its plain version
        if name != "sampled_softmax_loss":
            check(n > 0, f"kernel {name} never launched on a serving or "
                  "training path")
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=REPLACES[r["kernel"]], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{k: v for k, v in r.items() if k in SUMMARY_EXTRAS
                       or k.startswith(("no_write", "device_ms", "hd80_",
                                        "lse_", "draws",
                                        "zamba2_", "mamba2_", "verify_",
                                        "core_",
                                        "plain_device_ms",
                                        "library_device_ms")
                                       + tuple(f"{m}_" for m in
                                               (*FAMILY, *SLICE)))})
               for name, r in rows.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
